"""static.nn layer builders, the part the static flow uses (counterpart of
``paddle_tpu/static/nn.py``: ``fc``, ``conv2d``, ``batch_norm``,
``pool2d``).  Each call makes the dygraph layer and calls it, so its
parameters join the default program while it builds.  The other builders
and static control flow (``cond``, ``while_loop``, ...) are not ported
(ROADMAP Queue 1 item 4)."""
from __future__ import annotations

from .. import nn as _nn
from ..nn import functional as F
from ..tensor.manipulation import reshape


def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    """A fully connected layer over ``x`` flattened after its first
    ``num_flatten_dims`` dims; a list of inputs each gets its own weight
    and their products are summed before the bias and activation."""
    if isinstance(x, (list, tuple)):
        def _wa(i):
            return (weight_attr[i] if isinstance(weight_attr, (list, tuple))
                    else weight_attr)
        outs = [fc(xi, size, num_flatten_dims, _wa(i),
                   False if i else bias_attr, None, name)
                for i, xi in enumerate(x)]
        out = outs[0]
        for o in outs[1:]:
            out = out + o
        return getattr(F, activation)(out) if activation else out
    in_features = 1
    for s in x.shape[num_flatten_dims:]:
        in_features *= s
    # the leading dims stay symbolic (reshape's 0): the build's
    # placeholder batch must not be baked into the replay
    flat = (reshape(x, [0] * num_flatten_dims + [-1])
            if num_flatten_dims != 1 or len(x.shape) > 2 else x)
    out = _nn.Linear(in_features, size, weight_attr, bias_attr)(flat)
    return getattr(F, activation)(out) if activation else out


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None,
           data_format="NCHW", name=None):
    in_ch = input.shape[1 if data_format.startswith("NC") else -1]
    out = _nn.Conv2D(in_ch, num_filters, filter_size, stride, padding,
                     dilation, groups, weight_attr=param_attr,
                     bias_attr=bias_attr, data_format=data_format)(input)
    return getattr(F, act)(out) if act else out


def batch_norm(input, act=None, momentum=0.9, epsilon=1e-5, param_attr=None,
               bias_attr=None, data_layout="NCHW", is_test=False, name=None,
               **kwargs):
    ch = input.shape[1 if data_layout.startswith("NC") else -1]
    layer = _nn.BatchNorm(ch, act=act, momentum=momentum, epsilon=epsilon,
                          param_attr=param_attr, bias_attr=bias_attr,
                          data_layout=data_layout)
    if is_test:
        layer.eval()
    return layer(input)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, ceil_mode=False,
           data_format="NCHW", **kwargs):
    if global_pooling:
        return (F.adaptive_max_pool2d(input, 1) if pool_type == "max"
                else F.adaptive_avg_pool2d(input, 1))
    if pool_type == "max":
        return F.max_pool2d(input, pool_size, pool_stride, pool_padding,
                            ceil_mode=ceil_mode, data_format=data_format)
    return F.avg_pool2d(input, pool_size, pool_stride, pool_padding,
                        ceil_mode=ceil_mode, data_format=data_format)
