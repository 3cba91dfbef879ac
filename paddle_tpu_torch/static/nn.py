"""static.nn layer builders (counterpart of ``paddle_tpu/static/nn.py``).
Each call makes the dygraph layer and calls it, so its parameters join
the default program while it builds.  Every builder whose eager layer the
port has is here, with the control flow and ``py_func``; the builders
whose layers are still to port raise, naming the ROADMAP item that brings
them (:data:`NOT_PORTED`)."""
from __future__ import annotations

from .. import nn as _nn
from ..nn import functional as F
from ..tensor.manipulation import reshape
from .control_flow import case, cond, switch_case, while_loop  # noqa: F401
from .misc import py_func  # noqa: F401


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


def _act(out, act):
    return getattr(F, act)(out) if act else out


def embedding(input, size, is_sparse=False, padding_idx=None,
              param_attr=None, dtype="float32"):
    return _nn.Embedding(size[0], size[1], padding_idx=padding_idx,
                         sparse=is_sparse, weight_attr=param_attr)(input)


def sparse_embedding(input, size, padding_idx=None, param_attr=None,
                     is_test=False, entry=None, dtype="float32"):
    """The reference's parameter-server embedding; a dense embedding
    here, as in the reference."""
    return embedding(input, size, is_sparse=True, padding_idx=padding_idx,
                     param_attr=param_attr, dtype=dtype)


def dropout(x, dropout_prob=0.5, is_test=False, **kwargs):
    """Dropout; in a static program each replay draws a fresh mask."""
    return F.dropout(x, dropout_prob, training=not is_test)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    layer = _nn.LayerNorm(input.shape[begin_norm_axis:], epsilon,
                          param_attr if scale else False,
                          bias_attr if shift else False)
    return _act(layer(input), act)


def conv2d_transpose(input, num_filters, filter_size=None, output_size=None,
                     stride=1, padding=0, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, act=None,
                     data_format="NCHW", name=None):
    in_ch = input.shape[1 if data_format.startswith("NC") else -1]
    layer = _nn.Conv2DTranspose(in_ch, num_filters, filter_size or 4,
                                stride, padding, dilation=dilation,
                                groups=groups, weight_attr=param_attr,
                                bias_attr=bias_attr, data_format=data_format)
    out = (layer(input, output_size=output_size) if output_size is not None
           else layer(input))
    return _act(out, act)


def conv3d(input, num_filters, filter_size, stride=1, padding=0,
           dilation=1, groups=1, param_attr=None, bias_attr=None,
           act=None, data_format="NCDHW", name=None):
    in_ch = input.shape[1 if data_format.startswith("NC") else -1]
    out = _nn.Conv3D(in_ch, num_filters, filter_size, stride, padding,
                     dilation, groups, weight_attr=param_attr,
                     bias_attr=bias_attr, data_format=data_format)(input)
    return _act(out, act)


def conv3d_transpose(input, num_filters, filter_size=None, output_size=None,
                     stride=1, padding=0, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, act=None, name=None):
    layer = _nn.Conv3DTranspose(input.shape[1], num_filters,
                                filter_size or 1, stride=stride,
                                padding=padding, dilation=dilation,
                                groups=groups, weight_attr=param_attr,
                                bias_attr=bias_attr)
    out = (layer(input, output_size=output_size) if output_size is not None
           else layer(input))
    return _act(out, act)


def prelu(x, mode="all", param_attr=None, name=None):
    num = 1 if mode == "all" else x.shape[1]
    return _nn.PReLU(num_parameters=num, weight_attr=param_attr)(x)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A standalone parameter on the default place (``attr``'s
    initializer, else ``default_initializer``, else zeros for a bias and
    XavierUniform for a weight)."""
    p = _nn.Layer().create_parameter([int(s) for s in shape], attr, dtype,
                                     is_bias, default_initializer)
    if name and not (attr is not None and getattr(attr, "name", None)):
        p.name = name
    return p


# builders whose eager layer or op is still to port, and the ROADMAP item
# (Queue 1) that brings it
NOT_PORTED = {
    "group_norm": "item 4, the other nn layers (GroupNorm)",
    "instance_norm": "item 4, the other nn layers (InstanceNorm2D)",
    "spectral_norm": "item 4, the other nn layers (SpectralNorm)",
    "bilinear_tensor_product": "item 4, the other nn layers (Bilinear)",
    "data_norm": "item 4, the other nn layers",
    "row_conv": "item 4, the other nn layers",
    "nce": "item 4, the other nn layers",
    "crf_decoding": "item 4, the other nn layers",
    "deform_conv2d": "item 4, the rest of the package (vision ops)",
    "multi_box_head": "item 4, the rest of the package (vision detection)",
}
for _n in ("sequence_pad sequence_unpad sequence_pool sequence_softmax "
           "sequence_reverse sequence_expand sequence_expand_as "
           "sequence_concat sequence_enumerate sequence_erase sequence_conv "
           "sequence_first_step sequence_last_step sequence_reshape "
           "sequence_slice sequence_scatter").split():
    NOT_PORTED[_n] = ("item 4, the other nn layers and functions "
                      "(nn/functional/sequence.py)")


def _not_ported(name, item):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"static.nn.{name} is not ported (ROADMAP Queue 1 {item})")
    fn.__name__ = name
    return fn


for _n, _item in NOT_PORTED.items():
    globals()[_n] = _not_ported(_n, _item)
