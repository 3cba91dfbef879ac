"""static.nn layer builders (counterpart of ``paddle_tpu/static/nn.py``).
Each call makes the dygraph layer (or its parameters) and calls it, so
its parameters join the default program while it builds.  Every builder
is here, with the control flow, ``py_func`` and the sixteen
``sequence_*`` ops, and ``deform_conv2d`` and ``multi_box_head`` (the
vision ops' functions, as in the reference)."""
from __future__ import annotations

import numpy as np
import torch

from .. import nn as _nn
from ..framework import core
from ..nn import functional as F
from ..nn.functional.sequence import (  # noqa: F401
    sequence_concat, sequence_conv, sequence_enumerate, sequence_erase,
    sequence_expand, sequence_expand_as, sequence_first_step,
    sequence_last_step, sequence_pad, sequence_pool, sequence_reshape,
    sequence_reverse, sequence_scatter, sequence_slice, sequence_softmax,
    sequence_unpad)
from ..nn.initializer import Constant
from ..ops.dispatch import call
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


def group_norm(input, groups, epsilon=1e-5, param_attr=None,
               bias_attr=None, act=None, data_layout="NCHW", name=None):
    ch = input.shape[1 if data_layout.startswith("NC") else -1]
    return _act(_nn.GroupNorm(groups, ch, epsilon, param_attr,
                              bias_attr)(input), act)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None):
    return _nn.InstanceNorm2D(input.shape[1], epsilon, weight_attr=param_attr,
                              bias_attr=bias_attr)(input)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    return _nn.SpectralNorm(weight.shape, dim=dim, power_iters=power_iters,
                            eps=eps)(weight)


def bilinear_tensor_product(x, y, size, act=None, param_attr=None,
                            bias_attr=None, name=None):
    layer = _nn.Bilinear(x.shape[-1], y.shape[-1], size,
                         weight_attr=param_attr, bias_attr=bias_attr)
    return _act(layer(x, y), act)


def data_norm(input, act=None, epsilon=1e-5, param_attr=None, name=None,
              slot_dim=-1):
    """Normalisation by accumulated batch statistics, the CTR models'
    alternative to batch norm: three parameters [D] (batch size 1e4, sum
    0, square sum 1e4), mean = sum / size, var = square sum / size -
    mean^2 floored at ``epsilon``."""
    D = int(input.shape[-1])
    size, total, square = (create_parameter(
        [D], "float32", default_initializer=Constant(v))
        for v in (1e4, 0.0, 1e4))

    def _dn(x, n, s, sq):
        mean = s / n
        var = sq / n - mean * mean
        return (x - mean) / torch.sqrt(torch.clamp(var, min=epsilon))
    return _act(call(_dn, input, size, total, square, _name="data_norm"), act)


def row_conv(input, future_context_size, param_attr=None, act=None):
    """Lookahead convolution: out[t] = sum_j w[j] * x[t + j] over j = 0 ..
    future_context_size, zeros past the end.  input [B, T, D]."""
    k = int(future_context_size)
    w = create_parameter([k + 1, int(input.shape[-1])], "float32",
                         attr=param_attr)

    def _rc(x, wv):
        T = x.shape[1]
        out = 0.0
        for j in range(k + 1):
            out = out + torch.nn.functional.pad(x, (0, 0, 0, j))[
                :, j:j + T] * wv[j]
        return out
    return _act(call(_rc, input, w, _name="row_conv"), act)


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=10, name=None,
        sampler="uniform", custom_dist=None, seed=0, is_sparse=False):
    """Noise-contrastive estimation: the sigmoid cross entropy of the true
    class's logit plus that of ``num_neg_samples`` noise classes, drawn
    once per call (uniform, or from ``custom_dist``) from the default
    generator, or one seeded with ``seed`` when it is not 0.  Per-sample
    loss [N, 1]."""
    D = int(input.shape[-1])
    w = create_parameter([num_total_classes, D], "float32", attr=param_attr)
    b = create_parameter([num_total_classes], "float32", attr=bias_attr,
                         is_bias=True)
    gen = (torch.Generator().manual_seed(int(seed)) if seed
           else core.default_generator().torch)
    if custom_dist is not None:
        p = torch.clamp(torch.as_tensor(np.asarray(custom_dist, np.float32)),
                        min=1e-30)
        neg = torch.multinomial(p, num_neg_samples, replacement=True,
                                generator=gen)
    else:
        neg = torch.randint(0, num_total_classes, (num_neg_samples,),
                            generator=gen)

    def _nce(x, lbl, wv, bv):
        lbl = lbl.reshape(-1).long()
        ng = neg.to(x.device)
        pos = (x * wv[lbl]).sum(-1) + bv[lbl]                  # [N]
        negl = x @ wv[ng].T + bv[ng]                            # [N, K]

        def bce(z, t):
            return (torch.clamp(z, min=0) - z * t
                    + torch.log1p(torch.exp(-z.abs())))
        return (bce(pos, 1.0) + bce(negl, 0.0).sum(-1))[:, None]
    return call(_nce, input, label, w, b, _name="nce")


def crf_decoding(input, transition, lengths=None, label=None, name=None):
    """Viterbi decoding.  input [B, T, D] unary scores; transition
    [D + 2, D] (row 0 start scores, row 1 stop scores, then the [D, D]
    transitions).  Returns the best path [B, T] in int64 (0 past
    ``lengths``; ties to the lowest label, as argmax)."""
    def _viterbi(emis, trans, *rest):
        B, T, D = emis.shape
        start, stop, A = trans[0], trans[1], trans[2:]
        lens = (rest[0].reshape(B).to(torch.int32) if rest
                else torch.full((B,), T, dtype=torch.int32,
                                device=emis.device))
        alpha = start + emis[:, 0]
        if T == 1:
            return (alpha + stop[None]).argmax(-1)[:, None].to(torch.int64)
        ptrs = []
        for t in range(1, T):
            cand = alpha[:, :, None] + A[None]              # [B, prev, cur]
            ptrs.append(cand.argmax(1))
            live = (t < lens)[:, None]
            alpha = torch.where(live, cand.amax(1) + emis[:, t], alpha)
        cur = (alpha + stop[None]).argmax(-1)
        path = [cur]
        for i in range(T - 2, -1, -1):
            prev = torch.gather(ptrs[i], 1, cur[:, None])[:, 0]
            cur = torch.where(i + 1 <= lens - 1, prev, cur)
            path.append(cur)
        path = torch.stack(path[::-1], 1)
        mask = torch.arange(T, device=emis.device)[None, :] < lens[:, None]
        return torch.where(mask, path, 0).to(torch.int64)
    args = [input, transition] + ([lengths] if lengths is not None else [])
    return call(_viterbi, *args, _name="crf_decoding")


# builders whose op is still to port, and the ROADMAP item (Queue 1) that
# brings it: none
NOT_PORTED = {}

# shared names the reference exposes under static.nn as well
from ..vision.ops import deform_conv2d  # noqa: E402,F401
from ..vision.detection import multi_box_head  # noqa: E402,F401
