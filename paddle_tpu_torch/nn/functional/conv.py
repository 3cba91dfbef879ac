"""Convolutions (counterpart of ``paddle_tpu/nn/functional/conv.py``).

The JAX package leaves convolutions to XLA (``lax.conv_general_dilated``);
the port leaves them to PyTorch's convolutions (cuDNN on the card).  No
TPU kernel is involved.  The reference's conventions are kept at the
public functions:

* weights are OIHW-family (``[out, in / groups, *k]``; transposes
  ``[in, out / groups, *k]``) whatever ``data_format`` is; a channel-last
  input is moved to channel-first around the convolution;
* ``padding`` is an int, one per spatial dim, a (low, high) pair per dim,
  a flat ``2 * n`` list, or ``"SAME"`` / ``"VALID"`` (``"SAME"`` with any
  stride and dilation, as XLA pads: the low side gets the smaller half).
  PyTorch pads both sides alike, so unequal sides are padded explicitly
  first;
* a float32 convolution on the card is float32: cuDNN's TF32, on by
  default in PyTorch, is turned off for the process the first time one
  runs there (``torch.backends.cudnn.allow_tf32``, which the backward's
  convolutions also read when they run);
* on the CPU (the plain version the tests hold against the reference) a
  convolution runs forward and backward without oneDNN
  (:class:`_PlainConv`): oneDNN's float32 backward of a 3x3 convolution
  can lose about three digits, against the reference's 1e-7.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as TF

from ...ops.dispatch import call


def _tup(v, n):
    if isinstance(v, int):
        return (v,) * n
    v = tuple(v)
    return v * n if len(v) == 1 else v


def _padding(padding, n):
    """A paddle padding spec -> "SAME", "VALID" or n (low, high) pairs."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n:
        if isinstance(padding[0], (list, tuple)):
            return [tuple(p) for p in padding]
        return [(p, p) for p in padding]
    if len(padding) == 2 * n:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    raise ValueError(f"bad padding {padding}")


def _same_pads(sizes, k_eff, strides):
    """XLA's "SAME": the output is ceil(size / stride), the total padding
    split with the smaller half low."""
    pads = []
    for n, k, s in zip(sizes, k_eff, strides):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _flat_pads(pads):
    """(low, high) per spatial dim -> ``F.pad``'s list, last dim first."""
    out = []
    for lo, hi in reversed(pads):
        out += [lo, hi]
    return out


def _fp32_on_card(a):
    if (a.is_cuda and a.dtype == torch.float32
            and torch.backends.cudnn.allow_tf32):
        torch.backends.cudnn.allow_tf32 = False


_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}


@contextlib.contextmanager
def _no_onednn():
    was = torch._C._get_mkldnn_enabled()
    torch._C._set_mkldnn_enabled(False)
    try:
        yield
    finally:
        torch._C._set_mkldnn_enabled(was)


class _PlainConv(torch.autograd.Function):
    """A CPU convolution whose forward and backward run with oneDNN off
    (PyTorch's own im2col kernels)."""

    @staticmethod
    def forward(ctx, a, w, b, nd, stride, padding, dilation, groups):
        with _no_onednn():
            out = _CONV[nd](a, w, b, stride, padding, dilation, groups)
        ctx.save_for_backward(a, w)
        ctx.cfg = (stride, padding, dilation, groups, nd, b is not None)
        return out

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        stride, padding, dilation, groups, nd, has_b = ctx.cfg
        padding = list(padding) if isinstance(padding, (list, tuple)) \
            else [padding] * nd
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                has_b and ctx.needs_input_grad[2]]
        with _no_onednn():
            gi, gw, gb = torch.ops.aten.convolution_backward(
                g, a, w, [w.shape[0]] if has_b else None, list(stride),
                padding, list(dilation), False, [0] * nd, groups, mask)
        return gi, gw, gb, None, None, None, None, None


_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}


def _conv_nd(nd, x, weight, bias, stride, padding, dilation, groups,
             data_format, opname):
    channel_last = not data_format.startswith("NC")
    s = _tup(stride, nd)
    d = _tup(dilation, nd)
    pad = _padding(padding, nd)

    def _conv(a, w, *b):
        _fp32_on_card(a)
        if channel_last:
            a = a.movedim(-1, 1)
        k = w.shape[2:]
        if pad == "VALID":
            pads = [(0, 0)] * nd
        elif pad == "SAME":
            pads = _same_pads(a.shape[2:],
                              [d[i] * (k[i] - 1) + 1 for i in range(nd)], s)
        else:
            pads = pad
        if all(lo == hi for lo, hi in pads):
            tp = [lo for lo, _ in pads]
        else:
            a, tp = TF.pad(a, _flat_pads(pads)), 0
        bias = b[0] if b else None
        if a.device.type == "cpu":
            out = _PlainConv.apply(a, w, bias, nd, s, tp, d, groups)
        else:
            out = _CONV[nd](a, w, bias, s, tp, d, groups)
        return out.movedim(1, -1) if channel_last else out
    if bias is not None:
        return call(_conv, x, weight, bias, _name=opname)
    return call(_conv, x, weight, _name=opname)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    fmt = "NCW" if data_format in ("NCL", "NCW") else "NWC"
    return _conv_nd(1, x, weight, bias, stride, padding, dilation, groups,
                    fmt, "conv1d")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv_nd(2, x, weight, bias, stride, padding, dilation, groups,
                    data_format, "conv2d")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv_nd(3, x, weight, bias, stride, padding, dilation, groups,
                    data_format, "conv3d")


def _conv_transpose_nd(nd, x, weight, bias, stride, padding, output_padding,
                       dilation, groups, output_size, data_format, opname):
    """The reference's transpose: a correlation of the stride-dilated input
    with the flipped kernel, padded (d (k - 1) - low, d (k - 1) - high +
    output padding); string padding raises, as there.  Here:
    ``conv_transpose`` unpadded (the full output, which is that
    correlation padded d (k - 1) on both sides), then cropped by the
    padding and zero-extended by the output padding, then the bias."""
    channel_last = not data_format.startswith("NC")
    s = _tup(stride, nd)
    d = _tup(dilation, nd)
    op_pad = _tup(output_padding, nd) if output_padding else (0,) * nd
    if isinstance(padding, str):
        # as the reference (lax refuses string padding for a transpose)
        raise ValueError("String padding is not implemented for transposed "
                         "convolution; give the padding as numbers")
    pad = _padding(padding, nd)
    if output_size is not None:
        out_req = [int(v) for v in (
            output_size if isinstance(output_size, (list, tuple))
            else [output_size] * nd)]
    else:
        out_req = None

    def _convt(a, w, *b):
        _fp32_on_card(a)
        if channel_last:
            a = a.movedim(-1, 1)
        k, sp = w.shape[2:], a.shape[2:]
        op = op_pad
        if out_req is not None:
            # output_size picks among the stride-many valid sizes
            op = [out_req[i] - ((sp[i] - 1) * s[i] - (pad[i][0] + pad[i][1])
                                + d[i] * (k[i] - 1) + 1) for i in range(nd)]
            for i, o in enumerate(op):
                if not (0 <= o < s[i]):
                    raise ValueError(
                        f"output_size[{i}]={out_req[i]} out of the valid "
                        f"range [{out_req[i] - o}, "
                        f"{out_req[i] - o + s[i] - 1}] (reference "
                        "conv_transpose contract)")
        out = _CONV_T[nd](a, w, None, s, 0, 0, groups, d)
        # the full output cropped by the padding (negative F.pad), the
        # output padding added as zeros on the high side
        out = TF.pad(out, _flat_pads([(-pad[i][0], op[i] - pad[i][1])
                                      for i in range(nd)]))
        if b:
            out = out + b[0].reshape((1, -1) + (1,) * nd)
        return out.movedim(1, -1) if channel_last else out
    if bias is not None:
        return call(_convt, x, weight, bias, _name=opname)
    return call(_convt, x, weight, _name=opname)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCL", name=None):
    fmt = "NCW" if data_format in ("NCL", "NCW") else "NWC"
    return _conv_transpose_nd(1, x, weight, bias, stride, padding,
                              output_padding, dilation, groups, output_size,
                              fmt, "conv1d_transpose")


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCHW", name=None):
    return _conv_transpose_nd(2, x, weight, bias, stride, padding,
                              output_padding, dilation, groups, output_size,
                              data_format, "conv2d_transpose")


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCDHW", name=None):
    return _conv_transpose_nd(3, x, weight, bias, stride, padding,
                              output_padding, dilation, groups, output_size,
                              data_format, "conv3d_transpose")
