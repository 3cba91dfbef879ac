"""Common functionals (counterpart of
``paddle_tpu/nn/functional/common.py``).  The dropouts draw their masks
where their tensor is, from the default generator's ``torch.Generator``
for that device (``core.Generator.on``): no host draw and no copy.

``interpolate`` mirrors the reference's separable resize op for op
(``_resize_axis``), not ``torch.nn.functional.interpolate``: nearest
takes floor(dst * scale) or, with ``align_corners``, round-half-up of
the corner-aligned coordinate; linear and cubic (Keys, a = -0.75,
border-replicated taps) take half-pixel coordinates (``align_mode=0``,
clamped at 0 for linear) or the fluid-era asymmetric dst * scale
(``align_mode=1``, linear only); area averages the adaptive bins
[floor(i in / out), ceil((i + 1) in / out)).  Linear, cubic and area
compute in float32 and cast back.  ``pad`` takes the reference's forms
(a pair per dim in dim order, or pairs for the trailing spatial dims,
last dim first) and modes (reflect without the edge, replicate,
circular) on any dim, by gathering indices.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from ...framework import core
from ...ops.dispatch import call
from ...tensor.tensor import Tensor


def _affine(a, w, b=None):
    """``a @ w (+ b)``, a and w promoted to one dtype as ``jnp.matmul``
    promotes them.  With a bias of that dtype and rows in ``a``, one
    ``addmm`` (the bias added in the GEMM's epilogue, no separate
    launch); otherwise ``matmul`` then the add, which promotes."""
    dt = torch.promote_types(a.dtype, w.dtype)
    a, w = a.to(dt), w.to(dt)
    if b is None:
        return torch.matmul(a, w)
    if a.dim() >= 2 and b.dtype == dt:
        out = torch.addmm(b, a.reshape(-1, a.shape[-1]), w)
        return out.view(*a.shape[:-1], w.shape[-1])
    return torch.matmul(a, w) + b


def linear(x, weight, bias=None, name=None):
    """``x @ W + b`` with W stored [in, out], as the reference stores it.
    The product is a plain cuBLAS call (``matmul``, or ``addmm`` with the
    bias), as the reference leaves it to XLA."""
    if bias is None:
        return call(_affine, x, weight, _name="linear")
    return call(_affine, x, weight, bias, _name="linear")


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of the table at ``x``; the ``padding_idx`` row reads as zeros
    (the reference masks the table, so that row also gets no
    gradient)."""
    def _emb(i, w):
        if padding_idx is not None:
            pid = padding_idx if padding_idx >= 0 else w.shape[0] + padding_idx
            mask = (torch.arange(w.shape[0], device=w.device) != pid)
            w = w * mask[:, None].to(w.dtype)
        return torch.index_select(w, 0, i.reshape(-1)).reshape(
            *i.shape, w.shape[1])
    return call(_emb, x, weight, _name="embedding")


def _mask(shape, keep, device):
    """A Bernoulli(keep) mask drawn on ``device`` from the default
    generator's generator for it."""
    u = torch.rand(shape, generator=core.default_generator().on(device),
                   device=device)
    return u < keep


def _noop(a):
    """``a`` as a new node of the graph (a view), so the op's output is
    not its input and gradients reach the input through it."""
    return a.view_as(a)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    if not training:
        if mode == "downscale_in_infer" and p > 0.0:
            return call(lambda a: a * (1.0 - p), x, _name="dropout_infer")
        return call(_noop, x, _name="dropout_noop")
    if p == 0.0:
        return call(_noop, x, _name="dropout_noop")

    def _d(a):
        if axis is None:
            mask_shape = a.shape
        else:
            axes = (axis,) if isinstance(axis, int) else tuple(axis)
            mask_shape = tuple(s if i in axes else 1
                               for i, s in enumerate(a.shape))
        keep = 1.0 - p
        mask = _mask(mask_shape, keep, a.device)
        if mode == "upscale_in_train":
            return torch.where(mask, a / keep, 0.0).to(a.dtype)
        return torch.where(mask, a, 0.0).to(a.dtype)
    return call(_d, x, _name="dropout")


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    ax = (0, 1) if data_format == "NCHW" else (0, 3)
    return dropout(x, p, axis=ax, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    ax = (0, 1) if data_format == "NCDHW" else (0, 4)
    return dropout(x, p, axis=ax, training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU-preserving dropout: dropped entries take -alpha * scale, then
    the affine map that keeps mean and variance."""
    if not training or p == 0.0:
        return call(_noop, x, _name="alpha_dropout_noop")
    alpha_p = -1.6732632423543772 * 1.0507009873554805

    def _ad(a):
        keep = 1.0 - p
        q = 1.0 - keep
        A = (keep + alpha_p ** 2 * keep * q) ** -0.5
        B = -A * alpha_p * q
        mask = _mask(a.shape, keep, a.device)
        return (A * torch.where(mask, a, alpha_p) + B).to(a.dtype)
    return call(_ad, x, _name="alpha_dropout")


def _pad_index(n, lo, hi, mode, device):
    """Source indices of a dim of size n padded by (lo, hi): numpy's
    ``edge``, ``wrap`` or ``reflect`` (no edge repeat)."""
    j = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return j.clamp(0, n - 1)
    if mode == "circular":
        return j.remainder(n)
    if n == 1:
        return torch.zeros_like(j)
    period = 2 * (n - 1)
    j = j.remainder(period)
    return torch.where(j >= n, period - j, j)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    if isinstance(pad, Tensor):
        pad = pad.tolist()
    pad = [int(p) for p in pad]
    if mode not in ("constant", "reflect", "replicate", "circular"):
        raise ValueError(f"pad: unknown mode {mode!r}")

    def _pad(a):
        nd = a.dim()
        widths = [(0, 0)] * nd
        if len(pad) == 2 * nd:
            widths = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
        else:
            spatial = (list(range(2, nd)) if data_format.startswith("NC")
                       else list(range(1, nd - 1)))
            k = len(pad) // 2
            for i, d in enumerate(spatial[-k:][::-1]):
                widths[d] = (pad[2 * i], pad[2 * i + 1])
        if mode == "constant":
            flat = [w for lo_hi in reversed(widths) for w in lo_hi]
            return TF.pad(a, flat, value=value)
        for d, (lo, hi) in enumerate(widths):
            if lo or hi:
                a = a.index_select(d, _pad_index(a.shape[d], lo, hi, mode,
                                                 a.device))
        return a
    return call(_pad, x, _name="pad")


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0, data_format=data_format)


def _linspace(start, stop, num, device):
    """float32 ``jnp.linspace``: start (1 - i / div) + stop i / div, the
    last point ``stop``."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / div
    out = start * (1 - step) + stop * step
    return torch.cat([out, torch.full((1,), float(stop), device=device)])


def _interp_coords(s_in, s_out, align_corners, align_mode, device,
                   cubic=False):
    """The fractional source coordinate of each output index."""
    if align_corners:
        if s_out == 1:
            return torch.zeros((1,), device=device)
        return _linspace(0.0, s_in - 1, s_out, device)
    scale = s_in / s_out
    i = torch.arange(s_out, dtype=torch.float32, device=device)
    if align_mode == 1 and not cubic:
        return i * scale
    x = (i + 0.5) * scale - 0.5
    return x if cubic else x.clamp(min=0.0)


def _keys(d, a=-0.75):
    d = d.abs()
    return torch.where(d <= 1, (a + 2) * d ** 3 - (a + 3) * d ** 2 + 1,
                       torch.where(d < 2, a * d ** 3 - 5 * a * d ** 2
                                   + 8 * a * d - 4 * a, 0.0))


def _resize_axis(out, ax, s_out, mode, align_corners, align_mode):
    s_in = out.shape[ax]
    if s_in == s_out:
        return out
    dev = out.device

    def bcast(w):
        shape = [1] * out.dim()
        shape[ax] = s_out
        return w.reshape(shape).float()

    if mode == "nearest":
        if align_corners:
            idx = torch.floor(_linspace(0.0, s_in - 1, max(s_out, 1), dev)
                              + 0.5)
        else:
            idx = torch.floor(torch.arange(s_out, dtype=torch.float32,
                                           device=dev) * (s_in / s_out))
        return out.index_select(ax, idx.clamp(0, s_in - 1).long())
    if mode == "area":
        if s_in % s_out == 0:
            k = s_in // s_out
            shape = out.shape[:ax] + (s_out, k) + out.shape[ax + 1:]
            return out.float().reshape(shape).mean(ax + 1)
        i = np.arange(s_out, dtype=np.int64)
        start = torch.as_tensor((i * s_in) // s_out, device=dev)
        end = torch.as_tensor(-((-(i + 1) * s_in) // s_out), device=dev)
        if s_in * s_out <= 1 << 22:
            j = torch.arange(s_in, device=dev)
            member = ((j[None, :] >= start[:, None])
                      & (j[None, :] < end[:, None])).float()
            total = torch.tensordot(member, out.float(),
                                    dims=([1], [ax])).movedim(0, ax)
        else:
            csum = out.float().cumsum(ax)
            csum = torch.cat([torch.zeros_like(csum.narrow(ax, 0, 1)), csum],
                             ax)
            total = csum.index_select(ax, end) - csum.index_select(ax, start)
        return total / bcast((end - start).float())
    x = _interp_coords(s_in, s_out, align_corners, align_mode, dev,
                       cubic=(mode == "cubic"))
    if mode == "linear":
        lo = torch.floor(x).clamp(0, s_in - 1).long()
        hi = (lo + 1).clamp(max=s_in - 1)
        w = bcast(x - lo)
        return (out.index_select(ax, lo).float() * (1 - w)
                + out.index_select(ax, hi).float() * w)
    x0 = torch.floor(x)
    t = x - x0
    acc = None
    for off in (-1, 0, 1, 2):
        idx = (x0 + off).clamp(0, s_in - 1).long()
        term = out.index_select(ax, idx).float() * bcast(_keys(t - off))
        acc = term if acc is None else acc + term
    return acc


_MODES = {"nearest": "nearest", "bilinear": "linear", "trilinear": "linear",
          "linear": "linear", "bicubic": "cubic", "area": "area"}


def _sizes(v):
    v = v.tolist() if isinstance(v, Tensor) else v
    v = v if isinstance(v, (list, tuple)) else [v]
    return [int(s.item()) if isinstance(s, Tensor) else int(s) for s in v]


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    base = _MODES[mode.lower()]

    def _interp(a):
        cf = data_format.startswith("NC")
        spatial_in = a.shape[2:] if cf else a.shape[1:-1]
        if size is not None:
            sz = _sizes(size)
        else:
            sf = (scale_factor if isinstance(scale_factor, (list, tuple))
                  else [scale_factor] * len(spatial_in))
            sz = [int(s * f) for s, f in zip(spatial_in, sf)]
        axes = (range(2, a.dim()) if cf else range(1, a.dim() - 1))
        out = a
        for ax, s_out in zip(axes, sz):
            out = _resize_axis(out, ax, int(s_out), base, align_corners,
                               align_mode)
        return out.to(a.dtype)
    return call(_interp, x, _name="interpolate")


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW", name=None):
    return interpolate(x, size, scale_factor, mode, align_corners, align_mode,
                       data_format)


def bilinear(x1, x2, weight, bias=None, name=None):
    def _bl(a, b, w, *bs):
        out = torch.einsum("bi,oij,bj->bo", a, w, b)
        return out + bs[0] if bs else out
    args = (x1, x2, weight) + ((bias,) if bias is not None else ())
    return call(_bl, *args, _name="bilinear")


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    def _cs(a, b):
        dot = (a * b).sum(axis)
        na = (a * a).sum(axis).sqrt()
        nb = (b * b).sum(axis).sqrt()
        return dot / torch.clamp(na * nb, min=eps)
    return call(_cs, x1, x2, _name="cosine_similarity")


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    def _pd(a, b):
        d = a - b + epsilon
        return d.abs().pow(p).sum(-1, keepdim=keepdim).pow(1.0 / p)
    return call(_pd, x, y, _name="pairwise_distance")


def one_hot(x, num_classes, name=None):
    """Rows of the identity in the default dtype; an index outside
    [0, num_classes) gives a row of zeros, as ``jax.nn.one_hot``."""
    return call(lambda i: (i[..., None] == torch.arange(
        num_classes, device=i.device)).to(core.get_default_dtype()),
        x, _name="one_hot")


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    def _ls(lab, *pd):
        if pd:
            return (1 - epsilon) * lab + epsilon * pd[0]
        return (1 - epsilon) * lab + epsilon / lab.shape[-1]
    args = (label,) + ((prior_dist,) if prior_dist is not None else ())
    return call(_ls, *args, _name="label_smooth")


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: [N, C * kh * kw, L]; ``paddings`` an int, (h, w) or
    (top, left, bottom, right)."""
    k, s, d = _pair(kernel_sizes), _pair(strides), _pair(dilations)
    if isinstance(paddings, int):
        p = (paddings,) * 4
    elif len(paddings) == 2:
        p = (paddings[0], paddings[1], paddings[0], paddings[1])
    else:
        p = tuple(paddings)
    return call(lambda a: TF.unfold(TF.pad(a, (p[1], p[3], p[0], p[2])), k,
                                    dilation=d, stride=s),
                x, _name="unfold")


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, overlapping entries summed: [N, C * kh * kw, L] ->
    [N, C, *output_sizes]."""
    out_sz, k, s, d = (_pair(output_sizes), _pair(kernel_sizes),
                       _pair(strides), _pair(dilations))
    p = (paddings, paddings) if isinstance(paddings, int) else tuple(
        paddings)[:2]
    return call(lambda a: TF.fold(a, out_sz, k, dilation=d, padding=p,
                                  stride=s), x, _name="fold")


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor

    def _ps(a):
        if data_format == "NCHW":
            n, c, h, w = a.shape
            a = a.reshape(n, c // (r * r), r, r, h, w).permute(
                0, 1, 4, 2, 5, 3)
            return a.reshape(n, c // (r * r), h * r, w * r)
        n, h, w, c = a.shape
        a = a.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
        return a.reshape(n, h * r, w * r, c // (r * r))
    return call(_ps, x, _name="pixel_shuffle")


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = downscale_factor

    def _pu(a):
        if data_format != "NCHW":
            a = a.permute(0, 3, 1, 2)
        n, c, h, w = a.shape
        a = a.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
        a = a.reshape(n, c * r * r, h // r, w // r)
        return a.permute(0, 2, 3, 1) if data_format != "NCHW" else a
    return call(_pu, x, _name="pixel_unshuffle")


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    def _csh(a):
        if data_format != "NCHW":
            a = a.permute(0, 3, 1, 2)
        n, c, h, w = a.shape
        a = a.reshape(n, groups, c // groups, h, w).transpose(1, 2)
        a = a.reshape(n, c, h, w)
        return a.permute(0, 2, 3, 1) if data_format != "NCHW" else a
    return call(_csh, x, _name="channel_shuffle")
