"""Common functionals (counterpart of
``paddle_tpu/nn/functional/common.py``; only ``linear``, ``embedding``
and ``dropout``).  Dropout draws its mask where its tensor is, from the
default generator's ``torch.Generator`` for that device
(``core.Generator.on``): no host draw and no copy."""
from __future__ import annotations

import torch

from ...framework import core
from ...ops.dispatch import call


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


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    if not training:
        if mode == "downscale_in_infer" and p > 0.0:
            return call(lambda a: a * (1.0 - p), x, _name="dropout_infer")
        return call(lambda a: a, x, _name="dropout_noop")
    if p == 0.0:
        return call(lambda a: a, x, _name="dropout_noop")

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
