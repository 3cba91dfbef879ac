"""Math ops (counterpart of ``paddle_tpu/tensor/math.py``; only ``add``,
``sum``, ``mean`` and ``matmul``), under the reference's op names
(``amp.auto_cast``'s lists select by them)."""
from __future__ import annotations

import torch

from ..framework import core
from ..ops.dispatch import call


def _axis(axis):
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def add(x, y, name=None):
    return call(torch.add, x, y, _name="add")


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    """Bool and int32 sums give int32 (the reference's int64 under
    x64-off), unless ``dtype`` says otherwise."""
    ax = _axis(axis)
    dt = core.convert_dtype(dtype)

    def _sum(a):
        out = (torch.sum(a, dim=ax, keepdim=keepdim) if ax is not None
               else torch.sum(a))
        if dt is not None:
            return out.to(dt)
        if a.dtype in (torch.bool, torch.int32):
            return out.to(torch.int32)
        return out
    return call(_sum, x, _name="sum")


def mean(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return call(lambda a: (torch.mean(a, dim=ax, keepdim=keepdim)
                           if ax is not None else torch.mean(a)),
                x, _name="mean")


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    def _mm(a, b):
        if transpose_x and a.dim() > 1:
            a = a.transpose(-1, -2)
        if transpose_y and b.dim() > 1:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)
    return call(_mm, x, y, _name="matmul")
