"""Math ops (counterpart of ``paddle_tpu/tensor/math.py``; only ``add``
and ``matmul``)."""
from __future__ import annotations

import torch

from ..ops.dispatch import call


def add(x, y, name=None):
    return call(torch.add, x, y)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    def _mm(a, b):
        if transpose_x and a.dim() > 1:
            a = a.transpose(-1, -2)
        if transpose_y and b.dim() > 1:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)
    return call(_mm, x, y)
