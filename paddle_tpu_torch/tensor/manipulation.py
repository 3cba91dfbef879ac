"""Shape ops (counterpart of ``paddle_tpu/tensor/manipulation.py``; only
``reshape``, ``concat`` and ``transpose``)."""
from __future__ import annotations

import numpy as np
import torch

from ..ops.dispatch import call
from .tensor import Tensor


def _ints(seq):
    if isinstance(seq, Tensor):
        return tuple(int(s) for s in seq.tolist())
    if isinstance(seq, (int, np.integer)):
        return (int(seq),)
    return tuple(int(s.item()) if isinstance(s, Tensor) else int(s)
                 for s in seq)


def reshape(x, shape, name=None):
    """-1 infers a dim; 0 copies the input's dim at that index."""
    shp = _ints(shape)

    def _r(a):
        return a.reshape([a.shape[i] if s == 0 else s
                          for i, s in enumerate(shp)])
    return call(_r, x)


def transpose(x, perm=None, name=None):
    p = _ints(perm) if perm is not None else None
    return call(lambda a: a.permute(p if p is not None
                                    else tuple(range(a.dim()))[::-1]), x)


def concat(x, axis=0, name=None):
    ax = int(axis.item()) if isinstance(axis, Tensor) else int(axis)
    return call(lambda xs: torch.cat(xs, dim=ax), list(x))
