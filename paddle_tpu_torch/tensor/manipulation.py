"""Shape ops (counterpart of ``paddle_tpu/tensor/manipulation.py``; only
``reshape``, ``flatten``, ``concat``, ``split`` and ``transpose``)."""
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
    return call(_r, x, _name="reshape")


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    """Dims ``start_axis`` to ``stop_axis`` (inclusive) joined into one."""
    def _fl(a):
        nd = a.dim()
        s = start_axis % nd if nd else 0
        e = stop_axis % nd if nd else 0
        return a.reshape(tuple(a.shape[:s]) + (-1,) + tuple(a.shape[e + 1:]))
    return call(_fl, x, _name="flatten")


def transpose(x, perm=None, name=None):
    p = _ints(perm) if perm is not None else None
    return call(lambda a: a.permute(p if p is not None
                                    else tuple(range(a.dim()))[::-1]), x,
                _name="transpose")


def concat(x, axis=0, name=None):
    ax = int(axis.item()) if isinstance(axis, Tensor) else int(axis)
    return call(lambda xs: torch.cat(xs, dim=ax), list(x), _name="concat")


def split(x, num_or_sections, axis=0, name=None):
    """``num_or_sections`` equal parts, or parts of the given sizes (one
    of them may be -1: the rest).  Returns a list of Tensors."""
    ax = int(axis.item()) if isinstance(axis, Tensor) else int(axis)
    dim = x.shape[ax]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections:
            raise ValueError(f"split: {dim} does not divide into "
                             f"{num_or_sections} parts")
        secs = [dim // num_or_sections] * num_or_sections
    else:
        secs = list(_ints(num_or_sections))
        if -1 in secs:
            secs[secs.index(-1)] = dim - sum(s for s in secs if s != -1)
    outs = call(lambda a: tuple(torch.split(a, secs, dim=ax)), x,
                _name="split")
    return list(outs)
