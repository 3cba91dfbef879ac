"""Creation ops (counterpart of ``paddle_tpu/tensor/creation.py``; only
``to_tensor``, ``zeros``, ``ones`` and ``arange``).  New tensors go to the
default place (:func:`..framework.core.get_place`)."""
from __future__ import annotations

import numpy as np
import torch

from ..framework import core
from .manipulation import _ints
from .tensor import Tensor


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """paddle.to_tensor: ``data`` on ``place`` (default: the default
    place).  A floating tensor with ``stop_gradient=False`` requires
    grad."""
    if isinstance(place, str):
        place = core._parse_device(place)
    t = Tensor(data, dtype=dtype, place=place or core.get_place(),
               stop_gradient=stop_gradient)
    if not stop_gradient and t.value.is_floating_point():
        t.value = t.value.detach().requires_grad_()
    return t


def zeros(shape, dtype=None, name=None):
    return Tensor(torch.zeros(_ints(shape), dtype=core.dtype_or_default(dtype),
                              device=core.get_place().device))


def ones(shape, dtype=None, name=None):
    return Tensor(torch.ones(_ints(shape), dtype=core.dtype_or_default(dtype),
                             device=core.get_place().device))


def arange(start=0, end=None, step=1, dtype=None, name=None):
    """Integer bounds give int32 (the reference's int64 under x64-off),
    others the default float dtype."""
    def _val(v):
        return v.item() if isinstance(v, Tensor) else v
    start, end, step = _val(start), _val(end), _val(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = ("int64" if all(isinstance(v, (int, np.integer))
                                for v in (start, end, step)) else None)
    return Tensor(torch.arange(start, end, step,
                               dtype=core.dtype_or_default(dtype),
                               device=core.get_place().device))
