"""Attribute ops (counterpart of ``paddle_tpu/tensor/attribute.py``).  The
shape and rank tensors are int32, on the input's device."""
from __future__ import annotations

import torch

from .tensor import Tensor


def shape(input):
    return Tensor(torch.tensor(input.shape, dtype=torch.int32).to(
        input.value.device))


def rank(input):
    return Tensor(torch.full((), input.ndim, dtype=torch.int32,
                             device=input.value.device))


def is_complex(x):
    return x.dtype.is_complex


def is_floating_point(x):
    return x.dtype.is_floating_point


def is_integer(x):
    return not (x.dtype.is_floating_point or x.dtype.is_complex
                or x.dtype == torch.bool)


def _install():
    Tensor.is_complex = is_complex
    Tensor.is_floating_point = is_floating_point
    Tensor.is_integer = is_integer


_install()


__all__ = [_n for _n, _v in list(globals().items())
           if not _n.startswith("_")
           and getattr(_v, "__module__", None) == __name__]
