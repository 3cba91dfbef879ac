"""Creation ops (counterpart of ``paddle_tpu/tensor/creation.py``).  New
tensors go to the default place (:func:`..framework.core.get_place`);
the ``*_like`` ops and those that take a tensor run where it is."""
from __future__ import annotations

import numpy as np
import torch

from ..framework import core
from ..ops.dispatch import call
from .manipulation import _ints
from .tensor import Tensor


def _dt(dtype, default=None):
    if dtype is None:
        return default or core.get_default_dtype()
    return core.convert_dtype(dtype)


def _dev():
    return core.get_place().device


def _val(v):
    return v.item() if isinstance(v, Tensor) else v


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
    return Tensor(torch.zeros(_ints(shape), dtype=_dt(dtype), device=_dev()))


def ones(shape, dtype=None, name=None):
    return Tensor(torch.ones(_ints(shape), dtype=_dt(dtype), device=_dev()))


def full(shape, fill_value, dtype=None, name=None):
    """``dtype=None`` is the default float dtype whatever the fill value
    (``full([2], 7)`` is float)."""
    if isinstance(fill_value, Tensor):
        fill_value = fill_value.item()
    elif isinstance(fill_value, str):
        fill_value = float(fill_value)
    return Tensor(torch.full(_ints(shape), fill_value, dtype=_dt(dtype),
                             device=_dev()))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def _like(x):
    return x.detach() if isinstance(x, Tensor) else Tensor(x)


def zeros_like(x, dtype=None, name=None):
    return call(lambda a: torch.zeros_like(a, dtype=_dt(dtype, a.dtype)),
                _like(x), _name="zeros_like")


def ones_like(x, dtype=None, name=None):
    return call(lambda a: torch.ones_like(a, dtype=_dt(dtype, a.dtype)),
                _like(x), _name="ones_like")


def full_like(x, fill_value, dtype=None, name=None):
    return call(lambda a: torch.full_like(a, fill_value,
                                          dtype=_dt(dtype, a.dtype)),
                _like(x), _name="full_like")


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    """Integer bounds give int32 (the reference's int64 under x64-off),
    others the default float dtype."""
    start, end, step = _val(start), _val(end), _val(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = ("int64" if all(isinstance(v, (int, np.integer))
                                for v in (start, end, step)) else None)
    return Tensor(torch.arange(start, end, step, dtype=_dt(dtype),
                               device=_dev()))


def linspace(start, stop, num, dtype=None, name=None):
    return Tensor(torch.linspace(_val(start), _val(stop), int(_val(num)),
                                 dtype=_dt(dtype), device=_dev()))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return Tensor(torch.logspace(_val(start), _val(stop), int(_val(num)),
                                 base=base, dtype=_dt(dtype), device=_dev()))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    n = int(num_rows)
    m = n if num_columns is None else int(num_columns)
    return Tensor(torch.eye(n, m, dtype=_dt(dtype), device=_dev()))


def diag(x, offset=0, padding_value=0, name=None):
    """A 1-D x: the matrix with x on diagonal ``offset`` and
    ``padding_value`` elsewhere; a 2-D x: that diagonal of it."""
    def _diag(a):
        if a.dim() == 1:
            out = torch.diag(a, offset)
            if padding_value != 0:
                keep = torch.diag(torch.ones_like(a, dtype=torch.bool),
                                  offset)
                out = torch.where(keep, out, torch.full(
                    (), padding_value, dtype=out.dtype, device=a.device))
            return out
        return torch.diagonal(a, offset).clone()
    return call(_diag, x, _name="diag")


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    return call(lambda a: torch.diag_embed(a, offset, dim1, dim2), x,
                _name="diag_embed")


def tril(x, diagonal=0, name=None):
    return call(lambda a: torch.tril(a, diagonal), x, _name="tril")


def triu(x, diagonal=0, name=None):
    return call(lambda a: torch.triu(a, diagonal), x, _name="triu")


def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    outs = call(lambda xs: tuple(torch.meshgrid(*xs, indexing="ij")),
                list(args), _name="meshgrid")
    return list(outs) if isinstance(outs, tuple) else [outs]


def assign(x, output=None):
    """A copy of ``x`` (a Tensor where it is; anything else on the
    default place), or ``x`` copied into ``output``."""
    if output is None:
        if isinstance(x, Tensor):
            return Tensor(x.value.detach().clone())
        return Tensor(np.asarray(x), place=core.get_place())
    output.set_value(x)
    return output


def clone(x, name=None):
    return x.clone()


def numel(x, name=None):
    return Tensor(torch.full((), x.size, dtype=torch.int32,
                             device=x.value.device))


def tolist(x):
    return x.tolist()


def complex(real, imag, name=None):
    return call(lambda r, i: torch.complex(r, i), real, imag,
                _name="complex")


def _install():
    Tensor.tril = tril
    Tensor.triu = triu
    Tensor.diag = diag
    Tensor.diag_embed = diag_embed
    Tensor.numel = lambda s: numel(s)


_install()


__all__ = [_n for _n, _v in list(globals().items())
           if not _n.startswith("_")
           and getattr(_v, "__module__", None) == __name__]
