"""Random ops (counterpart of ``paddle_tpu/tensor/random.py``).

Every draw comes from the default generator
(:func:`..framework.core.default_generator`): its CPU ``torch.Generator``
for the CPU, ``Generator.on(device)`` on the card, so one seed gives one
stream on each device and no draw leaves its device.  Creators draw on
the default place; the ops that take a tensor draw where it is.  The
generator is read inside each op's function, so a static program that
recorded the op draws afresh at each ``Executor.run``, as the
reference's ``uniform_random`` op does.  The reference's JAX keys give
other numbers from the same seed; the two packages agree in shapes,
dtypes, ranges and distributions, not in draws.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework import core
from ..ops.dispatch import call
from .creation import _ints as _shape
from .math import _i64
from .tensor import Tensor


def _dt(dtype, default=None):
    if dtype is None:
        return default or core.get_default_dtype()
    return core.convert_dtype(dtype)


def _gen(device):
    return core.default_generator().on(device)


def _dev():
    return core.get_place().device


def _draw(fn, *args, _name="random"):
    return call(fn, *args, _name=_name)


def _detached(x):
    return x.detach() if isinstance(x, Tensor) else x


def rand(shape, dtype=None, name=None):
    shp, dt, dev = _shape(shape), _dt(dtype), _dev()
    return _draw(lambda: torch.rand(shp, generator=_gen(dev), dtype=dt,
                                    device=dev), _name="uniform_random")


def randn(shape, dtype=None, name=None):
    shp, dt, dev = _shape(shape), _dt(dtype), _dev()
    return _draw(lambda: torch.randn(shp, generator=_gen(dev), dtype=dt,
                                     device=dev), _name="gaussian_random")


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    """N(mean, std): Tensor mean / std broadcast to the draw's shape."""
    dt = core.get_default_dtype()
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        def _n(m, s):
            t = m if isinstance(m, torch.Tensor) else s
            shp = torch.broadcast_shapes(
                tuple(getattr(m, "shape", ())), tuple(getattr(s, "shape", ())))
            z = torch.randn(shp, generator=_gen(t.device), dtype=dt,
                            device=t.device)
            return z * s + m
        return _draw(_n, _detached(mean), _detached(std),
                     _name="gaussian_random")
    shp, dev = (_shape(shape) if shape is not None else ()), _dev()
    return _draw(lambda: torch.randn(shp, generator=_gen(dev), dtype=dt,
                                     device=dev) * std + mean,
                 _name="gaussian_random")


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    """U[min, max); a nonzero ``seed`` draws from a generator of its own,
    made from that seed (the same numbers at every call)."""
    shp, dt, dev = _shape(shape), _dt(dtype), _dev()

    def _u():
        gen = (torch.Generator(device=dev).manual_seed(int(seed)) if seed
               else _gen(dev))
        return torch.rand(shp, generator=gen, dtype=dt,
                          device=dev) * (max - min) + min
    return _draw(_u, _name="uniform_random")


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    shp, dt, dev = _shape(shape), _dt(dtype or "int64"), _dev()
    return _draw(lambda: torch.randint(low, high, shp, generator=_gen(dev),
                                       dtype=dt, device=dev),
                 _name="randint")


def randint_like(x, low=0, high=None, dtype=None, name=None):
    if high is None:
        low, high = 0, low
    return _draw(lambda a: torch.randint(
        low, high, tuple(a.shape), generator=_gen(a.device),
        dtype=_dt(dtype, a.dtype), device=a.device), _detached(x),
        _name="randint")


def randperm(n, dtype="int64", name=None):
    dt, dev = _dt(dtype or "int64"), _dev()
    return _draw(lambda: torch.randperm(int(n), generator=_gen(dev),
                                        device=dev).to(dt),
                 _name="randperm")


def bernoulli(x, name=None):
    """Draws of 1 with the input's probabilities (float32 for a
    non-float input)."""
    def _bern(p):
        pf = p if p.is_floating_point() else p.to(torch.float32)
        u = torch.rand(pf.shape, generator=_gen(p.device), dtype=pf.dtype,
                       device=p.device)
        return (u < pf).to(pf.dtype)
    return _draw(_bern, _detached(x), _name="bernoulli")


def poisson(x, name=None):
    def _poisson(lam):
        return torch.poisson(lam, generator=_gen(lam.device)).to(lam.dtype)
    return _draw(_poisson, _detached(x), _name="poisson")


def multinomial(x, num_samples=1, replacement=False, name=None):
    """Category indices (int32) drawn with the rows' probabilities."""
    def _mn(p):
        return torch.multinomial(p, num_samples, replacement,
                                 generator=_gen(p.device)).to(_i64())
    return _draw(_mn, _detached(x), _name="multinomial")


def shuffle(x, axis=0, name=None):
    """The input's slices along ``axis`` in a random order."""
    def _sh(a):
        perm = torch.randperm(a.shape[axis], generator=_gen(a.device),
                              device=a.device)
        return torch.index_select(a, axis, perm)
    return _draw(_sh, _detached(x), _name="shuffle")


def exponential_(x, lam=1.0, name=None):
    v = x.value
    with torch.no_grad():
        u = torch.empty_like(v).exponential_(generator=_gen(v.device))
    x.set_value(u / lam)
    return x


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    v = x.value
    x.set_value(torch.rand(v.shape, generator=_gen(v.device), dtype=v.dtype,
                           device=v.device) * (max - min) + min)
    return x


def normal_(x, mean=0.0, std=1.0, name=None):
    v = x.value
    x.set_value(torch.randn(v.shape, generator=_gen(v.device), dtype=v.dtype,
                            device=v.device) * std + mean)
    return x


def _install():
    Tensor.uniform_ = uniform_
    Tensor.normal_ = normal_
    Tensor.exponential_ = exponential_
    Tensor.bernoulli = bernoulli
    Tensor.multinomial = multinomial


_install()


def check_shape(shape):
    """Validate a shape argument before a fill or creation op
    (``fluid/layers/utils.py:364`` in Paddle)."""
    if isinstance(shape, Tensor):
        if shape.dtype not in (torch.int32, torch.int64):
            raise TypeError("shape tensor must be int32 or int64")
        return
    for ele in shape:
        if isinstance(ele, Tensor):
            continue
        if not isinstance(ele, (int, np.integer)):
            raise TypeError("All elements in ``shape`` must be integers "
                            "when it's a list or tuple")
        if ele < 0:
            raise ValueError("All elements in ``shape`` must be positive "
                             "when it's a list or tuple")


__all__ = [_n for _n, _v in list(globals().items())
           if not _n.startswith("_")
           and getattr(_v, "__module__", None) == __name__]
