"""Initializers (counterpart of ``paddle_tpu/nn/initializer.py``; only
``Constant``, ``Normal``, ``Uniform``, ``XavierUniform`` and
``KaimingUniform``).

Each is a callable ``(shape, dtype) -> torch.Tensor`` on the CPU, drawn
from the default generator's ``torch.Generator``
(:func:`..framework.core.default_generator`); the caller moves it to its
place.  Draws do not match the reference's JAX keys: weights cross
between the packages through ``Layer.set_state_dict``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..framework import core


_dt = core.dtype_or_default


def _gen():
    return core.default_generator().torch


class Initializer:
    def __call__(self, shape, dtype=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype=None):
        return torch.full(tuple(shape), self.value, dtype=_dt(dtype))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=None):
        x = torch.randn(tuple(shape), generator=_gen())
        return (x * self.std + self.mean).to(_dt(dtype))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype=None):
        x = torch.empty(tuple(shape)).uniform_(self.low, self.high,
                                               generator=_gen())
        return x.to(_dt(dtype))


def _fans(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=None):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        x = torch.empty(tuple(shape)).uniform_(-limit, limit,
                                               generator=_gen())
        return x.to(_dt(dtype))


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.negative_slope = fan_in, negative_slope

    def __call__(self, shape, dtype=None):
        fi = self.fan_in if self.fan_in is not None else _fans(shape)[0]
        limit = (math.sqrt(2.0 / (1 + self.negative_slope ** 2))
                 * math.sqrt(3.0 / fi))
        x = torch.empty(tuple(shape)).uniform_(-limit, limit,
                                               generator=_gen())
        return x.to(_dt(dtype))
