"""Activation functionals (counterpart of
``paddle_tpu/nn/functional/activation.py``; only ``relu``, ``tanh``,
``gelu``, ``selu`` and ``softmax``)."""
from __future__ import annotations

import torch

from ...framework import core
from ...ops.dispatch import call


def relu(x, name=None):
    return call(torch.relu, x, _name="relu")


def tanh(x, name=None):
    return call(torch.tanh, x, _name="tanh")


def gelu(x, approximate=False, name=None):
    """Exact erf gelu by default, as ``jax.nn.gelu(approximate=False)``;
    the tanh form with ``approximate=True``."""
    mode = "tanh" if approximate else "none"
    return call(lambda a: torch.nn.functional.gelu(a, approximate=mode), x,
                _name="gelu")


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    # the expm1 operand is clamped so the branch not taken cannot overflow
    # (0 * inf would make the gradient NaN at large inputs)
    return call(lambda a: scale * torch.where(
        a > 0, a, alpha * torch.expm1(torch.clamp(a, max=0.0))), x,
        _name="selu")


def softmax(x, axis=-1, dtype=None, name=None):
    dt = core.convert_dtype(dtype)
    return call(lambda a: torch.softmax(a if dt is None else a.to(dt),
                                        int(axis)), x, _name="softmax")
