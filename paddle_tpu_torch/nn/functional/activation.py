"""Activation functionals (counterpart of
``paddle_tpu/nn/functional/activation.py``; only ``relu`` and
``gelu``)."""
from __future__ import annotations

import torch

from ...ops.dispatch import call


def relu(x, name=None):
    return call(torch.relu, x)


def gelu(x, approximate=False, name=None):
    """Exact erf gelu by default, as ``jax.nn.gelu(approximate=False)``;
    the tanh form with ``approximate=True``."""
    mode = "tanh" if approximate else "none"
    return call(lambda a: torch.nn.functional.gelu(a, approximate=mode), x)
