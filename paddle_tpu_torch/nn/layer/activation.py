"""Activation layers (counterpart of ``paddle_tpu/nn/layer/activation.py``;
only ``ReLU`` and ``Tanh``, which the high-level API's models use)."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer


def _simple(fname, cls_name):
    fn = getattr(F, fname)

    class _Act(Layer):
        def __init__(self, name=None):
            super().__init__()

        def forward(self, x):
            return fn(x)

    _Act.__name__ = cls_name
    _Act.__qualname__ = cls_name
    return _Act


ReLU = _simple("relu", "ReLU")
Tanh = _simple("tanh", "Tanh")
