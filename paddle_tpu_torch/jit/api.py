"""The port's ``jit`` API: only ``InputSpec`` (counterpart of
``paddle_tpu/jit/api.py:25-36``), which ``hapi.Model(inputs=...)`` reads
to split batches.  ``to_static``, ``save`` and ``load`` are not ported."""
from __future__ import annotations

from ..framework import core


class InputSpec:
    """ref: python/paddle/static/input.py::InputSpec."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(shape)
        self.dtype = core.convert_dtype(dtype)
        self.name = name

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype})"
