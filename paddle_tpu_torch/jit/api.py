"""The port's ``jit`` API (counterpart of ``paddle_tpu/jit/api.py``):
``InputSpec`` (``:25-36``), which ``hapi.Model(inputs=...)`` reads to
split batches, and the static-mode switches ``enable_static``,
``disable_static`` and ``in_static_mode`` (``:179-186``).
``to_static``, ``save`` and ``load`` are not ported."""
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


def enable_static():
    """Ops record into the default main program from now on
    (``static.graph``)."""
    from ..static.graph import _set_static_mode
    _set_static_mode(True)


def disable_static():
    from ..static.graph import _set_static_mode
    _set_static_mode(False)


def in_static_mode():
    from ..static.graph import in_static_mode as _in
    return _in()
