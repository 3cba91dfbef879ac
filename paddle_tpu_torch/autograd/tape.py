"""Grad-mode switches (counterpart of ``paddle_tpu/autograd/tape.py``
``NoGrad`` / ``enable_grad`` / ``set_grad_enabled`` /
``is_grad_enabled``).

They flip :mod:`..framework.core`'s flag, which is torch's grad mode, so
``paddle_tpu_torch.no_grad`` and ``torch.no_grad`` are one switch.  The
reference's eager tape (``backward``, ``grad``, ``Node``) is not ported
yet: it lands with the eager-training slice, on torch autograd.
"""
from __future__ import annotations

import functools

from ..framework import core


class NoGrad:
    """Context manager / decorator disabling recording (paddle.no_grad)."""

    def __init__(self):
        self._prev = None

    def __enter__(self):
        self._prev = core.grad_enabled()
        core.set_grad_enabled_flag(False)
        return self

    def __exit__(self, *exc):
        core.set_grad_enabled_flag(self._prev)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            with NoGrad():
                return fn(*a, **k)
        return wrapper


no_grad = NoGrad


class enable_grad:
    def __init__(self):
        self._prev = None

    def __enter__(self):
        self._prev = core.grad_enabled()
        core.set_grad_enabled_flag(True)
        return self

    def __exit__(self, *exc):
        core.set_grad_enabled_flag(self._prev)
        return False


class set_grad_enabled:
    def __init__(self, mode: bool):
        self._mode = bool(mode)
        self._prev = core.grad_enabled()
        core.set_grad_enabled_flag(self._mode)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        core.set_grad_enabled_flag(self._prev)
        return False


def is_grad_enabled() -> bool:
    return core.grad_enabled()
