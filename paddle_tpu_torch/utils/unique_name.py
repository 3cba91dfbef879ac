# Copied from paddle_tpu/utils/unique_name.py (process-wide unique names, stdlib only), code unchanged; the port keeps its own copy so it never imports paddle_tpu.
"""paddle.utils.unique_name (ref: python/paddle/utils/unique_name.py →
fluid/unique_name.py): process-wide unique names for program variables."""
from __future__ import annotations

import contextlib
import threading


class _Generator:
    def __init__(self, prefix=""):
        self.prefix = prefix
        self.counters = {}
        self._lock = threading.Lock()

    def generate(self, key):
        with self._lock:
            n = self.counters.get(key, 0)
            self.counters[key] = n + 1
        return f"{self.prefix}{key}_{n}"


_generator = _Generator()


def generate(key):
    """Next unique name for ``key``: 'fc_0', 'fc_1', ..."""
    return _generator.generate(key)


def switch(new_generator=None):
    """Swap the active generator; returns the previous one."""
    global _generator
    old = _generator
    _generator = new_generator or _Generator()
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    """Fresh naming scope (ref usage: with unique_name.guard(): ...)."""
    if isinstance(new_generator, str):
        new_generator = _Generator(new_generator)
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)
