# Copied from paddle_tpu/compat.py (py2/py3 text helpers, stdlib only), code unchanged; the port keeps its own copy so it never imports paddle_tpu.
"""paddle.compat (ref: python/paddle/compat.py) — py2/py3 text helpers
the fluid era shipped; still imported by reference-era utilities."""
from __future__ import annotations

__all__ = ["to_text", "to_bytes", "long_type", "get_exception_message",
           "floor_division", "round"]

import builtins
import math

long_type = int


def _to_text(obj, encoding):
    if obj is None:
        return obj
    if isinstance(obj, bytes):
        return obj.decode(encoding)
    if isinstance(obj, str):
        return obj
    return str(obj)


def to_text(obj, encoding="utf-8", inplace=False):
    if isinstance(obj, list):
        if inplace:
            obj[:] = [_to_text(o, encoding) for o in obj]
            return obj
        return [_to_text(o, encoding) for o in obj]
    if isinstance(obj, set):
        if inplace:
            vals = [_to_text(o, encoding) for o in obj]
            obj.clear()
            obj.update(vals)
            return obj
        return {_to_text(o, encoding) for o in obj}
    return _to_text(obj, encoding)


def _to_bytes(obj, encoding):
    if obj is None:
        return obj
    if isinstance(obj, str):
        return obj.encode(encoding)
    if isinstance(obj, bytes):
        return obj
    return str(obj).encode(encoding)


def to_bytes(obj, encoding="utf-8", inplace=False):
    if isinstance(obj, list):
        if inplace:
            obj[:] = [_to_bytes(o, encoding) for o in obj]
            return obj
        return [_to_bytes(o, encoding) for o in obj]
    if isinstance(obj, set):
        if inplace:
            vals = [_to_bytes(o, encoding) for o in obj]
            obj.clear()
            obj.update(vals)
            return obj
        return {_to_bytes(o, encoding) for o in obj}
    return _to_bytes(obj, encoding)


def get_exception_message(exc):
    return str(exc)


def floor_division(x, y):
    return x // y


def round(x, d=0):                          # noqa: A001
    return builtins.round(x, d) if d else float(math.floor(x + 0.5)) \
        if x >= 0 else float(math.ceil(x - 0.5))
