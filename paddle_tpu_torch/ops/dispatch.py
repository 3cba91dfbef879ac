"""Primitive dispatch: every eager op of the nn API flows through
:func:`call` (counterpart of ``paddle_tpu/ops/dispatch.py`` ``call``,
``_wrap``; ``unwrap`` is new).

``call`` unwraps Tensors to their torch values, runs the function on
them, and wraps the outputs.  An op records when grad mode is on and a
floating input Tensor has ``stop_gradient`` False, as in the reference;
its floating outputs then have ``stop_gradient`` False and carry torch's
graph, which is the eager tape (``autograd/tape.py``).  An op that does
not record runs with torch's grad mode off.

``_name`` is the op's name (default: the function's ``__name__``).
Inside ``amp.auto_cast`` the op runs through
:func:`..amp.auto_cast.maybe_autocast_fn` under that name, so the white
and black lists pick the same ops as the reference's, and the cast runs
inside the op: autograd casts the gradients back to the inputs' dtypes.

Not ported in this slice: the reference's signature-keyed executable
cache (``_cached_dispatch``), nan guard, static-graph recording and
profiler hook.
"""
from __future__ import annotations

import torch

from ..framework import core


def _tensor_cls():
    from ..tensor.tensor import Tensor
    return Tensor


def unwrap(x):
    """Tensors, also inside lists, tuples and dicts -> their torch
    values; anything else as it is."""
    Tensor = _tensor_cls()
    if isinstance(x, Tensor):
        return x.value
    if isinstance(x, (list, tuple)):
        return type(x)(unwrap(v) for v in x)
    if isinstance(x, dict):
        return {k: unwrap(v) for k, v in x.items()}
    return x


def _tensors(x, Tensor):
    if isinstance(x, Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v, Tensor)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v, Tensor)


def _wrap(val, stop_gradient=True):
    Tensor = _tensor_cls()
    return Tensor(val, stop_gradient=stop_gradient)


def call(fn, *args, _name=None, **kwargs):
    """Apply ``fn`` to args that may hold Tensors.  Returns a Tensor, or a
    tuple of Tensors for a tuple or list of outputs."""
    Tensor = _tensor_cls()
    record = core.grad_enabled() and any(
        not t.stop_gradient and t.value.is_floating_point()
        for t in _tensors((args, kwargs), Tensor))
    if core._state.amp_state is not None:
        from ..amp.auto_cast import maybe_autocast_fn
        fn = maybe_autocast_fn(fn, _name or getattr(fn, "__name__", "op"))
    with torch.set_grad_enabled(record):
        out = fn(*unwrap(args), **unwrap(kwargs))
    if isinstance(out, (tuple, list)):
        return tuple(_wrap(o, not (record and o.is_floating_point()))
                     for o in out)
    return _wrap(out, not (record and out.is_floating_point()))
