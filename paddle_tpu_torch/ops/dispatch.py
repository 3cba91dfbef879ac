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

In static mode (``enable_static``) ``call`` also records the op into the
default main program (``static.graph.record_call``, the reference's hook
at ``paddle_tpu/ops/dispatch.py:541``): the function as it ran, with
``auto_cast``'s casts when they applied (and its ``__test_variant__``
cast alike), so a replay keeps the casts that were in force at build.
The op still runs on the build's placeholder values, so shapes and
Python control flow resolve; nothing records on the tape then.

Not ported in this slice: the reference's signature-keyed executable
cache (``_cached_dispatch``), nan guard and profiler hook.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from ..framework import core

# static.graph.record_call while static mode is on (set by
# static.graph._set_static_mode), else None
static_recorder = None


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
    recorder = static_recorder
    record = recorder is None and core.grad_enabled() and any(
        not t.stop_gradient and t.value.is_floating_point()
        for t in _tensors((args, kwargs), Tensor))
    name = _name or getattr(fn, "__name__", "op")
    if core._state.amp_state is not None:
        from ..amp.auto_cast import maybe_autocast_fn
        wrapped = maybe_autocast_fn(fn, name)
        tv = getattr(fn, "__test_variant__", None)
        if tv is not None and wrapped is not fn:
            wrapped.__test_variant__ = maybe_autocast_fn(tv, name)
        fn = wrapped
    with torch.set_grad_enabled(record):
        out = fn(*unwrap(args), **unwrap(kwargs))
    multi = isinstance(out, (tuple, list))
    outs = tuple(_wrap(o, not (record and o.is_floating_point()))
                 for o in (out if multi else (out,)))
    if recorder is not None:
        leaves, spec = pytree.tree_flatten((args, kwargs))
        recorder(fn, leaves, spec, outs, name)
    return outs if multi else outs[0]
