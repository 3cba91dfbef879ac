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

Two hooks run when they are on, one flag test each when they are off:
the nan guard (``debug.enable_check_nan_inf``) checks the op's floating
outputs after it runs (``debug._assert_finite_eager``), and the profiler
(``profiler.start_profiler``) records the op's host time under its name
(``profiler.record_op``), as the reference's ``call`` does.  During a
CUDA graph capture the guard writes device flags instead of syncing, and
the profiler records nothing: a replay is one event (``jit.to_static``).

The reference's signature-keyed executable cache (``_cached_dispatch``)
exists to avoid a JAX trace per eager op, which torch's eager mode does
not have.  Its counterpart in the port is ``jit.to_static``'s cache of
CUDA graphs, one per input signature; :func:`cache_stats` keeps the
reference's keys with that meaning: ``misses`` are captures, ``hits``
replays, ``warming`` the eager warm-up runs before a capture,
``fallbacks`` calls that cannot be captured and run eagerly on the card,
``evictions`` graphs dropped by the bound, ``size`` the graphs held and
``blacklisted`` the signatures found uncapturable.
"""
from __future__ import annotations

import time
import weakref

import torch
from torch.utils import _pytree as pytree

from ..framework import core

# static.graph.record_call while static mode is on (set by
# static.graph._set_static_mode), else None
static_recorder = None
# the hooks: set by debug.enable_check_nan_inf and profiler.start_profiler
nan_guard = False
profiling = False

_STAT_KEYS = ("hits", "misses", "fallbacks", "warming", "evictions")
_stats = dict.fromkeys(_STAT_KEYS, 0)
# every live to_static wrapper (jit.api.TracedLayer), for size and clear
_graph_caches = weakref.WeakSet()


def cache_enabled():
    """Does ``jit.to_static`` use its graph cache?  The one switch is
    ``jit.ProgramTranslator().enable``; off, a ``to_static`` call is the
    plain eager call, on the tape, and counts nothing."""
    from ..jit.api import ProgramTranslator
    return ProgramTranslator.get_instance().enable_to_static


def cache_stats():
    """The counters of ``jit.to_static``'s graph cache (module
    docstring), with ``size`` and ``blacklisted`` computed live."""
    out = dict(_stats)
    caches = list(_graph_caches)
    out["size"] = sum(len(c._graphs) for c in caches)
    out["blacklisted"] = sum(len(c._uncapturable) for c in caches)
    return out


def reset_cache_stats():
    _stats.update(dict.fromkeys(_STAT_KEYS, 0))


def clear_cache(blacklist=False):
    """Drop every captured graph (called on static-mode flips);
    ``blacklist`` also forgets the signatures found uncapturable."""
    for c in list(_graph_caches):
        c._graphs.clear()
        if blacklist:
            c._uncapturable.clear()


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
    t0 = time.perf_counter() if profiling else None
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
    if record == torch.is_grad_enabled():
        # no switch: ``torch.export`` records each one as a graph split
        out = fn(*unwrap(args), **unwrap(kwargs))
    else:
        with torch.set_grad_enabled(record):
            out = fn(*unwrap(args), **unwrap(kwargs))
    multi = isinstance(out, (tuple, list))
    if nan_guard:
        from .. import debug
        debug._assert_finite_eager(name, out if multi else (out,))
    outs = tuple(_wrap(o, not (record and o.is_floating_point()))
                 for o in (out if multi else (out,)))
    if recorder is not None:
        leaves, spec = pytree.tree_flatten((args, kwargs))
        recorder(fn, leaves, spec, outs, name)
    if t0 is not None:
        from .. import profiler
        profiler._record_dispatch(name, t0)
    return outs if multi else outs[0]
