"""Failure detection: nan/inf guards (counterpart of
``paddle_tpu/debug.py``).

In eager mode the dispatch-level guard (:func:`enable_check_nan_inf`)
checks every op's floating outputs and raises :class:`NanInfError` with
the op's name, its nan and inf counts and the output's shape at the first
non-finite value; it syncs with the host, as the reference's does in
debug mode.  :func:`check_numerics` checks a tree of values at one point
of a computation.

Inside a CUDA graph capture (``jit.to_static`` on the card) nothing may
sync with the host.  There both checks write a **device flag** instead:
each check made during the capture adds one slot (an op's nan and inf
counts, or one bool) to the capture's list (:func:`capture_flags`), the
graph writes the slots at every replay, and the ``to_static`` call that
replayed it reads them after the replay and raises
:class:`NanInfError` for the first slot, in the order of the checks,
that saw a non-finite value (:func:`raise_flags`).  The reference skips
traced values in the eager guard and checks jitted steps with a
device-side callback instead.

``cond`` under ``to_static`` on the card computes both branches and
selects one on the device; each branch runs under :func:`masked_flags`,
so only the selected branch's checks can raise, as only the taken
branch of the reference's ``lax.cond`` runs its checks.
"""
from __future__ import annotations

import contextlib

import torch

from .framework import core

_enabled = False
# the flag list of the capture in progress, else None (set by
# capture_flags): (kind, tensor, message) with kind "counts" (an op's
# [nan, inf] counts; the message holds its name, shape and dtype) or
# "bool" (check_numerics' verdict)
_capture = None
# the flag list of the innermost masked_flags block, else None
_pending = None


def enable_check_nan_inf(flag=True):
    """Process-wide eager guard (FLAGS_check_nan_inf analogue)."""
    global _enabled
    _enabled = bool(flag)
    from .ops import dispatch
    dispatch.nan_guard = _enabled


def check_nan_inf_enabled():
    return _enabled


@contextlib.contextmanager
def check_nan_inf_guard():
    """Scoped version of :func:`enable_check_nan_inf`."""
    prev = _enabled
    enable_check_nan_inf(True)
    try:
        yield
    finally:
        enable_check_nan_inf(prev)


class NanInfError(FloatingPointError):
    pass


def _message(opname, n_nan, n_inf, shape, dtype):
    return (f"op '{opname}' produced non-finite values (nan={n_nan}, "
            f"inf={n_inf}, shape={tuple(shape)}, dtype={dtype})")


def _inexact(v):
    return isinstance(v, torch.Tensor) and (v.is_floating_point()
                                            or v.is_complex())


def _assert_finite_eager(opname, vals):
    """Called from dispatch when the guard is on: raises at the first
    floating output with a nan or inf (a host sync).  During a graph
    capture it adds a device flag instead (:func:`capture_flags`)."""
    from .jit.functional import capturing
    for v in vals:
        if not _inexact(v):
            continue
        if _pending is not None:
            _pending.append(("counts", _counts(v), (
                opname, tuple(v.shape), core.dtype_name(v.dtype))))
            continue
        if capturing(v):
            if _capture is not None:
                _capture.append(("counts", _counts(v), (
                    opname, tuple(v.shape), core.dtype_name(v.dtype))))
            continue
        if not bool(torch.isfinite(v).all()):
            raise NanInfError(_message(
                opname, int(torch.isnan(v).sum()), int(torch.isinf(v).sum()),
                v.shape, core.dtype_name(v.dtype)))


def _counts(v):
    return torch.stack([torch.isnan(v).sum(), torch.isinf(v).sum()])


def _leaves(tree):
    from .tensor.tensor import Tensor
    if isinstance(tree, Tensor):
        return [tree.value]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


def check_numerics(tree, message="check_numerics"):
    """Passes ``tree`` through unchanged after checking that every
    floating leaf is finite: raises :class:`NanInfError` now in eager
    mode, or, inside a graph capture, at the ``to_static`` call that
    replays the graph (a device flag, no host sync)."""
    from .jit.functional import capturing
    leaves = [v for v in _leaves(tree) if _inexact(v)]
    if not leaves:
        return tree
    if _pending is not None or capturing(leaves[0]):
        dest = _pending if _pending is not None else _capture
        if dest is not None:
            bad = torch.stack([~torch.isfinite(v).all() for v in leaves]
                              ).any()
            dest.append(("bool", bad, message))
        return tree
    if not all(bool(torch.isfinite(v).all()) for v in leaves):
        raise NanInfError(message + ": non-finite value detected")
    return tree


def finite_mask(tree):
    """A 0-d bool tensor: every floating leaf of ``tree`` is finite (the
    grad scaler's found_inf test; no host sync)."""
    from .tensor.tensor import Tensor
    leaves = [v for v in _leaves(tree) if _inexact(v)]
    if not leaves:
        return Tensor(torch.ones((), dtype=torch.bool))
    return Tensor(torch.stack([torch.isfinite(v).all() for v in leaves]
                              ).all())


@contextlib.contextmanager
def capture_flags():
    """Collect the device flags the checks made during a graph capture;
    yields the list, which the capturer keeps with its graph."""
    global _capture
    prev, _capture = _capture, []
    try:
        yield _capture
    finally:
        _capture = prev


@contextlib.contextmanager
def masked_flags(mask):
    """The checks in the block write flags that count only where
    ``mask`` (a 0-d bool tensor on the card) holds.  On leaving, the
    masked flags join the enclosing block's or the capture's list; in an
    eager run (``to_static``'s warm-up) they are read and raised at once.
    Nothing is checked on the host inside the block."""
    from .jit.functional import capturing
    global _pending
    outer, _pending = _pending, []
    try:
        yield
    finally:
        inner, _pending = _pending, outer
    m = mask.reshape(())
    masked = [(k, f * m if k == "counts" else f & m, msg)
              for k, f, msg in inner]
    if outer is not None:
        outer.extend(masked)
    elif capturing(m):
        if _capture is not None:
            _capture.extend(masked)
    else:
        raise_flags(masked)


def raise_flags(flags):
    """After a replay: raise :class:`NanInfError` for the first flag that
    saw a non-finite value (one host read for all of them)."""
    if not flags:
        return
    vals = torch.cat([f.reshape(-1).to(torch.int64) for _, f, _ in flags]
                     ).cpu().tolist()
    i = 0
    for kind, _, msg in flags:
        if kind == "counts":
            n_nan, n_inf = vals[i], vals[i + 1]
            i += 2
            if n_nan or n_inf:
                raise NanInfError(_message(msg[0], n_nan, n_inf, msg[1],
                                           msg[2]))
        else:
            i += 1
            if vals[i - 1]:
                raise NanInfError(msg + ": non-finite value detected")
