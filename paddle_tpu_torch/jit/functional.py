"""Run a stateful Layer as a function of its state (counterpart of
``paddle_tpu/jit/functional.py``).

The reference swaps each Parameter's and buffer's payload for a JAX
tracer and traces the ordinary Python forward.  The port has no tracer:
:func:`functional_call` swaps in the given torch values (the layer's own
by default), runs the forward with the tape off (:func:`trace_mode`), and
reads the buffers back, so a forward that rebinds a buffer (batch norm's
running statistics) hands its new value to :func:`write_back`.
``jit.to_static`` runs a layer through it, eagerly on the CPU and inside
a CUDA graph capture on the card.
"""
from __future__ import annotations

import contextlib
from collections import OrderedDict

import torch

from ..framework import core
from ..tensor.tensor import Tensor


class GraphBreak(RuntimeError):
    """Raised inside a CUDA graph capture by an op that must read a value
    on the host (``Tensor.item`` and the other host reads, ``while_loop``
    on a tensor predicate, ``Print``, ``py_func``, the ops whose output
    size the data sets): ``jit.to_static`` then runs that signature
    eagerly."""


def capturing(value=None):
    """True while a CUDA graph is being captured on the current stream
    (only asked when ``value`` is on the card, if given)."""
    if value is not None and not value.is_cuda:
        return False
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def collect_state(layer):
    """(param_name -> Tensor, buffer_name -> Tensor) in a fixed order."""
    params = OrderedDict(layer.named_parameters())
    buffers = OrderedDict(layer.named_buffers())
    return params, buffers


@contextlib.contextmanager
def trace_mode(rng_key=None):
    """The tape off and the tracing flag on (``core.in_tracing``) for the
    block.  ``rng_key`` is accepted for the reference's signature: the
    port's draws come from the default generator's device streams, which
    a captured graph registers."""
    prev_grad = core.grad_enabled()
    prev_tracing = core.in_tracing()
    core.set_grad_enabled_flag(False)
    core.set_tracing(True)
    try:
        yield
    finally:
        core.set_grad_enabled_flag(prev_grad)
        core.set_tracing(prev_tracing)


@contextlib.contextmanager
def swapped_state(layer, param_vals, buffer_vals):
    """Replace parameter and buffer payloads with the given torch values
    for the block, then restore them; the block may read the buffers'
    new values (a forward can rebind them)."""
    params, buffers = collect_state(layer)
    saved_p = {k: p.value for k, p in params.items()}
    saved_b = {k: b.value for k, b in buffers.items()}
    try:
        for k, p in params.items():
            if k in param_vals:
                p.value = param_vals[k]
        for k, b in buffers.items():
            if k in buffer_vals:
                b.value = buffer_vals[k]
        yield params, buffers
    finally:
        for k, p in params.items():
            p.value = saved_p[k]
        for k, b in buffers.items():
            b.value = saved_b[k]


def _to_tensors(tree):
    """torch values in a tree (tuples, lists, dicts) -> Tensors that stop
    gradients; anything else as it is."""
    if isinstance(tree, torch.Tensor):
        return Tensor(tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_tensors(v) for v in tree)
    if isinstance(tree, dict):
        return {k: _to_tensors(v) for k, v in tree.items()}
    return tree


def _to_vals(tree):
    """Tensors in a tree -> their torch values."""
    if isinstance(tree, Tensor):
        return tree.value
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_vals(v) for v in tree)
    if isinstance(tree, dict):
        return {k: _to_vals(v) for k, v in tree.items()}
    return tree


def functional_call(layer, param_vals, buffer_vals, args, kwargs=None,
                    rng_key=None):
    """Run ``layer(*args, **kwargs)`` with the state swapped in and the
    tape off; ``args`` may be Tensors or torch values (made Tensors).
    Returns (output torch values, new buffer values)."""
    kwargs = kwargs or {}
    with trace_mode(rng_key):
        with swapped_state(layer, param_vals, buffer_vals) as (_, buffers):
            out = layer(*_to_tensors(tuple(args)), **_to_tensors(kwargs))
            new_buffers = {k: b.value for k, b in buffers.items()}
    return _to_vals(out), new_buffers


def param_arrays(layer):
    params, buffers = collect_state(layer)
    return ({k: p.value for k, p in params.items()},
            {k: b.value for k, b in buffers.items()})


def write_back(layer, param_vals=None, buffer_vals=None):
    params, buffers = collect_state(layer)
    if param_vals:
        for k, v in param_vals.items():
            params[k].value = v
    if buffer_vals:
        for k, v in buffer_vals.items():
            buffers[k].value = v
