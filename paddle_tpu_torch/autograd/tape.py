"""The eager tape (counterpart of ``paddle_tpu/autograd/tape.py``): the
grad-mode switches, ``backward``, ``grad`` and the grad-hook plumbing.

The grad-mode switches flip :mod:`..framework.core`'s flag, which is
torch's grad mode, so ``paddle_tpu_torch.no_grad`` and ``torch.no_grad``
are one switch.  The reference records one ``Node`` a dispatched op and
walks them itself; here every op that records (``ops.dispatch.call``)
builds torch's autograd graph, and that graph is the tape: ``backward``
and ``grad`` run torch autograd over it.  What the reference adds on top
is kept: a hook fires once with a tensor's complete grad of one backward
(``apply_grad_hooks``, on a snapshot of the hooks), a backward from a
tensor with ``stop_gradient=True`` and no graph raises, so does a second
backward through a graph freed by the first, ``grad`` leaves ``.grad``
alone and names an unused input, and callbacks queued during a backward
(``queue_backward_end_callback``) run once the outermost pass ends, or
are dropped if it fails.
"""
from __future__ import annotations

import functools
from typing import List

import torch

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


def apply_grad_hooks(hooks, g):
    """Fire grad hooks over the torch value ``g``, on a snapshot (a hook
    that removes itself does not skip its neighbour); a return that is
    not ``None`` replaces the grad."""
    from ..tensor.tensor import Tensor

    for hook in tuple(hooks):
        out = hook(Tensor(g))
        if out is not None:
            g = out.value if isinstance(out, Tensor) else out
    return g


# Callbacks queued during a backward pass (e.g. by grad hooks) that run
# once the outermost pass ends; an aborted pass drops them unrun.
_backward_end_callbacks: List = []
# depth of ``grad`` (watch-mode) passes in flight, and of every pass
_watch_depth = [0]
_backward_depth = [0]


def in_watch_backward() -> bool:
    return _watch_depth[0] > 0


def queue_backward_end_callback(fn):
    _backward_end_callbacks.append(fn)


def _drain_backward_end_callbacks(run):
    try:
        if run:
            while _backward_end_callbacks:
                _backward_end_callbacks.pop(0)()
    finally:
        del _backward_end_callbacks[:]


def _run(fn, watch):
    """Run one reverse pass ``fn()`` inside the depth counters."""
    if watch:
        _watch_depth[0] += 1
    _backward_depth[0] += 1
    try:
        out = fn()
    except BaseException:
        if _backward_depth[0] == 1:
            _drain_backward_end_callbacks(run=False)
        raise
    finally:
        _backward_depth[0] -= 1
        if watch:
            _watch_depth[0] -= 1
    if _backward_depth[0] == 0:
        _drain_backward_end_callbacks(run=True)
    return out


def _seed(tensor, grad):
    """The output grad of ``tensor``'s backward as a torch value: ones
    for ``None``."""
    from ..tensor.tensor import Tensor
    if grad is None:
        return torch.ones_like(tensor.value)
    return grad.value if isinstance(grad, Tensor) else torch.as_tensor(
        grad, dtype=tensor.value.dtype, device=tensor.value.device)


# ``Tensor._backward_ran``: no backward from it yet, one that kept the
# graph, one that freed it
_NOT_RUN, _RETAINED, _FREED = 0, 1, 2


def backward(tensor, grad=None, retain_graph: bool = False):
    """Accumulate the grads of ``tensor`` into the ``.grad`` of every leaf
    it reaches.  ``grad`` is the output grad (default ones)."""
    if tensor.value.grad_fn is None:
        if tensor.stop_gradient:
            raise RuntimeError(
                "Tensor.backward() called on a tensor with stop_gradient=True "
                "and no graph")
        return
    if tensor._backward_ran == _FREED:
        raise RuntimeError(
            "Trying to backward through the graph a second time. Pass "
            "retain_graph=True to the first .backward() if you need to "
            "backward twice.")
    g = _seed(tensor, grad)
    _run(lambda: torch.autograd.backward(tensor.value, g,
                                         retain_graph=retain_graph), False)
    tensor._backward_ran = _RETAINED if retain_graph else _FREED


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """paddle.grad: the grads of ``outputs`` with respect to ``inputs``
    (leaves or intermediates), as Tensors; ``.grad`` is left as it was.
    The graph is kept unless ``retain_graph`` is False.  With
    ``create_graph`` the results carry a graph of their own (double
    backward)."""
    from ..tensor.tensor import Tensor

    if isinstance(outputs, Tensor):
        outputs = [outputs]
    if isinstance(inputs, Tensor):
        inputs = [inputs]
    if grad_outputs is None:
        grad_outputs = [None] * len(outputs)
    elif isinstance(grad_outputs, Tensor):
        grad_outputs = [grad_outputs]
    pairs = [(o, go) for o, go in zip(outputs, grad_outputs)
             if o.value.grad_fn is not None]
    retain = True if retain_graph is None else retain_graph
    if pairs:
        # a tensor rebound by an in-place API gets the sum of the grads
        # of every value it held, as the reference's tape gives it
        edges = [(i, e) for i, t in enumerate(inputs)
                 for e in (t.value, *t._past)]
        flat = _run(lambda: torch.autograd.grad(
            [o.value for o, _ in pairs], [e for _, e in edges],
            [_seed(o, go) for o, go in pairs], retain_graph=retain,
            create_graph=create_graph, allow_unused=True), True)
        gs = [None] * len(inputs)
        for (i, _), g in zip(edges, flat):
            if g is not None:
                gs[i] = g if gs[i] is None else gs[i] + g
    else:
        gs = [None] * len(inputs)
    if any(g is None for g in gs) and not allow_unused:
        raise RuntimeError(
            "paddle.grad: one of the inputs is unused in the graph of "
            "outputs (no gradient path); pass allow_unused=True to get None "
            "for it instead")
    return [None if g is None else Tensor(g, stop_gradient=not create_graph)
            for g in gs]
