"""Static-graph backward API (counterpart of
``paddle_tpu/static/backward.py``): ``append_backward`` and ``gradients``
build no reverse graph.  Each returns grad variables, placeholders the
Executor evaluates at fetch time by differentiating the replay with torch
autograd (``graph.Executor._fetch``); the cut replay
(``Program.replay_cut``) makes intermediates differentiable targets
too."""
from __future__ import annotations

import torch

from ..tensor.tensor import Tensor
from .graph import _ensure_var_id, default_main_program


def _mint_grad_var(program, target, wrt, seed=None):
    tgt_id = _ensure_var_id(target, program)
    wrt_id = _ensure_var_id(wrt, program)
    g = Tensor(torch.zeros_like(wrt.value, requires_grad=False),
               stop_gradient=True,
               name=(wrt.name or f"var_{wrt_id}") + "@GRAD")
    gid = _ensure_var_id(g, program)
    if seed is not None:
        seed = seed.value if isinstance(seed, Tensor) else torch.as_tensor(
            seed)
    program.grad_map[gid] = (tgt_id, wrt_id, seed)
    return g


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """[(parameter, grad var)] for every parameter that trains (of the
    program, or ``parameter_list``) outside ``no_grad_set``."""
    program = default_main_program()
    if parameter_list is None:
        parameter_list = [program.params[i] for i in sorted(program.params)]
    no_grad = {id(v) for v in (no_grad_set or ())}
    return [(p, _mint_grad_var(program, loss, p)) for p in parameter_list
            if id(p) not in no_grad and getattr(p, "trainable", True)]


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """d(target)/d(input) for each input (``None`` for one in
    ``no_grad_set``); a non-scalar target is seeded with
    ``target_gradients`` (default ones: the grad of its sum).  One target
    only, as the reference."""
    program = default_main_program()
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    if target_gradients is None:
        target_gradients = [None] * len(targets)
    elif not isinstance(target_gradients, (list, tuple)):
        target_gradients = [target_gradients]
    if len(targets) != 1:
        raise NotImplementedError(
            "multiple targets: call gradients once per target and add_n")
    no_grad = {id(v) for v in (no_grad_set or ())}
    return [None if id(x) in no_grad
            else _mint_grad_var(program, targets[0], x, target_gradients[0])
            for x in inputs]
