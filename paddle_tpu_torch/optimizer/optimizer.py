"""Optimizer base (counterpart of ``paddle_tpu/optimizer/optimizer.py``).

Each concrete optimizer defines the reference's per-leaf update rule
``_update(p, g, state, lr, t) -> (new_p, new_state)`` over torch values.
``step()`` takes every parameter that trains and has a ``.grad``, clips
(``grad_clip``), adds the coupled weight-decay term (``weight_decay`` or
the parameter's own ``regularizer``; ``_decay_term``), scales the lr by
the parameter's ``optimize_attr["learning_rate"]`` and updates the
parameter and its moments **in place** under ``no_grad``, so each
``Parameter.value`` stays the same autograd leaf.

The reference's default is one compiled update over all parameters
(``_apply_gradients_fused``).  Its counterpart here is one multi-tensor
update a step (``_foreach_update``: ``torch._foreach_*`` over the
parameters of one device and dtype), for SGD, Momentum, Adam and AdamW.
What the reference's executable cache keys on, the parameters' identities,
shapes, dtypes, lr multipliers and decay settings, keys a *plan* here: the
grouping and per-parameter scalars, built once a signature
(``_fused_stats["compiles"]``).  ``_fused_stats["calls"]`` counts fused
steps and ``["eager_steps"]`` steps on the per-leaf path.  A rule that
has no multi-tensor form sets ``_fused_supported = False`` on its class
and takes the per-leaf path; any failure of a fused step raises (there is
no fallback from one path to the other).

``state_dict`` has the reference's keys (``{param name}_{moment}``,
``@step``, ``@param_names``, ``LR_Scheduler``), and ``set_state_dict``
takes Tensors, torch tensors or numpy arrays, so the reference's state,
as numpy, resumes here.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from ..framework import core
from ..tensor.tensor import Parameter, Tensor, _to_torch_value
from .lr import LRScheduler

_fused_stats = {"calls": 0, "compiles": 0, "eager_steps": 0}
_PLAN_CACHE = 8                     # plans kept per optimizer


def reset_fused_stats():
    _fused_stats.update(calls=0, compiles=0, eager_steps=0)


def _bias_correction(beta, t):
    """``1 - beta**t`` in fp32, as the reference computes it."""
    return float(np.float32(1.0) - np.power(np.float32(beta), np.float32(t)))


def _f32(ts):
    return [t if t.dtype == torch.float32 else t.float() for t in ts]


class _Group:
    """The parameters of one device and dtype in a fused step: their
    positions in the step's list, lr multipliers, coupled-decay terms
    (``l2`` / ``l1``: (position in the group, coefficient) lists) and the
    rule's own per-parameter value (``aux``)."""

    def __init__(self):
        self.idx, self.lr_mult, self.aux = [], [], []
        self.l2, self.l1 = [], []


class Optimizer:
    _accum_names: tuple = ()
    _fused_supported = True
    # grads cast to the parameter's dtype before the fused rule (SGD and
    # Momentum, as their per-leaf rules do; Adam's upcasts to fp32 itself)
    _cast_grads = True

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        self._lr = learning_rate
        self._parameters = list(parameters) if parameters is not None else []
        self._grad_clip = grad_clip
        self._weight_decay = weight_decay
        self._accumulators = collections.defaultdict(dict)  # name -> {id: t}
        self._step_count = 0
        self._param_groups = None
        self._param_wd = {}       # id(p) -> the group's weight_decay
        self._plans = {}          # fused signature -> [_Group]
        if self._parameters and isinstance(self._parameters[0], dict):
            self._param_groups = self._parameters
            self._parameters = []
            for g in self._param_groups:
                ps = list(g["params"])
                self._parameters.extend(ps)
                # a group's lr multiplies the base lr (the ParamAttr
                # convention); its weight_decay overrides the global one
                for p in ps:
                    if "learning_rate" in g and isinstance(p, Parameter):
                        p.optimize_attr["learning_rate"] = float(
                            g["learning_rate"])
                    if "weight_decay" in g:
                        self._param_wd[id(p)] = g["weight_decay"]

    # ------------------------------------------------------------------ lr
    def get_lr(self):
        if isinstance(self._lr, LRScheduler):
            return self._lr()
        return float(self._lr)

    def set_lr(self, value):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError(
                "cannot set_lr when the lr is an LRScheduler instance")
        self._lr = float(value)

    @property
    def _learning_rate(self):
        return self._lr

    # ---------------------------------------------------------------- state
    def _state_for(self, p):
        key = id(p)
        states = {}
        for nm in self._accum_names:
            if key not in self._accumulators[nm]:
                self._accumulators[nm][key] = self._init_accumulator(nm, p)
            states[nm] = self._accumulators[nm][key]
        return states

    def _init_accumulator(self, name, p):
        return torch.zeros_like(p.value, requires_grad=False)

    def _update(self, p, g, state, lr, t=1):
        """The per-leaf rule: new value and state of the value ``p`` with
        grad ``g``; ``t`` is the 1-based step count."""
        raise NotImplementedError

    def _update_with_param(self, p, pv, g, state, lr, t):
        """The rule with the Parameter in hand (per-parameter decay of
        AdamW and Lamb)."""
        return self._update(pv, g, state, lr, t)

    # ---------------------------------------------------------- weight decay
    def _decay_reg(self, p):
        """The coupled decay of ``p``: an ``L1Decay`` / ``L2Decay`` or
        ``None``.  Only when the optimizer (or ``p``'s group) has a
        weight decay; then ``p``'s own regularizer wins over it."""
        from ..regularizer import L1Decay, L2Decay
        wd = self._param_wd.get(id(p), self._weight_decay)
        if wd is None:
            return None
        reg = p.regularizer if getattr(p, "regularizer", None) is not None \
            else wd
        if isinstance(reg, (int, float)):
            reg = L2Decay(float(reg))
        return reg if isinstance(reg, (L1Decay, L2Decay)) else None

    def _decay_term(self, p, pv):
        """The coupled weight-decay grad term of ``p`` at value ``pv``, or
        ``None``.  AdamW decouples its decay and returns ``None``."""
        reg = self._decay_reg(p)
        return None if reg is None else reg.grad_term(pv)

    def _apply_decay(self, p, g):
        term = self._decay_term(p, p.value)
        return g if term is None else g + term

    # ---------------------------------------------------------------- step
    @torch.no_grad()
    def step(self):
        params_grads = [(p, p.value.grad) for p in self._parameters
                        if p is not None and not p.stop_gradient
                        and p.value.grad is not None]
        self._apply_gradients(params_grads)

    def _apply_gradients(self, params_grads):
        if self._fused_supported:
            return self._apply_gradients_fused(params_grads)
        _fused_stats["eager_steps"] += 1
        return self._apply_gradients_eager(params_grads)

    def _apply_gradients_eager(self, params_grads):
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        lr_global = self.get_lr()
        self._step_count += 1
        for p, g in params_grads:
            if g is None:
                continue
            g = self._apply_decay(p, g)
            lr = lr_global * _lr_mult(p)
            state = self._state_for(p)
            new_val, new_state = self._update_with_param(
                p, p.value, g, state, lr, self._step_count)
            p.value.copy_(new_val)
            for nm, sv in new_state.items():
                self._accumulators[nm][id(p)].copy_(sv)

    # ------------------------------------------------------- fused step
    def _fused_aux(self, p):
        """A per-parameter value of the rule that the plan keeps (AdamW:
        its decay coefficient)."""
        return None

    def _plan(self, params, grads):
        """The groups of a fused step over ``params``, built once a
        signature."""
        key = tuple(
            (id(p), tuple(p.value.shape), p.value.dtype, p.value.device,
             g.dtype, _lr_mult(p), id(getattr(p, "regularizer", None)),
             id(self._param_wd.get(id(p))), self._fused_aux(p))
            for p, g in zip(params, grads)) + (id(self._weight_decay),)
        plan = self._plans.get(key)
        if plan is not None:
            return plan
        from ..regularizer import L1Decay
        groups = collections.OrderedDict()
        for i, p in enumerate(params):
            grp = groups.setdefault((p.value.device, p.value.dtype),
                                    _Group())
            j = len(grp.idx)
            grp.idx.append(i)
            grp.lr_mult.append(_lr_mult(p))
            grp.aux.append(self._fused_aux(p))
            reg = None if self._decoupled() else \
                self._decay_reg(p)
            if reg is not None:
                (grp.l1 if isinstance(reg, L1Decay) else grp.l2).append(
                    (j, float(reg._coeff)))
        plan = list(groups.values())
        if len(self._plans) >= _PLAN_CACHE:
            self._plans.clear()
        self._plans[key] = plan
        _fused_stats["compiles"] += 1
        return plan

    def _decoupled(self):
        """True when the rule decays inside its update (AdamW), not by a
        grad term."""
        return type(self)._decay_term is not Optimizer._decay_term

    def _apply_gradients_fused(self, params_grads):
        pairs = [(p, g) for p, g in params_grads if g is not None]
        if not pairs:
            self._step_count += 1
            return
        if self._grad_clip is not None:
            pairs = self._grad_clip(pairs)
        params = [p for p, _ in pairs]
        grads = [g for _, g in pairs]
        plan = self._plan(params, grads)
        lr = self.get_lr()
        t = self._step_count + 1
        for grp in plan:
            ps = [params[i] for i in grp.idx]
            pv = [p.value for p in ps]
            gs = [grads[i] for i in grp.idx]
            gs = [g if g.dtype == v.dtype else g.to(v.dtype)
                  for g, v in zip(gs, pv)] if self._cast_grads else gs
            for terms, fn in ((grp.l2, None), (grp.l1, torch._foreach_sign)):
                if terms:
                    js = [j for j, _ in terms]
                    src = [pv[j] for j in js]
                    src = fn(src) if fn is not None else src
                    add = torch._foreach_mul(src, [c for _, c in terms])
                    for j, a in zip(js, add):
                        gs[j] = gs[j] + a
            states = [self._state_for(p) for p in ps]
            st = {nm: [s[nm] for s in states] for nm in self._accum_names}
            self._foreach_update(pv, gs, st, [lr * m for m in grp.lr_mult],
                                 t, grp.aux)
        self._step_count = t
        _fused_stats["calls"] += 1

    def _foreach_update(self, ps, gs, states, lrs, t, aux):
        """The rule over lists, in place: ``ps`` values of one device and
        dtype, ``gs`` their grads, ``states`` {moment: list}, ``lrs``
        their lrs, ``aux`` the plan's per-parameter values."""
        raise NotImplementedError

    # ------------------------------------------------------------ minimize
    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """Backward (unless it ran from ``loss``), step, clear_grad.  In
        static mode: make the default main program a training program
        (its ``train_spec``, which ``static.Executor.run`` differentiates
        and steps with this optimizer), over the program's parameters when
        the optimizer was given none."""
        from ..static import graph
        if graph.in_static_mode():
            prog = graph.default_main_program()
            prog.train_spec = (graph._ensure_var_id(loss, prog), self)
            if not self._parameters:
                self._parameters = prog.all_parameters()
            return None, None
        if loss.value.grad_fn is not None and not loss._backward_ran:
            loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    def clear_grad(self, set_to_zero=True):
        for p in self._parameters:
            if p is not None:
                p.clear_grad()

    clear_gradients = clear_grad

    # ------------------------------------------------------- serialization
    def state_dict(self):
        sd = {}
        name_of = {id(p): p.name for p in self._parameters}
        for nm, d in self._accumulators.items():
            for pid, arr in d.items():
                sd[f"{name_of.get(pid, str(pid))}_{nm}"] = Tensor(arr.clone())
        sd["@step"] = self._step_count
        sd["@param_names"] = [p.name for p in self._parameters]
        if isinstance(self._lr, LRScheduler):
            sd["LR_Scheduler"] = self._lr.state_dict()
        return sd

    def set_state_dict(self, state_dict):
        """Load ``state_dict`` (this class's or the reference's, moments as
        Tensors, torch tensors or numpy arrays).  Moments are found by the
        saved parameter names, position by position, then by the current
        names, as the reference does."""
        self._step_count = int(state_dict.get("@step", 0))
        if "LR_Scheduler" in state_dict and isinstance(self._lr, LRScheduler):
            self._lr.set_state_dict(dict(state_dict["LR_Scheduler"]))
        saved_names = state_dict.get("@param_names")
        for i, p in enumerate(self._parameters):
            names = []
            if saved_names is not None and i < len(saved_names):
                names.append(saved_names[i])
            names.append(p.name)
            for nm in self._accum_names:
                for lname in names:
                    v = state_dict.get(f"{lname}_{nm}")
                    if v is not None:
                        self._accumulators[nm][id(p)] = _to_torch_value(
                            v, None, core.place_of(p.value.device)).clone()
                        break

    set_dict = set_state_dict


def _lr_mult(p):
    if isinstance(p, Parameter):
        return float(p.optimize_attr.get("learning_rate", 1.0))
    return 1.0
