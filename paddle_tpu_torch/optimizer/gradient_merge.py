"""Gradient merge (accumulation) around any optimizer (counterpart of
``paddle_tpu/optimizer/gradient_merge.py``; ref: python/paddle/
distributed/fleet/meta_optimizers/gradient_merge_optimizer.py).

Every ``step()`` adds the parameters' current grads into one accumulator
a parameter, in place with one multi-tensor add (``torch._foreach_add_``)
for the whole list, and clears them; each ``k_steps``-th call scales the
sums by 1/k (``avg``) and hands them to the inner optimizer's ``step``.
Nothing reads a value on the host.  A parameter listed twice (tied) is
harvested once.  In static mode ``minimize`` warns, as the reference
does: the Executor applies a full update every run there.
"""
from __future__ import annotations

import warnings

import torch


def _grad(p):
    leaf = p._leaf_value()
    return None if leaf is None else leaf.grad


def _set_grad(p, g):
    leaf = p._leaf_value()
    if leaf is not None:
        leaf.grad = g


class GradientMergeOptimizer:
    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        self._inner = inner_optimizer
        self._k = int(k_steps)
        self._avg = bool(avg)
        self._acc = {}          # id(param) -> accumulated grad
        self._micro = 0

    @property
    def _parameters(self):
        return self._inner._parameters

    @torch.no_grad()
    def step(self):
        self._micro += 1
        accs, gs = [], []
        for p in self._inner._parameters:
            g = None if p is None else _grad(p)
            if g is None:
                continue
            acc = self._acc.get(id(p))
            if acc is None:
                self._acc[id(p)] = g          # the first grad is the sum
            else:
                accs.append(acc)
                gs.append(g)
            _set_grad(p, None)  # micro-step grads never reach the inner opt
        if accs:
            torch._foreach_add_(accs, gs)
        if self._micro % self._k:
            return
        with_acc, seen = [], set()
        for p in self._inner._parameters:
            if p is not None and id(p) in self._acc and id(p) not in seen:
                with_acc.append(p)
                seen.add(id(p))
        accs = [self._acc.pop(id(p)) for p in with_acc]
        if accs and self._avg and self._k != 1:
            torch._foreach_mul_(accs, 1.0 / self._k)
        for p, a in zip(with_acc, accs):
            _set_grad(p, a)
        self._inner.step()
        for p in self._inner._parameters:
            if p is not None:
                _set_grad(p, None)

    def clear_grad(self, set_to_zero=False):
        for p in self._inner._parameters:
            if p is not None:
                _set_grad(p, None)

    def minimize(self, loss, **kwargs):
        from ..static.graph import in_static_mode
        if in_static_mode():
            if self._k > 1:
                warnings.warn(
                    "GradientMergeOptimizer on the static Executor path "
                    f"applies a FULL update every run (k_steps={self._k} "
                    "is not accumulated there); feed k_steps micro-"
                    "batches per logical step yourself or use the "
                    "dygraph/hapi accumulation paths",
                    UserWarning, stacklevel=2)
            return self._inner.minimize(loss, **kwargs)
        if not any(p is not None and _grad(p) is not None
                   for p in self._inner._parameters):
            loss.backward()
        self.step()

    def __getattr__(self, name):
        if name == "_inner":         # before __init__ ran
            raise AttributeError(name)
        return getattr(self._inner, name)
