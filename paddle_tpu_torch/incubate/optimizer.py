"""``LookAhead``, ``ModelAverage`` and ``ExponentialMovingAverage``
(counterpart of ``paddle_tpu/incubate/optimizer.py``; ref: python/paddle/
incubate/optimizer/{lookahead,modelaverage}.py,
fluid/optimizer.py::ExponentialMovingAverage).

Weight-space wrappers around the inner optimizer's step, with the
reference's arithmetic op for op.  A parameter's new weights are copied
into its value in place, so it stays the same autograd leaf and a CUDA
graph that read it sees them; ``apply`` keeps copies of the training
weights, which ``restore`` copies back bit for bit.
"""
from __future__ import annotations

import contextlib

import torch

from ..optimizer.optimizer import Optimizer
from ..tensor.tensor import Tensor


class LookAhead(Optimizer):
    """k fast steps of the inner optimizer, then slow <- slow + alpha *
    (fast - slow) and fast <- slow (Zhang et al. 2019)."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        super().__init__(learning_rate=inner_optimizer._lr,
                         parameters=list(inner_optimizer._parameters))
        self._slow = {id(p): p.value.detach().clone()
                      for p in self._parameters}

    @torch.no_grad()
    def step(self):
        self.inner_optimizer.step()
        self._step_count += 1
        if self._step_count % self.k == 0:
            for p in self._parameters:
                slow = self._slow[id(p)]
                slow = slow + self.alpha * (p.value - slow)
                self._slow[id(p)] = slow
                p.value.copy_(slow)

    def clear_grad(self, set_to_zero=True):
        self.inner_optimizer.clear_grad(set_to_zero)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    def state_dict(self):
        sd = self.inner_optimizer.state_dict()
        sd["lookahead_slow"] = {i: Tensor(v.clone()) for i, v in
                                enumerate(self._slow.values())}
        sd["lookahead_step"] = self._step_count
        return sd


class ModelAverage(Optimizer):
    """A running average of the parameters over a sliding window;
    ``apply()`` swaps the averaged weights in for evaluation, ``restore()``
    the training weights back.  One running (sum, count) with the
    reference's window clamping (it rotates sum_1/2/3 blocks there)."""

    def __init__(self, average_window_rate, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        super().__init__(learning_rate=0.0, parameters=parameters)
        self.rate = float(average_window_rate)
        self.min_window = int(min_average_window)
        self.max_window = int(max_average_window)
        self._sum = {id(p): torch.zeros_like(p.value).detach()
                     for p in self._parameters}
        self._count = 0
        self._backup = None

    @torch.no_grad()
    def step(self):
        self._step_count += 1
        window = max(self.min_window,
                     min(self.max_window,
                         int(self._step_count * self.rate)))
        if self._count >= window:
            # slide: decay the sum, so that old steps wash out
            keep = (window - 1) / window
            for k in self._sum:
                self._sum[k] = self._sum[k] * keep
            self._count = int(self._count * keep)
        for p in self._parameters:
            self._sum[id(p)] = self._sum[id(p)] + p.value
        self._count += 1

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        self.step()
        return None, None

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore=True):
        """The averaged weights in the parameters for the block."""
        _swap_in(self, {k: s / max(self._count, 1)
                        for k, s in self._sum.items()})
        try:
            yield
        finally:
            if need_restore:
                self.restore()

    def restore(self, executor=None):
        _restore(self)


class ExponentialMovingAverage:
    """ref fluid/optimizer.py::ExponentialMovingAverage: the EMA of the
    parameters with Adam-style bias correction (``thres_steps`` is
    accepted and, as in the reference, not applied); ``update()`` after
    each step, ``apply()`` / ``restore()`` around evaluation.  In static
    mode with no ``parameters`` it takes the default main program's."""

    def __init__(self, decay=0.999, thres_steps=None, name=None,
                 parameters=None):
        from ..static.graph import default_main_program, in_static_mode
        if parameters is None and in_static_mode():
            parameters = default_main_program().all_parameters()
        self._decay = float(decay)
        self._parameters = list(parameters or [])
        self._ema = {id(p): torch.zeros_like(p.value).detach()
                     for p in self._parameters}
        self._step = 0
        self._backup = None

    @torch.no_grad()
    def update(self):
        self._step += 1
        d = self._decay
        for p in self._parameters:
            self._ema[id(p)] = d * self._ema[id(p)] + (1 - d) * p.value

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore=True):
        corr = 1.0 - self._decay ** max(self._step, 1)
        _swap_in(self, {k: e / corr for k, e in self._ema.items()})
        try:
            yield
        finally:
            if need_restore:
                self.restore()

    def restore(self, executor=None):
        _restore(self)


@torch.no_grad()
def _swap_in(opt, new):
    """Keep copies of ``opt``'s parameters and copy ``new`` (id -> value)
    into them."""
    opt._backup = {id(p): p.value.detach().clone() for p in opt._parameters}
    for p in opt._parameters:
        p.value.copy_(new[id(p)])


@torch.no_grad()
def _restore(opt):
    if opt._backup is not None:
        for p in opt._parameters:
            p.value.copy_(opt._backup[id(p)])
        opt._backup = None
