"""Concrete optimizers (counterpart of ``paddle_tpu/optimizer/optimizers.py``):
the reference's update rules over torch values.

SGD, Momentum, Adam and AdamW also have a multi-tensor form
(``_foreach_update``), which ``step()`` runs: one ``torch._foreach_*``
sequence over the parameters of a device and dtype, in the reference
rule's order of operations.  Adagrad, Adadelta, Adamax, RMSProp, Lamb,
DecayedAdagrad, Ftrl, Dpsgd and LarsMomentum run their per-leaf rule
(``_fused_supported = False``).  Dpsgd's noise comes from a
``torch.Generator`` seeded from (seed, step, parameter), where the
reference folds the same three into a JAX key: the numbers differ, the
distribution is the same.
"""
from __future__ import annotations

import torch

from .optimizer import Optimizer, _bias_correction, _f32


def _scalar(x):
    """A Tensor hyperparameter (kept live, as the reference's) as a
    float."""
    return float(x) if hasattr(x, "numpy") else x


class SGD(Optimizer):
    _accum_names = ()

    def _update(self, p, g, state, lr, t=1):
        return p - lr * g.to(p.dtype), {}

    def _foreach_update(self, ps, gs, states, lrs, t, aux):
        torch._foreach_sub_(ps, torch._foreach_mul(gs, lrs))


class Momentum(Optimizer):
    _accum_names = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _update(self, p, g, state, lr, t=1):
        g = g.to(p.dtype)
        v = self._momentum * state["velocity"] + g
        if self._nesterov:
            new_p = p - lr * (g + self._momentum * v)
        else:
            new_p = p - lr * v
        return new_p, {"velocity": v}

    def _foreach_update(self, ps, gs, states, lrs, t, aux):
        v = states["velocity"]
        torch._foreach_mul_(v, self._momentum)
        torch._foreach_add_(v, gs)
        if self._nesterov:
            step = torch._foreach_mul(v, self._momentum)
            torch._foreach_add_(step, gs)
            torch._foreach_mul_(step, lrs)
        else:
            step = torch._foreach_mul(v, lrs)
        torch._foreach_sub_(ps, step)


class Adagrad(Optimizer):
    _accum_names = ("moment",)
    _fused_supported = False

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._init_val = initial_accumulator_value

    def _init_accumulator(self, name, p):
        return torch.full_like(p.value, self._init_val, requires_grad=False)

    def _update(self, p, g, state, lr, t=1):
        g = g.to(p.dtype)
        m = state["moment"] + g * g
        return p - lr * g / (torch.sqrt(m) + self._epsilon), {"moment": m}


class Adadelta(Optimizer):
    _accum_names = ("avg_squared_grad", "avg_squared_update")
    _fused_supported = False

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._rho = rho

    def _update(self, p, g, state, lr, t=1):
        g = g.to(p.dtype)
        eg = self._rho * state["avg_squared_grad"] + (1 - self._rho) * g * g
        dx = (torch.sqrt(state["avg_squared_update"] + self._epsilon)
              / torch.sqrt(eg + self._epsilon)) * g
        eu = (self._rho * state["avg_squared_update"]
              + (1 - self._rho) * dx * dx)
        return p - lr * dx, {"avg_squared_grad": eg,
                             "avg_squared_update": eu}


class Adam(Optimizer):
    _accum_names = ("moment1", "moment2")
    _cast_grads = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1_src = beta1
        self._beta2_src = beta2
        self._epsilon = _scalar(epsilon)

    @property
    def _beta1(self):
        return _scalar(self._beta1_src)

    @property
    def _beta2(self):
        return _scalar(self._beta2_src)

    def _init_accumulator(self, name, p):
        return torch.zeros(p.value.shape, dtype=torch.float32,
                           device=p.value.device)

    def _update(self, p, g, state, lr, t=1):
        b1, b2 = self._beta1, self._beta2
        gf, pf = g.float(), p.float()
        m = b1 * state["moment1"] + (1 - b1) * gf
        v = b2 * state["moment2"] + (1 - b2) * gf * gf
        mhat = m / _bias_correction(b1, t)
        vhat = v / _bias_correction(b2, t)
        new_p = pf - lr * mhat / (torch.sqrt(vhat) + self._epsilon)
        return new_p.to(p.dtype), {"moment1": m, "moment2": v}

    def _foreach_update(self, ps, gs, states, lrs, t, aux):
        b1, b2 = self._beta1, self._beta2
        low = ps[0].dtype != torch.float32
        pf = _f32(ps)
        gf = _f32(gs)
        # decoupled decay reads the value before the update
        decay = self._foreach_decay(pf, lrs, aux)
        m, v = states["moment1"], states["moment2"]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(gf, 1 - b1))
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, torch._foreach_mul(
            torch._foreach_mul(gf, 1 - b2), gf))
        denom = torch._foreach_div(v, _bias_correction(b2, t))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self._epsilon)
        upd = torch._foreach_div(m, _bias_correction(b1, t))
        torch._foreach_mul_(upd, lrs)
        torch._foreach_div_(upd, denom)
        torch._foreach_sub_(pf, upd)
        if decay is not None:
            torch._foreach_sub_([pf[j] for j in decay[0]], decay[1])
        if low:
            torch._foreach_copy_(ps, pf)

    def _foreach_decay(self, pf, lrs, aux):
        """Decoupled decay: (positions, the amounts to subtract) or
        ``None``."""
        return None


class AdamW(Adam):
    """Decoupled weight decay (ref ``paddle_tpu/optimizer/optimizers.py``
    ``AdamW``): ``p -= lr * coeff * p`` after the Adam step, with ``p``
    read before it."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip)
        # numeric 0 disables decay; only an omitted value means 0.01
        self._coeff = 0.01 if weight_decay is None else _scalar(weight_decay)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decay_term(self, p, pv):
        return None  # decoupled: applied inside _update

    def _coeff_of(self, p):
        """``p``'s decay coefficient: 0 where ``apply_decay_param_fun``
        says no, its group's ``weight_decay`` where it has one."""
        if p is None:
            return self._coeff
        if (self._apply_decay_param_fun is not None
                and not self._apply_decay_param_fun(p.name)):
            return 0.0
        wd = self._param_wd.get(id(p))
        return float(wd) if isinstance(wd, (int, float)) else self._coeff

    def _update(self, p, g, state, lr, t=1, coeff=None):
        decay = self._coeff if coeff is None else coeff
        pf = p.float()
        new_p, new_state = super()._update(p, g, state, lr, t)
        if decay:
            new_p = new_p.float() - lr * decay * pf
        return new_p.to(p.dtype), new_state

    def _update_with_param(self, p, pv, g, state, lr, t):
        return self._update(pv, g, state, lr, t, self._coeff_of(p))

    def _fused_aux(self, p):
        return self._coeff_of(p)

    def _foreach_decay(self, pf, lrs, aux):
        js = [j for j, c in enumerate(aux) if c]
        if not js:
            return None
        return js, torch._foreach_mul([pf[j] for j in js],
                                      [lrs[j] * aux[j] for j in js])


class Adamax(Optimizer):
    _accum_names = ("moment", "inf_norm")
    _fused_supported = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _update(self, p, g, state, lr, t=1):
        g = g.to(p.dtype)
        m = self._beta1 * state["moment"] + (1 - self._beta1) * g
        u = torch.maximum(self._beta2 * state["inf_norm"], torch.abs(g))
        new_p = p - (lr / _bias_correction(self._beta1, t)) * m \
            / (u + self._epsilon)
        return new_p, {"moment": m, "inf_norm": u}


class RMSProp(Optimizer):
    _accum_names = ("mean_square", "mean_grad", "momentum_acc")
    _fused_supported = False

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _update(self, p, g, state, lr, t=1):
        g = g.to(p.dtype)
        ms = self._rho * state["mean_square"] + (1 - self._rho) * g * g
        if self._centered:
            mg = self._rho * state["mean_grad"] + (1 - self._rho) * g
            denom = torch.sqrt(ms - mg * mg + self._epsilon)
        else:
            mg = state["mean_grad"]
            denom = torch.sqrt(ms + self._epsilon)
        mom = self._momentum * state["momentum_acc"] + lr * g / denom
        return p - mom, {"mean_square": ms, "mean_grad": mg,
                         "momentum_acc": mom}


class Lamb(Optimizer):
    _accum_names = ("moment1", "moment2")
    _fused_supported = False

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_accumulator(self, name, p):
        return torch.zeros(p.value.shape, dtype=torch.float32,
                           device=p.value.device)

    def _update_with_param(self, p, pv, g, state, lr, t):
        # exclude_from_weight_decay_fn and a group's weight_decay
        wd = self._lamb_wd
        if self._exclude_fn is not None and self._exclude_fn(p):
            wd = 0.0
        elif id(p) in self._param_wd:
            ov = self._param_wd[id(p)]
            wd = float(ov) if isinstance(ov, (int, float)) else wd
        return self._update(pv, g, state, lr, t, wd)

    def _update(self, p, g, state, lr, t=1, wd=None):
        wd = self._lamb_wd if wd is None else wd
        gf, pf = g.float(), p.float()
        m = self._beta1 * state["moment1"] + (1 - self._beta1) * gf
        v = self._beta2 * state["moment2"] + (1 - self._beta2) * gf * gf
        mhat = m / _bias_correction(self._beta1, t)
        vhat = v / _bias_correction(self._beta2, t)
        r = mhat / (torch.sqrt(vhat) + self._epsilon)
        update = r + wd * pf
        w_norm = torch.linalg.vector_norm(pf)
        u_norm = torch.linalg.vector_norm(update)
        one = torch.ones((), dtype=pf.dtype, device=pf.device)
        ratio = torch.where(w_norm > 0, torch.where(u_norm > 0,
                                                    w_norm / u_norm, one),
                            one)
        new_p = pf - lr * ratio * update
        return new_p.to(p.dtype), {"moment1": m, "moment2": v}


class DecayedAdagrad(Optimizer):
    """Adagrad with an exponentially decayed accumulator (ref
    ``DecayedAdagrad``)."""
    _accum_names = ("moment",)
    _fused_supported = False

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._decay = decay
        self._epsilon = epsilon

    def _update(self, p, g, state, lr, t=1):
        g = g.to(p.dtype)
        m = self._decay * state["moment"] + (1 - self._decay) * g * g
        return p - lr * g / (torch.sqrt(m) + self._epsilon), {"moment": m}


class Ftrl(Optimizer):
    """FTRL-proximal (ref ``Ftrl``): per-coordinate adaptive rates with L1
    and L2 shrinkage."""
    _accum_names = ("squared", "linear")
    _fused_supported = False

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._l1 = l1
        self._l2 = l2
        self._lr_power = lr_power

    def _update(self, p, g, state, lr, t=1):
        g = g.to(p.dtype)
        n, z = state["squared"], state["linear"]
        n_new = n + g * g
        sigma = (n_new ** (-self._lr_power) - n ** (-self._lr_power)) / lr
        z_new = z + g - sigma * p
        new_p = torch.where(
            torch.abs(z_new) <= self._l1, torch.zeros_like(p),
            (torch.sign(z_new) * self._l1 - z_new)
            / (n_new ** (-self._lr_power) / lr + 2 * self._l2))
        return new_p, {"squared": n_new, "linear": z_new}


class Dpsgd(Optimizer):
    """Differentially private SGD (ref ``Dpsgd``): each grad clipped to
    ``clip`` in norm, then Gaussian noise of scale sigma * clip /
    batch_size added.  Per-leaf: the noise stream is keyed on the step
    and the parameter."""
    _accum_names = ()
    _fused_supported = False

    def __init__(self, learning_rate=0.001, clip=0.9, batch_size=0.999,
                 sigma=1.0, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, seed=0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._clip = clip
        self._batch = batch_size
        self._sigma = sigma
        self._seed = seed

    def _update(self, p, g, state, lr, t=1, key=0):
        g = g.to(p.dtype)
        norm = torch.sqrt(torch.sum(g * g))
        g = g / torch.clamp(norm / self._clip, min=1.0)
        gen = torch.Generator(device=p.device).manual_seed(
            hash((self._seed, int(t), key)) & (2 ** 63 - 1))
        noise = torch.randn(g.shape, generator=gen, device=p.device,
                            dtype=torch.float32) \
            * (self._sigma * self._clip / self._batch)
        return p - lr * (g + noise.to(p.dtype)), {}

    def _update_with_param(self, p, pv, g, state, lr, t):
        # one stream a parameter: equal-sized parameters must not share
        # noise (the DP accounting assumes independence)
        return self._update(pv, g, state, lr, t, id(p) % (2 ** 31 - 1))


class LarsMomentum(Momentum):
    """Layer-wise adaptive rate scaling (ref ``LarsMomentum``): local lr =
    coeff * ||w|| / (||g|| + lambda * ||w||), then momentum."""
    _fused_supported = False

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, momentum, parameters,
                         weight_decay=weight_decay, grad_clip=grad_clip)
        self._coeff = lars_coeff
        self._lwd = lars_weight_decay

    def _update(self, p, g, state, lr, t=1):
        g = g.to(p.dtype)
        wn = torch.sqrt(torch.sum(p * p))
        gn = torch.sqrt(torch.sum(g * g))
        local = self._coeff * wn / (gn + self._lwd * wn + 1e-12)
        g_eff = g + self._lwd * p
        v = self._momentum * state["velocity"] + lr * local * g_eff
        return p - v, {"velocity": v}
