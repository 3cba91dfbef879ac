"""Activation functionals (counterpart of
``paddle_tpu/nn/functional/activation.py``), under the reference's op
names.  The in-place forms (``relu_``, ``elu_``, ``softmax_``,
``tanh_``) rebind their tensor, as the reference's do.  ``rrelu`` in
training and ``gumbel_softmax`` draw their noise where their tensor is,
from the default generator's stream for that device."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...framework import core
from ...ops.dispatch import call
from ...tensor.math import _float_in, tanh_  # noqa: F401


def _u(tfn, opname):
    def op(x, name=None):
        return call(tfn, x, _name=opname)
    op.__name__ = opname
    return op


relu = _u(torch.relu, "relu")
relu6 = _u(lambda a: torch.clamp(a, 0.0, 6.0), "relu6")
sigmoid = _u(_float_in(torch.sigmoid), "sigmoid")
tanh = _u(torch.tanh, "tanh")
silu = _u(TF.silu, "silu")
log_sigmoid = _u(TF.logsigmoid, "log_sigmoid")
tanhshrink = _u(lambda a: a - torch.tanh(a), "tanhshrink")
softsign = _u(lambda a: a / (1 + torch.abs(a)), "softsign")


def relu_(x):
    return x._rebind(relu(x))


def gelu(x, approximate=False, name=None):
    """Exact erf gelu by default, as ``jax.nn.gelu(approximate=False)``;
    the tanh form with ``approximate=True``."""
    mode = "tanh" if approximate else "none"
    return call(lambda a: TF.gelu(a, approximate=mode), x, _name="gelu")


def elu(x, alpha=1.0, name=None):
    return call(lambda a: torch.where(
        a > 0, a, alpha * torch.expm1(torch.clamp(a, max=0.0))), x,
        _name="elu")


def elu_(x, alpha=1.0, name=None):
    return x._rebind(elu(x, alpha))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    # the expm1 operand is clamped so the branch not taken cannot overflow
    # (0 * inf would make the gradient NaN at large inputs)
    return call(lambda a: scale * torch.where(
        a > 0, a, alpha * torch.expm1(torch.clamp(a, max=0.0))), x,
        _name="selu")


def leaky_relu(x, negative_slope=0.01, name=None):
    return call(lambda a: torch.where(a >= 0, a, negative_slope * a), x,
                _name="leaky_relu")


def prelu(x, weight, data_format="NCHW", name=None):
    """x where positive, else the (per-channel) weight times x."""
    def _p(a, w):
        if w.numel() == 1:
            return torch.where(a > 0, a, w.reshape(()) * a)
        ch = 1 if data_format.startswith("NC") else a.dim() - 1
        shape = [1] * a.dim()
        shape[ch] = w.numel()
        return torch.where(a > 0, a, w.reshape(shape) * a)
    return call(_p, x, weight, _name="prelu")


def rrelu(x, lower=1. / 8., upper=1. / 3., training=False, name=None):
    """Negative inputs times a slope drawn from U[lower, upper) in
    training, times their mean otherwise."""
    def _r(a):
        if training:
            gen = core.default_generator().on(a.device)
            noise = torch.rand(a.shape, generator=gen, dtype=a.dtype,
                               device=a.device) * (upper - lower) + lower
        else:
            noise = (lower + upper) / 2.0
        return torch.where(a >= 0, a, noise * a)
    return call(_r, x, _name="rrelu")


def hardshrink(x, threshold=0.5, name=None):
    return call(lambda a: torch.where(torch.abs(a) > threshold, a, 0.0), x,
                _name="hardshrink")


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return call(lambda a: torch.clamp(a, min, max), x, _name="hardtanh")


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return call(lambda a: torch.clamp(slope * a + offset, 0.0, 1.0), x,
                _name="hardsigmoid")


def hardswish(x, name=None):
    return call(lambda a: a * torch.clamp(a + 3.0, 0.0, 6.0) / 6.0, x,
                _name="hardswish")


def swish(x, name=None):
    return call(TF.silu, x, _name="swish")


def _softplus(a):
    return torch.logaddexp(a, torch.zeros((), dtype=a.dtype,
                                          device=a.device))


def mish(x, name=None):
    return call(lambda a: a * torch.tanh(_softplus(a)), x, _name="mish")


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return call(lambda a: torch.where(beta * a > threshold, a,
                                      _softplus(beta * a) / beta),
                x, _name="softplus")


def softshrink(x, threshold=0.5, name=None):
    return call(lambda a: torch.where(
        a > threshold, a - threshold,
        torch.where(a < -threshold, a + threshold, 0.0)), x,
        _name="softshrink")


def thresholded_relu(x, threshold=1.0, name=None):
    return call(lambda a: torch.where(a > threshold, a, 0.0), x,
                _name="thresholded_relu")


def maxout(x, groups, axis=1, name=None):
    def _m(a):
        ax = axis % a.dim()
        c = a.shape[ax]
        shape = tuple(a.shape[:ax]) + (c // groups, groups) + tuple(
            a.shape[ax + 1:])
        return torch.amax(a.reshape(shape), dim=ax + 1)
    return call(_m, x, _name="maxout")


def softmax(x, axis=-1, dtype=None, name=None):
    dt = core.convert_dtype(dtype)
    return call(lambda a: torch.softmax(a if dt is None else a.to(dt),
                                        int(axis)), x, _name="softmax")


def softmax_(x, axis=-1, dtype=None, name=None):
    return x._rebind(softmax(x, axis, dtype))


def log_softmax(x, axis=-1, dtype=None, name=None):
    dt = core.convert_dtype(dtype)
    return call(lambda a: torch.log_softmax(a if dt is None else a.to(dt),
                                            int(axis)),
                x, _name="log_softmax")


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """softmax((x + g) / temperature), g drawn from Gumbel(0, 1); with
    ``hard`` the one-hot of its argmax, with the soft gradient."""
    def _gs(a):
        gen = core.default_generator().on(a.device)
        u = torch.rand(a.shape, generator=gen, dtype=a.dtype,
                       device=a.device)
        g = -torch.log(-torch.log(u.clamp_min(torch.finfo(a.dtype).tiny)))
        y = torch.softmax((a + g) / temperature, dim=axis)
        if hard:
            idx = torch.argmax(y, dim=axis, keepdim=True)
            y_hard = torch.zeros_like(y).scatter(axis, idx, 1.0)
            y = y_hard - y.detach() + y
        return y
    return call(_gs, x, _name="gumbel_softmax")


def glu(x, axis=-1, name=None):
    def _glu(a):
        first, second = torch.chunk(a, 2, dim=axis)
        return first * torch.sigmoid(second)
    return call(_glu, x, _name="glu")
