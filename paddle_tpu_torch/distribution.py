"""paddle.distribution (counterpart of ``paddle_tpu/distribution.py``):
``Uniform``, ``Normal``, ``Categorical``, ``MultivariateNormalDiag``,
``kl_divergence`` and ``sampling_id``.

``log_prob``, ``probs``, ``entropy`` and ``kl_divergence`` are the
reference's formulas on the parameters' values, in their dtype (python
numbers and float64 arrays become the default dtype, integers float32).
Samples are drawn from torch's generators where the parameters are: the
default generator's stream for that device, or a generator seeded with
``seed`` when it is not 0.  They follow the reference's distributions,
shapes and dtypes, not its numbers (the reference draws from JAX's
PRNG).  As in the reference, the results are plain Tensors off the
tape.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .framework import core
from .tensor.tensor import Tensor, _to_torch_value

__all__ = ["Distribution", "Uniform", "Normal", "Categorical",
           "kl_divergence", "MultivariateNormalDiag", "sampling_id"]


def _val(x, dtype=torch.float32):
    v = (x.value if isinstance(x, Tensor) else _to_torch_value(x)).detach()
    if not v.is_floating_point():
        v = v.to(dtype)
    return v


def _gen(seed, device):
    if seed:
        return torch.Generator(device=device).manual_seed(int(seed))
    return core.default_generator().on(device)


def _bshape(a, b):
    return torch.broadcast_shapes(a.shape, b.shape)


class Distribution:
    def sample(self, shape=(), seed=0):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def probs(self, value):
        raise NotImplementedError

    def kl_divergence(self, other):
        raise NotImplementedError


class Uniform(Distribution):
    """U(low, high), high excluded."""

    def __init__(self, low, high, name=None):
        self.low = _val(low)
        self.high = _val(high)
        self.name = name or "Uniform"

    def sample(self, shape, seed=0):
        shape = tuple(shape) + tuple(_bshape(self.low, self.high))
        dt = torch.promote_types(self.low.dtype, self.high.dtype)
        u = torch.rand(shape, generator=_gen(seed, self.low.device),
                       dtype=dt, device=self.low.device)
        return Tensor(self.low + u * (self.high - self.low))

    def _inside(self, value):
        v = _val(value)
        return (v >= self.low) & (v < self.high)

    def log_prob(self, value):
        return Tensor(torch.where(self._inside(value),
                                  -torch.log(self.high - self.low),
                                  float("-inf")))

    def probs(self, value):
        return Tensor(torch.where(self._inside(value),
                                  1.0 / (self.high - self.low), 0.0))

    def entropy(self):
        return Tensor(torch.log(self.high - self.low)
                      * torch.ones(_bshape(self.low, self.high),
                                   device=self.low.device))


class Normal(Distribution):
    """N(loc, scale)."""

    def __init__(self, loc, scale, name=None):
        self.loc = _val(loc)
        self.scale = _val(scale)
        self.name = name or "Normal"

    def sample(self, shape, seed=0):
        shape = tuple(shape) + tuple(_bshape(self.loc, self.scale))
        dt = torch.promote_types(self.loc.dtype, self.scale.dtype)
        z = torch.randn(shape, generator=_gen(seed, self.loc.device),
                        dtype=dt, device=self.loc.device)
        return Tensor(self.loc + z * self.scale)

    def entropy(self):
        return Tensor(0.5 + 0.5 * math.log(2 * math.pi) + torch.log(
            self.scale.broadcast_to(_bshape(self.loc, self.scale))))

    def log_prob(self, value):
        v = _val(value)
        var = self.scale * self.scale
        return Tensor(-((v - self.loc) ** 2) / (2 * var)
                      - torch.log(self.scale) - 0.5 * math.log(2 * math.pi))

    def probs(self, value):
        return Tensor(torch.exp(self.log_prob(value).value))

    def kl_divergence(self, other):
        """KL(self || other), both Normal."""
        if not isinstance(other, Normal):
            raise TypeError("kl_divergence: other must be a Normal")
        var_ratio = (self.scale / other.scale) ** 2
        t1 = ((self.loc - other.loc) / other.scale) ** 2
        return Tensor(0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio)))


class Categorical(Distribution):
    """Categorical over ``logits`` (log-weights: probabilities are their
    softmax, as the reference's sampling path takes them)."""

    def __init__(self, logits, name=None):
        self.logits = _val(logits)
        self.name = name or "Categorical"

    def _log_pmf(self):
        return torch.log_softmax(self.logits, -1)

    def sample(self, shape, seed=0):
        shape = tuple(shape)
        batch = self.logits.shape[:-1]
        p = torch.softmax(self.logits, -1).reshape(-1, self.logits.shape[-1])
        n = int(np.prod(shape)) if shape else 1
        idx = torch.multinomial(p, n, replacement=True,
                                generator=_gen(seed, p.device))
        # [batch, n] -> shape + batch
        idx = idx.T.reshape(shape + tuple(batch))
        return Tensor(idx.to(torch.int32))

    def entropy(self):
        logp = self._log_pmf()
        return Tensor(-(torch.exp(logp) * logp).sum(-1))

    def kl_divergence(self, other):
        if not isinstance(other, Categorical):
            raise TypeError("kl_divergence: other must be a Categorical")
        logp, logq = self._log_pmf(), other._log_pmf()
        return Tensor((torch.exp(logp) * (logp - logq)).sum(-1))

    def _at(self, table, value):
        idx = _val(value, torch.int32).to(torch.int64)
        if table.dim() == 1:
            return Tensor(table[idx])
        return Tensor(torch.gather(table, -1, idx[..., None])[..., 0])

    def probs(self, value):
        """Probabilities of the given category indices."""
        return self._at(torch.exp(self._log_pmf()), value)

    def log_prob(self, value):
        """The log-pmf gathered directly (finite for very negative
        logits)."""
        return self._at(self._log_pmf(), value)


def kl_divergence(p, q):
    return p.kl_divergence(q)


class MultivariateNormalDiag(Distribution):
    """N(loc, diag(scale)): the per-dimension Gaussian's formulas summed
    over the last axis."""

    def __init__(self, loc, scale, name=None):
        self.loc = _val(loc)
        self.scale = _val(scale)
        self.name = name or "MultivariateNormalDiag"

    def sample(self, shape=(), seed=0):
        shape = tuple(shape) + tuple(_bshape(self.loc, self.scale))
        dt = torch.promote_types(self.loc.dtype, self.scale.dtype)
        z = torch.randn(shape, generator=_gen(seed, self.loc.device),
                        dtype=dt, device=self.loc.device)
        return Tensor(self.loc + z * self.scale)

    def log_prob(self, value):
        v = _val(value)
        var = self.scale * self.scale
        per_dim = (-((v - self.loc) ** 2) / (2 * var) - torch.log(self.scale)
                   - 0.5 * math.log(2 * math.pi))
        return Tensor(per_dim.sum(-1))

    def entropy(self):
        per_dim = 0.5 + 0.5 * math.log(2 * math.pi) + torch.log(
            self.scale.broadcast_to(_bshape(self.loc, self.scale)))
        return Tensor(per_dim.sum(-1))

    def kl_divergence(self, other):
        if not isinstance(other, MultivariateNormalDiag):
            raise TypeError("kl_divergence: other must be a "
                            "MultivariateNormalDiag")
        v1, v2 = self.scale ** 2, other.scale ** 2
        per_dim = (torch.log(other.scale) - torch.log(self.scale)
                   + (v1 + (self.loc - other.loc) ** 2) / (2 * v2) - 0.5)
        return Tensor(per_dim.sum(-1))


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="int64"):
    """One category index a row of the probability matrix ``x``, drawn
    from its probabilities (floored at 1e-30), in ``dtype``."""
    from .ops.dispatch import call
    dt = core.convert_dtype(dtype)

    def _sid(p):
        p = torch.clamp(p.float(), min=1e-30)
        return torch.multinomial(p, 1, generator=_gen(seed, p.device))[
            :, 0].to(dt)
    return call(_sid, x, _name="sampling_id")
