"""``spectral_norm`` by a forward pre-hook (counterpart of
``paddle_tpu/nn/utils/spectral_norm_hook.py``): the weight becomes
``{name}_orig`` and a unit vector ``{name}_u`` (drawn from the default
generator, not trained); each eager forward moves ``u`` by
``n_power_iterations`` power iterations off the tape, then divides the
weight by ``u W v`` as one op on the tape."""
from __future__ import annotations

import torch

from ...framework import core
from ...ops.dispatch import call
from ...tensor.tensor import Parameter
from ..layer.norm import _matrix, _unit


class SpectralNormHook:
    def __init__(self, name, n_power_iterations, dim, eps):
        self.name = name
        self.n_power_iterations = n_power_iterations
        self.dim = dim
        self.eps = eps

    def compute_weight(self, layer):
        w = getattr(layer, self.name + "_orig")
        u = getattr(layer, self.name + "_u")
        dim, eps = self.dim, self.eps
        if not core.in_tracing():
            with torch.no_grad():
                wm = _matrix(w.value, dim)
                uv = u.value
                for _ in range(max(self.n_power_iterations, 1)):
                    uv = _unit(wm @ _unit(wm.T @ uv, eps), eps)
                u.value.copy_(uv)

        def _sn(wv, uv):
            wm = _matrix(wv, dim)
            v = _unit(wm.T @ uv, eps)
            return wv / (uv @ wm @ v)
        return call(_sn, w, u, _name="spectral_norm")

    @staticmethod
    def apply(layer, name, n_power_iterations, dim, eps):
        fn = SpectralNormHook(name, n_power_iterations, dim, eps)
        w = getattr(layer, name)
        del layer._parameters[name]
        h = w.value.shape[dim]
        u0 = torch.randn((h,), generator=core.default_generator().torch)
        u0 = _unit(u0, eps).to(device=w.value.device, dtype=w.value.dtype)
        layer.add_parameter(name + "_orig", Parameter(w.value))
        layer.add_parameter(name + "_u", Parameter(u0, trainable=False))
        object.__setattr__(layer, name, fn.compute_weight(layer))
        layer.register_forward_pre_hook(
            lambda lay, inp: object.__setattr__(lay, name,
                                                fn.compute_weight(lay)))
        return fn


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    SpectralNormHook.apply(layer, name, n_power_iterations,
                           0 if dim is None else dim, eps)
    return layer
