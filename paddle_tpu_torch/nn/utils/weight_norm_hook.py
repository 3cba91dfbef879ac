"""``weight_norm`` by a forward pre-hook (counterpart of
``paddle_tpu/nn/utils/weight_norm_hook.py``): the weight becomes
``{name}_v`` (its direction) and ``{name}_g`` (its norm over every axis
but ``dim``; a scalar for ``dim=None``), and each forward recomputes
``v * g / ||v||`` as one op on the tape."""
from __future__ import annotations

import torch

from ...ops.dispatch import call
from ...tensor.tensor import Parameter


def _norm_except(w, dim, keepdim=True):
    if dim is None:
        return torch.sqrt((w * w).sum())
    axes = tuple(i for i in range(w.dim()) if i != dim)
    return torch.sqrt((w * w).sum(axes, keepdim=keepdim))


class WeightNorm:
    def __init__(self, name, dim):
        self.name = name
        self.dim = dim

    def compute_weight(self, layer):
        dim = self.dim

        def _wn(g, v):
            n = _norm_except(v, dim)
            if dim is None:
                return v * (g / n)
            shape = [1] * v.dim()
            shape[dim] = -1
            return v * (g.reshape(shape) / n)
        return call(_wn, getattr(layer, self.name + "_g"),
                    getattr(layer, self.name + "_v"), _name="weight_norm")

    @staticmethod
    def apply(layer, name, dim):
        fn = WeightNorm(name, dim)
        w = getattr(layer, name)
        del layer._parameters[name]
        with torch.no_grad():
            g0 = _norm_except(w.value, dim, keepdim=False)
        layer.add_parameter(name + "_v", Parameter(w.value))
        layer.add_parameter(name + "_g", Parameter(g0))
        object.__setattr__(layer, name, fn.compute_weight(layer))
        hook = layer.register_forward_pre_hook(
            lambda lay, inp: object.__setattr__(lay, name,
                                                fn.compute_weight(lay)))
        layer._weight_norm_fn = fn
        layer._weight_norm_hook = hook
        return fn


def weight_norm(layer, name="weight", dim=0):
    WeightNorm.apply(layer, name, dim)
    return layer


def remove_weight_norm(layer, name="weight"):
    """Fold ``g`` and ``v`` back into one parameter ``name`` and drop the
    hook (only this one)."""
    fn = getattr(layer, "_weight_norm_fn", None)
    if fn is None:
        return layer
    w = fn.compute_weight(layer)
    del layer._parameters[name + "_g"]
    del layer._parameters[name + "_v"]
    layer._weight_norm_hook.remove()
    layer.__dict__.pop(name, None)
    layer.__dict__.pop("_weight_norm_hook", None)
    layer.__dict__.pop("_weight_norm_fn", None)
    layer.add_parameter(name, Parameter(w.value))
    return layer
