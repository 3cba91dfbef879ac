"""Normalization functionals (counterpart of
``paddle_tpu/nn/functional/norm.py``; only ``layer_norm`` and
``rms_norm``).

The routing is the reference's: a call that will not record (grad mode
off, or every operand stops gradients) goes to the fused kernel,
``ops.cuda.norms.layer_norm`` / ``rms_norm`` (the plain version for CPU
tensors); a call that records, or has no weight, takes the plain formula,
as the reference keeps the eager tape on its single-pass XLA formula.
"""
from __future__ import annotations

import torch

from ...framework import core
from ...ops.cuda import norms
from ...ops.dispatch import call
from ...tensor.tensor import Tensor


def _recording(*tensors):
    """True when this call will record (grad mode on and an operand that
    does not stop gradients)."""
    return core.grad_enabled() and any(
        isinstance(t, Tensor) and not t.stop_gradient for t in tensors)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    nd = len(tuple(normalized_shape))

    if (nd == 1 and weight is not None and bias is not None
            and not _recording(x, weight, bias)):
        return call(lambda a, w, b: norms.layer_norm(a, w, b, epsilon),
                    x, weight, bias, _name="layer_norm")

    def _ln(a, *wb):
        dims = tuple(range(a.dim() - nd, a.dim()))
        mean = a.mean(dims, keepdim=True)
        var = a.var(dims, correction=0, keepdim=True)
        out = (a - mean) * torch.rsqrt(var + epsilon)
        if wb:
            out = out * wb[0].reshape(a.shape[a.dim() - nd:])
            if len(wb) > 1:
                out = out + wb[1].reshape(a.shape[a.dim() - nd:])
        return out

    args = [a for a in (weight, bias) if a is not None]
    return call(_ln, x, *args, _name="layer_norm")


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    if weight is not None and not _recording(x, weight):
        return call(lambda a, w: norms.rms_norm(a, w, epsilon), x, weight,
                    _name="rms_norm")

    def _rms(a, *w):
        af = a.float()
        ms = (af * af).mean(-1, keepdim=True)
        out = (af * torch.rsqrt(ms + epsilon)).to(a.dtype)
        if w:
            out = out * w[0]
        return out
    args = [weight] if weight is not None else []
    return call(_rms, x, *args, _name="rms_norm")
