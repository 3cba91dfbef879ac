"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``).

A clip object maps ``[(param, grad), ...]`` (grads as torch tensors) to
new pairs and leaves ``.grad`` alone; a parameter with ``need_clip``
False keeps its grad.  Norms are taken in fp32 with one multi-tensor
reduction (``torch._foreach_norm``) and applied with one multi-tensor
product, the counterpart of the reference's one compiled expression; the
global norm never leaves the device.  ``clip_grad_norm_`` and
``clip_grad_value_`` rewrite ``.grad`` in place.
"""
from __future__ import annotations

import torch

from ..tensor.tensor import Tensor


def _clips(p, g):
    return g is not None and getattr(p, "need_clip", True)


def _f32(gs):
    return [g if g.dtype == torch.float32 else g.float() for g in gs]


def _replace(params_grads, idx, new):
    out = list(params_grads)
    for i, g in zip(idx, new):
        out[i] = (out[i][0], g.to(params_grads[i][1].dtype))
    return out


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        idx = [i for i, (p, g) in enumerate(params_grads) if _clips(p, g)]
        if not idx:
            return list(params_grads)
        gs = torch._foreach_clamp_min([params_grads[i][1] for i in idx],
                                      self.min)
        torch._foreach_clamp_max_(gs, self.max)
        return _replace(params_grads, idx, gs)


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        idx = [i for i, (p, g) in enumerate(params_grads) if _clips(p, g)]
        if not idx:
            return list(params_grads)
        gs = _f32([params_grads[i][1] for i in idx])
        norms = torch._foreach_norm(gs)
        new = [g * torch.clamp(self.clip_norm / torch.clamp(n, min=1e-12),
                               max=1.0) for g, n in zip(gs, norms)]
        return _replace(params_grads, idx, new)


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def global_norm(self, grads):
        """sqrt of the sum of every grad's fp32 sum of squares, a 0-d
        tensor on the first grad's device."""
        norms = torch._foreach_norm(_f32(grads))
        dev = norms[0].device
        return torch.linalg.vector_norm(torch.stack([n.to(dev)
                                                     for n in norms]))

    def __call__(self, params_grads):
        idx = [i for i, (p, g) in enumerate(params_grads) if _clips(p, g)]
        if not idx:
            return list(params_grads)
        gs = [params_grads[i][1] for i in idx]
        gn = self.global_norm(gs)
        scale = torch.clamp(self.clip_norm / torch.clamp(gn, min=1e-12),
                            max=1.0)
        by_dev = {}
        for j, g in enumerate(gs):
            by_dev.setdefault(g.device, []).append(j)
        new = [None] * len(gs)
        for dev, js in by_dev.items():
            out = torch._foreach_mul(_f32([gs[j] for j in js]),
                                     scale.to(dev))
            for j, g in zip(js, out):
                new[j] = g
        return _replace(params_grads, idx, new)


GradientClipByValue = ClipGradByValue
GradientClipByNorm = ClipGradByNorm
GradientClipByGlobalNorm = ClipGradByGlobalNorm


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every ``.grad`` so that their joint ``norm_type`` norm is at
    most ``max_norm``; returns that norm before scaling.
    ``error_if_nonfinite`` is accepted and ignored, as in the reference."""
    if isinstance(parameters, Tensor):
        parameters = [parameters]
    params = [p for p in parameters if p.value.grad is not None]
    if not params:
        return Tensor(torch.zeros(()))
    grads = [p.value.grad for p in params]
    if norm_type == float("inf"):
        total = torch.max(torch.stack([g.abs().max() for g in grads]))
    else:
        total = torch.pow(
            sum(torch.sum(torch.pow(g.float().abs(), norm_type))
                for g in grads), 1.0 / norm_type)
    scale = torch.clamp(max_norm / torch.clamp(total, min=1e-6), max=1.0)
    for p in params:
        p.value.grad = (p.value.grad.float() * scale).to(p.value.grad.dtype)
    return Tensor(total)


def clip_grad_value_(parameters, clip_value):
    if isinstance(parameters, Tensor):
        parameters = [parameters]
    for p in parameters:
        if p.value.grad is not None:
            p.value.grad = torch.clamp(p.value.grad, -clip_value, clip_value)
