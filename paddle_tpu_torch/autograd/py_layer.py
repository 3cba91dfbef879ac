"""PyLayer: user-defined autograd ops (counterpart of
``paddle_tpu/autograd/py_layer.py``), over ``torch.autograd.Function``.

``forward(ctx, *args)`` runs once, without recording, on the Tensor
arguments detached; when the call records (grad mode on and a Tensor
argument that does not stop gradients) its outputs join the tape, and
``backward(ctx, *grads)`` gives their inputs' grads: one a Tensor
argument, or, in the short form, one for each argument that does not stop
gradients, in order.
"""
from __future__ import annotations

import torch

from ..framework import core


class PyLayerContext:
    def __init__(self):
        self._saved = ()
        self.attrs = {}

    def save_for_backward(self, *tensors):
        self._saved = tensors

    def saved_tensor(self):
        return self._saved


class _Function(torch.autograd.Function):
    """Runs ``layer``'s forward on ``args`` with the values of the
    differentiable Tensors (``vals``) put back at ``slots``; its backward
    calls the layer's backward.  ``diff_pos``: where those Tensors stand
    among the Tensor arguments."""

    @staticmethod
    def forward(fctx, layer, pctx, args, kwargs, slots, diff_pos, *vals):
        from ..tensor.tensor import Tensor
        args = list(args)
        for i, v in zip(slots, vals):
            args[i] = Tensor(v)
        outs = layer.forward(pctx, *args, **kwargs)
        pctx._single = not isinstance(outs, (tuple, list))
        fctx.layer, fctx.pctx, fctx.diff_pos = layer, pctx, diff_pos
        fctx.n_tensors = sum(isinstance(a, Tensor) for a in args)
        return tuple(o.value for o in ((outs,) if pctx._single else outs))

    @staticmethod
    def backward(fctx, *cts):
        from ..tensor.tensor import Tensor
        grads = fctx.layer.backward(fctx.pctx, *[Tensor(c) for c in cts])
        if not isinstance(grads, (tuple, list)):
            grads = (grads,)
        vals = [g.value if isinstance(g, Tensor) else g for g in grads]
        if len(vals) == fctx.n_tensors:
            vals = [vals[i] for i in fctx.diff_pos]
        else:
            vals = vals[:len(fctx.diff_pos)]
        return (None,) * 6 + tuple(vals)


class PyLayer:
    """Subclass and define ``forward(ctx, *args)`` / ``backward(ctx,
    *grads)`` as static methods; call ``apply``."""

    @classmethod
    def apply(cls, *args, **kwargs):
        from ..tensor.tensor import Tensor

        ctx = PyLayerContext()
        tensors = [a for a in args if isinstance(a, Tensor)]
        record = core.grad_enabled() and any(
            not t.stop_gradient for t in tensors)
        detached = tuple(a.detach() if isinstance(a, Tensor) else a
                         for a in args)
        if not record:
            return cls.forward(ctx, *detached, **kwargs)
        slots = [i for i, a in enumerate(args) if isinstance(a, Tensor)
                 and not a.stop_gradient and a.value.is_floating_point()]
        tensor_at = [i for i, a in enumerate(args) if isinstance(a, Tensor)]
        diff_pos = [tensor_at.index(i) for i in slots]
        outs = _Function.apply(cls, ctx, detached, kwargs, slots, diff_pos,
                               *[args[i].value for i in slots])
        outs = tuple(Tensor(o, stop_gradient=not o.is_floating_point())
                     for o in outs)
        return outs[0] if ctx._single else outs
