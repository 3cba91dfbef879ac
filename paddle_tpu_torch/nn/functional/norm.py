"""Normalization functionals (counterpart of
``paddle_tpu/nn/functional/norm.py``).  ``normalize``, ``group_norm``,
``instance_norm`` and ``local_response_norm`` are the reference's plain
formulas (population variance; the LRN window zero-padded size // 2
before and (size - 1) // 2 after the channel, alpha scaling its mean).

``batch_norm`` keeps the reference's conventions: in training the batch's
mean and biased variance normalise (``torch.native_batch_norm``, whose
saved inverse deviation gives the variance back), and the running
statistics move by Paddle's momentum, ``rm = momentum * rm + (1 -
momentum) * mean`` (the reverse of torch's), the variance with the
unbiased n / (n - 1) correction taken from the runtime batch inside the
op (a static program builds on a placeholder batch of 1).  The update is
its own op, ``bn_stats_update``, off the tape; eagerly it is copied into
the statistics in place, in static mode the statistics take its output
ids and the program notes the mutation, which the Executor writes back
after each run.  The train-mode op carries an eval twin
(``__test_variant__``, running-statistics normalisation) that
``Program.clone(for_test=True)`` swaps in.

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


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    def _n(a):
        nrm = a.abs().pow(p).sum(axis, keepdim=True).pow(1.0 / p)
        return a / torch.clamp(nrm, min=epsilon)
    return call(_n, x, _name="normalize")


def _moments(g, axes):
    return g.mean(axes, keepdim=True), g.var(axes, correction=0, keepdim=True)


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    def _gn(a, *wb):
        if data_format.startswith("NC"):
            n, c = a.shape[:2]
            g = a.reshape(n, num_groups, c // num_groups, *a.shape[2:])
            mean, var = _moments(g, tuple(range(2, g.dim())))
            out = ((g - mean) * torch.rsqrt(var + epsilon)).reshape(a.shape)
            shape = [1] * a.dim()
            shape[1] = c
        else:
            n, c = a.shape[0], a.shape[-1]
            g = a.reshape(n, *a.shape[1:-1], num_groups, c // num_groups)
            mean, var = _moments(g, tuple(range(1, g.dim() - 2))
                                 + (g.dim() - 1,))
            out = ((g - mean) * torch.rsqrt(var + epsilon)).reshape(a.shape)
            shape = [c]
        if wb:
            out = out * wb[0].reshape(shape)
            if len(wb) > 1:
                out = out + wb[1].reshape(shape)
        return out
    args = [a for a in (weight, bias) if a is not None]
    return call(_gn, x, *args, _name="group_norm")


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Per-(sample, channel) statistics over the spatial axes; the
    running statistics are not read or updated, as in the reference."""
    channel_last = not data_format.startswith("NC")

    def _in(a, *wb):
        if channel_last:
            axes = tuple(range(1, a.dim() - 1))
            cshape = [1] * (a.dim() - 1) + [a.shape[-1]]
        else:
            axes = tuple(range(2, a.dim()))
            cshape = [1, a.shape[1]] + [1] * (a.dim() - 2)
        mean, var = _moments(a, axes)
        out = (a - mean) * torch.rsqrt(var + eps)
        if wb:
            out = out * wb[0].reshape(cshape)
            if len(wb) > 1:
                out = out + wb[1].reshape(cshape)
        return out
    args = [a for a in (weight, bias) if a is not None]
    return call(_in, x, *args, _name="instance_norm")


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    def _lrn(a):
        ch = 1 if data_format.startswith("NC") else a.dim() - 1
        pads = [0, 0] * a.dim()
        # torch.nn.functional.pad lists pads from the last dim backwards
        pads[2 * (a.dim() - 1 - ch)] = size // 2
        pads[2 * (a.dim() - 1 - ch) + 1] = (size - 1) // 2
        sq = torch.nn.functional.pad(a * a, pads)
        s = sum(sq.narrow(ch, i, a.shape[ch]) for i in range(size)) / size
        return a / (k + alpha * s).pow(beta)
    return call(_lrn, x, _name="local_response_norm")


def _bn_eval_out(a, rm, rv, wb, ch_axis, epsilon):
    shape = [1] * a.dim()
    shape[ch_axis] = a.shape[ch_axis]
    out = (a - rm.reshape(shape)) * torch.rsqrt(rv.reshape(shape) + epsilon)
    if wb:
        out = out * wb[0].reshape(shape) + wb[1].reshape(shape)
    return out


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    ch_axis = 1 if data_format.startswith("NC") else -1
    use_batch_stats = training and not use_global_stats
    args = [weight, bias] if weight is not None else []

    if not use_batch_stats:
        return call(lambda a, rm, rv, *wb: _bn_eval_out(a, rm, rv, wb,
                                                        ch_axis, epsilon),
                    x, running_mean, running_var, *args, _name="batch_norm")

    def _bn(a, rm, rv, *wb):
        a1 = a.movedim(-1, 1) if ch_axis == -1 else a
        out, mean, invstd = torch.native_batch_norm(
            a1, wb[0] if wb else None, wb[1] if wb else None, None, None,
            True, 0.0, epsilon)
        if ch_axis == -1:
            out = out.movedim(1, -1)
        # the batch's mean and biased variance, for the running update
        return out, mean, invstd.reciprocal().square() - epsilon

    def _bn_eval(a, rm, rv, *wb):
        return _bn_eval_out(a, rm, rv, wb, ch_axis, epsilon), rm, rv

    _bn.__test_variant__ = _bn_eval
    out, mean_t, var_t = call(_bn, x, running_mean, running_var, *args,
                              _name="batch_norm")

    def _upd(rm, rv, m, v, a):
        n = a.numel() // max(a.shape[ch_axis], 1)
        corr = n / max(n - 1, 1)
        return (momentum * rm + (1 - momentum) * m,
                momentum * rv + (1 - momentum) * (v * corr))

    prev = core.grad_enabled()
    core.set_grad_enabled_flag(False)
    try:
        new_m, new_v = call(_upd, running_mean, running_var, mean_t, var_t,
                            x, _name="bn_stats_update")
    finally:
        core.set_grad_enabled_flag(prev)
    from ...static import graph
    if graph.in_static_mode():
        # the statistics keep their values while the program builds; their
        # var ids become the update's outputs, which each run writes back
        prog = graph.default_main_program()
        for t, new in ((running_mean, new_m), (running_var, new_v)):
            t._var_id = new._var_id
            prog.note_mutation(t)
    else:
        with torch.no_grad():
            running_mean.value.copy_(new_m.value)
            running_var.value.copy_(new_v.value)
    return out
