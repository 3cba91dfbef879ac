"""Quantization: QAT fake-quant training, post-training quantization and
int8 products (counterpart of ``paddle_tpu/quantization/__init__.py``;
ref: python/paddle/fluid/contrib/slim/quantization/
post_training_quantization.py:123 PostTrainingQuantization,
imperative/qat.py).

* :func:`fake_quantize` is quantize-dequantize with the reference's
  straight-through gradient (a ``torch.autograd.Function``): the gradient
  passes where ``|x / scale| <= qmax`` and the scale gets none;
* :class:`QAT` wraps ``Linear`` / ``Conv2D`` layers so that weights
  (per-output-channel absmax) and input activations (an EMA absmax
  observer, a device scalar) train against quantization noise;
  ``convert`` swaps the wrapped ``Linear`` layers for
  :class:`QuantedLinear` (int8 weights, int8 x int8 -> int32 products on
  ``torch._int_mm``, the reference's ``lax.dot_general`` with an int32
  result) and bakes fake-quantised weights into a ``Conv2D``;
* :class:`PostTrainingQuantization` calibrates the observers on sample
  batches with no training, then converts; its
  ``save_quantized_model`` writes a ``torch.export`` artifact
  (``inference/export.py``), where the reference writes StableHLO.

``quant_absmax_scale``, ``_int8_mm_core`` and ``int8_dynamic_matmul``
are the reference's ops in the same dtypes; the int8 serving path
(``models/gpt.py``) calls them.
"""
from __future__ import annotations

import torch

from .. import nn
from ..ops.dispatch import call
from ..tensor.tensor import Tensor

__all__ = ["fake_quantize", "quant_absmax_scale", "int8_matmul",
           "int8_dynamic_matmul", "QuantConfig", "QAT",
           "PostTrainingQuantization", "QuantedLinear"]

# torch._int_mm on CUDA takes more than 16 rows, and K and N multiples of 8
_INT_MM_MIN_ROWS = 17
_INT_MM_MULTIPLE = 8


def _div(a, q):
    """``a / q`` correctly rounded on any device.  Divided by a Python
    number, a CUDA tensor is multiplied by the number's reciprocal (ATen's
    division by a CPU scalar), one bit from the CPU's and the reference's
    quotient; divided by a tensor on its own device, it is not.  The
    divisor is filled on the device, so the call neither copies from the
    host nor synchronises, and a CUDA graph can capture it."""
    return a / torch.full((), q, dtype=a.dtype, device=a.device)


def _round_clip(r, qmax, mask=False):
    """The module's one rounding: ``r`` to the nearest integer (half to
    even, as ``jnp.round``), clipped to [-qmax, qmax]; with ``mask``, also
    where ``|r| <= qmax``, the straight-through gradient's pass."""
    q = torch.clamp(torch.round(r), -qmax, qmax)
    return (q, r.abs() <= qmax) if mask else q


def quant_absmax_scale(x, axis=None, bits=8):
    """absmax scale so ``x / scale`` fits [-qmax, qmax]: per tensor, or
    per channel when ``axis`` is given (an int keeps that axis, a tuple
    keeps several, e.g. the per-output-channel scales of a stacked
    [L, K, ...] weight keep every axis but the contraction)."""
    v = torch.as_tensor(x)
    qmax = 2.0 ** (bits - 1) - 1
    if axis is None:
        s = _div(v.abs().max(), qmax)
    else:
        keep = (axis,) if isinstance(axis, int) else tuple(axis)
        keep = tuple(a % v.dim() for a in keep)
        red = tuple(i for i in range(v.dim()) if i not in keep)
        s = _div(torch.amax(v.abs(), dim=red) if red else v.abs(), qmax)
    return torch.clamp(s, min=1e-8)


def _int8_mm(a, b):
    """int8 [M, K] @ int8 [K, N] -> int32 [M, N], exact (``torch._int_mm``,
    the library's int8 GEMM; the reference uses ``lax.dot_general`` with an
    int32 result), on the card through :func:`_padded_int_mm`."""
    return _padded_int_mm(a, b) if a.is_cuda else torch._int_mm(a, b)


def _padded_int_mm(a, b):
    """``torch._int_mm`` on the shapes its CUDA route takes: M padded with
    zero rows up to the minimum (to 32 rows), K and N with zeros up to
    multiples of 8, the result sliced back.  Zeros add nothing to an
    integer sum, so the result is exact."""
    M, K = a.shape
    N = b.shape[1]
    m = _INT_MM_MULTIPLE
    Mp = M if M >= _INT_MM_MIN_ROWS else 32
    Kp, Np = -(-K // m) * m, -(-N // m) * m
    if (Mp, Kp) != (M, K):
        a = torch.nn.functional.pad(a, (0, Kp - K, 0, Mp - M))
    if (Kp, Np) != (K, N):
        b = torch.nn.functional.pad(b, (0, Np - N, 0, Kp - K))
    out = torch._int_mm(a, b)
    return out if (Mp, Np) == (M, N) else out[:M, :N]


def _int8_mm_core(x, w, xs, ws):
    """Quantize x with scale ``xs``, int8 x int8 -> int32, rescale:
    ``acc * (xs * ws)`` in fp32."""
    xq = _round_clip(x / xs, 127).to(torch.int8)
    acc = _int8_mm(xq.reshape(-1, xq.shape[-1]), w.contiguous())
    acc = acc.reshape(*x.shape[:-1], w.shape[-1])
    return acc.float() * (xs * ws)


def int8_dynamic_matmul(x, w_int8, w_scale):
    """W8A8 matmul of ``quant="int8_dynamic"`` serving: a per-row absmax
    activation scale computed on each call (in x's dtype, as the
    reference does), then the int8 core.  x: [..., K] float; w_int8:
    [K, N]; w_scale: [N]-broadcastable fp32.  Returns fp32.  Per-row
    scales keep a row's result independent of its batch mates."""
    xs = torch.clamp(x.abs().amax(-1, keepdim=True) / 127.0, min=1e-8)
    return _int8_mm_core(x, w_int8, xs, w_scale)


# --------------------------------------------------------------------------
# fake quantization and the calibrated int8 product
# --------------------------------------------------------------------------

class _FakeQuant(torch.autograd.Function):
    """Quantize-dequantize; the straight-through gradient passes only
    where x was inside the clip range, and the scale gets zero (the
    observers own it, as the reference's moving-average quantizers)."""

    @staticmethod
    def forward(ctx, x, scale, bits):
        # x / scale in the promoted dtype, as jnp promotes two arrays
        s = scale.to(torch.promote_types(x.dtype, scale.dtype))
        r = x.to(s.dtype) / s
        q, inside = _round_clip(r, 2.0 ** (bits - 1) - 1, mask=True)
        ctx.save_for_backward(inside, s)
        return q * s

    @staticmethod
    def backward(ctx, g):
        inside, s = ctx.saved_tensors
        return g * inside, torch.zeros_like(s), None


def fake_quantize(x, scale, bits=8, name=None):
    """Quantize-dequantize with the STE gradient.  scale: scalar or
    per-channel (broadcastable against x)."""
    return call(lambda xv, sv: _FakeQuant.apply(xv, sv, bits), x, scale,
                _name="fake_quantize")


def _int8_matmul(x, w, xs, ws):
    # x / xs in the promoted dtype (a bf16 x over an fp32 scale divides in
    # fp32, as jnp promotes two arrays)
    return _int8_mm_core(x.to(torch.promote_types(x.dtype, xs.dtype)), w,
                         xs, ws)


def int8_matmul(x, w_int8, x_scale, w_scale, name=None):
    """Real int8 GEMM: quantize x per tensor with ``x_scale``, int8 x int8
    -> int32, rescale to float.  w_int8: [in, out] int8; w_scale: [out]
    or scalar."""
    return call(_int8_matmul, x, w_int8, x_scale, w_scale,
                _name="int8_matmul")


# --------------------------------------------------------------------------
# observers + QAT layer wrappers
# --------------------------------------------------------------------------

class AbsmaxObserver:
    """EMA absmax activation observer (ref imperative/qat.py moving-average
    quantizer)."""

    def __init__(self, bits=8, momentum=0.9):
        self.bits = bits
        self.momentum = momentum
        self.scale = None

    def observe(self, x):
        # the EMA stays a device scalar: no host read in a training step
        with torch.no_grad():
            s = quant_absmax_scale(x, bits=self.bits)
            if self.scale is None:
                self.scale = s
            else:
                self.scale = self.momentum * self.scale \
                    + (1 - self.momentum) * s
        return self.scale


class QuantConfig:
    """Which layers to quantize and how (ref PostTrainingQuantization's
    quantizable_op_type / weight_bits / activation_bits)."""

    def __init__(self, weight_bits=8, activation_bits=8,
                 quantizable_layer_type=("Linear", "Conv2D"),
                 activation_momentum=0.9):
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.quantizable_layer_type = tuple(quantizable_layer_type)
        self.activation_momentum = activation_momentum


class _QATWrapper(nn.Layer):
    """Fake-quant both the weight (per output channel) and the input
    activation (EMA per tensor) around the wrapped layer's forward.

    The wrapped layer's ``weight`` is swapped for the fake-quantised
    tensor during its forward and restored after, through ``Layer``'s
    attribute protocol as in the reference: the restore re-registers the
    parameter, so from the first forward on ``weight`` follows ``bias`` in
    ``_parameters``, ``state_dict()`` and ``parameters()``, in the
    reference's order."""

    def __init__(self, layer, config: QuantConfig):
        super().__init__()
        self.inner = layer
        self._cfg = config
        self._obs = AbsmaxObserver(config.activation_bits,
                                   config.activation_momentum)

    def forward(self, x):
        cfg = self._cfg
        a_scale = self._obs.observe(x.value if isinstance(x, Tensor)
                                    else x)
        x = fake_quantize(x, Tensor(a_scale.to(torch.float32)),
                          bits=cfg.activation_bits)
        w = self.inner.weight
        axis = w.ndim - 1 if type(self.inner).__name__ == "Linear" else 0
        with torch.no_grad():
            w_scale = quant_absmax_scale(w.value, axis=axis,
                                         bits=cfg.weight_bits)
        if axis == w.ndim - 1:
            w_scale_b = w_scale[None, :] if w.ndim == 2 else w_scale
        else:
            w_scale_b = w_scale.reshape((-1,) + (1,) * (w.ndim - 1))
        orig = self.inner.weight
        try:
            self.inner.weight = fake_quantize(
                orig, Tensor(w_scale_b), bits=cfg.weight_bits)
            return self.inner(x)
        finally:
            self.inner.weight = orig

    @property
    def weight(self):
        return self.inner.weight


def _wrap_children(model, config, type_names):
    for name, child in list(model.named_children()):
        if type(child).__name__ in type_names:
            setattr(model, name, _QATWrapper(child, config))
        else:
            _wrap_children(child, config, type_names)


class QAT:
    """Quantization-aware training (ref
    imperative/qat.py::ImperativeQuantAware): ``quantize(model)`` wraps
    layers in place; train as usual; ``convert`` freezes int8 weights +
    scales for deployment."""

    def __init__(self, config: QuantConfig | None = None):
        self.config = config or QuantConfig()

    def quantize(self, model):
        _wrap_children(model, self.config,
                       set(self.config.quantizable_layer_type))
        return model

    def convert(self, model):
        """Replace QAT wrappers with real-int8 deploy layers."""
        for name, child in list(model.named_children()):
            if isinstance(child, _QATWrapper):
                inner = child.inner
                if type(inner).__name__ == "Linear":
                    setattr(model, name, QuantedLinear.from_float(
                        inner, child._obs.scale, self.config))
                # Conv stays fake-quant folded: bake quantized weights
                else:
                    w = inner.weight
                    ws = quant_absmax_scale(w.value.detach(), axis=0,
                                            bits=self.config.weight_bits)
                    inner.weight.set_value(fake_quantize(
                        w, Tensor(ws.reshape((-1,) + (1,) * (w.ndim - 1))),
                        bits=self.config.weight_bits))
                    setattr(model, name, inner)
            else:
                self.convert(child)
        return model


class QuantedLinear(nn.Layer):
    """Deploy-time int8 linear: stored int8 weights, int8 x int8 -> int32
    products (``torch._int_mm``)."""

    def __init__(self, w_int8, w_scale, bias, a_scale):
        super().__init__()
        self.w_int8 = w_int8              # torch int8 [in, out]
        self.w_scale = w_scale            # [out] fp32
        self.bias = bias                  # Tensor | None
        self.a_scale = a_scale            # fp32 device scalar

    @classmethod
    def from_float(cls, linear, a_scale, config: QuantConfig):
        if a_scale is None:
            raise ValueError(
                "convert() before calibration: run at least one forward "
                "pass (QAT training or PTQ calibration batches) so the "
                "activation observers have scales")
        w = linear.weight.value.detach()
        qmax = 2.0 ** (config.weight_bits - 1) - 1
        ws = quant_absmax_scale(w, axis=1, bits=config.weight_bits)
        w_int8 = _round_clip(w / ws[None, :], qmax).to(torch.int8)
        a_scale = torch.as_tensor(a_scale, dtype=torch.float32,
                                  device=w.device).detach().reshape(())
        return cls(w_int8, ws, getattr(linear, "bias", None), a_scale)

    def forward(self, x):
        out = int8_matmul(x, Tensor(self.w_int8), Tensor(self.a_scale),
                          Tensor(self.w_scale))
        if self.bias is not None:
            out = out + self.bias
        return out


# --------------------------------------------------------------------------
# post-training quantization
# --------------------------------------------------------------------------

class PostTrainingQuantization:
    """Calibrate activation scales on sample batches, then convert
    (ref post_training_quantization.py:123 -- there it drives an Executor
    over a program; here it drives the eager model directly)."""

    def __init__(self, model, config: QuantConfig | None = None):
        self.model = model
        self.config = config or QuantConfig()
        self._qat = QAT(self.config)

    def quantize(self, calib_batches):
        """calib_batches: iterable of model inputs (Tensor or tuple)."""
        from ..autograd import no_grad
        self._qat.quantize(self.model)
        with no_grad():
            for batch in calib_batches:
                if isinstance(batch, (tuple, list)):
                    self.model(*batch)
                else:
                    self.model(batch)
        return self._qat.convert(self.model)

    def save_quantized_model(self, path, input_spec=None):
        """``inference.export.save_inference_model`` of the converted
        model: ``<path>.pt2`` (``torch.export``) and its manifest, which
        is returned."""
        from ..inference.export import save_inference_model
        if input_spec is None:
            raise ValueError("input_spec required")
        return save_inference_model(path, self.model, input_spec)
