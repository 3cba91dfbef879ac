"""Quantization helpers of the port: copies of
``paddle_tpu/quantization/__init__.py``'s ``quant_absmax_scale``,
``_int8_mm_core`` and ``int8_dynamic_matmul`` (that module imports JAX, so
the port keeps its own), with the same ops in the same dtypes.
"""
from __future__ import annotations

import torch

__all__ = ["quant_absmax_scale", "int8_dynamic_matmul"]

# torch._int_mm on CUDA takes more than 16 rows
_INT_MM_MIN_ROWS = 17


def quant_absmax_scale(x, axis=None, bits=8):
    """absmax scale so ``x / scale`` fits [-qmax, qmax]: per tensor, or
    per channel when ``axis`` is given (an int keeps that axis, a tuple
    keeps several, e.g. the per-output-channel scales of a stacked
    [L, K, ...] weight keep every axis but the contraction)."""
    v = torch.as_tensor(x)
    qmax = 2.0 ** (bits - 1) - 1
    if axis is None:
        s = v.abs().max() / qmax
    else:
        keep = (axis,) if isinstance(axis, int) else tuple(axis)
        keep = tuple(a % v.dim() for a in keep)
        red = tuple(i for i in range(v.dim()) if i not in keep)
        s = torch.amax(v.abs(), dim=red) / qmax if red else v.abs() / qmax
    return torch.clamp(s, min=1e-8)


def _int8_mm(a, b):
    """int8 [M, K] @ int8 [K, N] -> int32 [M, N], exact (``torch._int_mm``,
    the library's int8 GEMM; the reference uses ``lax.dot_general`` with an
    int32 result).  Rows are padded with zeros up to the CUDA minimum."""
    M = a.shape[0]
    if a.is_cuda and M < _INT_MM_MIN_ROWS:
        pad = torch.zeros((32 - M, a.shape[1]), dtype=a.dtype,
                          device=a.device)
        return torch._int_mm(torch.cat([a, pad]), b)[:M]
    return torch._int_mm(a, b)


def _int8_mm_core(x, w, xs, ws):
    """Quantize x with scale ``xs``, int8 x int8 -> int32, rescale:
    ``acc * (xs * ws)`` in fp32."""
    xq = torch.clamp(torch.round(x / xs), -127, 127).to(torch.int8)
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
