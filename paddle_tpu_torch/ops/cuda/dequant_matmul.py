"""Weight-only int8 matmul: the CUDA kernel ``csrc/dequant_matmul.cu`` and
its plain PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas/dequant_matmul.py``: the kernel
replaces ``_dqmm_kernel`` (launched by ``_dqmm_tpu``), and
:func:`_ref_dequant_matmul` mirrors that module's ``_ref_dequant_matmul``
op for op.  Inference only.

:func:`dequant_matmul` takes the plain version for tensors on the CPU and
launches the kernel for tensors on a CUDA device, for int8 weights only; it
never falls back from one to the other.  ``launches`` counts kernel
launches.  The TPU wrapper pads M up to the sublane minimum; the CUDA
kernel masks its ragged tiles, so any M >= 1 goes in as it is.

The kernel rounds once (``(x @ w_q) * scale`` in fp32, then to x's dtype);
the plain version, like the JAX fallback, rounds the product and then the
scaled product, so in bf16 the two differ by a few ulps.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build

launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BM = _BN = 64                # the kernel's output tile
_BLOCKS_PER_SM = 4            # split K until about this many blocks an SM
_fn = None
_tickets = {}                 # device -> int32 split-K tickets (kept at 0)


def _ref_dequant_matmul(x2d, w_q, scale):
    """``x2d @ w_q.to(x.dtype)``, then times ``scale`` cast to x's dtype.
    The per-output-channel scale factors out of the contraction, so this
    is the kernel's function; it rounds twice where the kernel rounds
    once."""
    y = x2d @ w_q.to(x2d.dtype)
    return y * scale.reshape(1, -1).to(x2d.dtype)


def _kernel():
    global _fn
    if _fn is None:
        lib = build.load("dequant_matmul")
        fn = lib.pt_dequant_matmul
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong]
                       + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.pt_dequant_matmul_bk.argtypes = [ctypes.c_int]
        lib.pt_dequant_matmul_bk.restype = ctypes.c_int
        lib.pt_error_string.argtypes = [ctypes.c_int]
        lib.pt_error_string.restype = ctypes.c_char_p
        _fn = (lib, fn)
    return _fn


def _split(M, N, K, bk, target):
    """(k steps per split, splits): split K only when the output tiles
    alone give fewer than ``target`` blocks; every split gets at least
    one k step."""
    tiles = -(-M // _BM) * -(-N // _BN)
    steps = -(-K // bk)
    want = min(steps, max(1, -(-target // tiles)))
    tpb = -(-steps // want)
    return tpb, -(-steps // tpb)


@functools.lru_cache(maxsize=None)
def _sm_count(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _ticket_buffer(dev, n):
    buf = _tickets.get(dev)
    if buf is None or buf.numel() < n:
        # zeroed once; each launch's last split resets its tiles to 0
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=dev)
        _tickets[dev] = buf
    return buf


def _rows(x, K):
    """x [..., K] as rows of K elements ``lda`` apart, without a copy when
    its strides allow one; returns (x2d, lda)."""
    M = math.prod(x.shape[:-1])
    try:
        x2 = x.view(M, K)
    except RuntimeError:
        x2 = x.reshape(M, K)                    # not viewable: a copy
    lda = x2.stride(0) if M > 1 else K
    if (x2.stride(1) != 1 or lda < K or lda % (16 // x.element_size())
            or x2.data_ptr() % 16):
        x2, lda = x2.clone(memory_format=torch.contiguous_format), K
    return x2, lda


def _check_cuda(x, w_q, scale):
    dev = x.device
    for name, t in (("w_q", w_q), ("scale", scale)):
        if t.device != dev:
            raise ValueError(
                f"dequant_matmul: {name} on {t.device}, x on {dev}")
    if w_q.dtype != torch.int8:
        raise TypeError(f"dequant_matmul: weight dtype {w_q.dtype}; the "
                        "CUDA kernel takes int8 weights only")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"dequant_matmul: x dtype {x.dtype}; the kernel "
                        "takes float32 or bfloat16")
    if scale.dtype != torch.float32:
        raise TypeError(f"dequant_matmul: scale dtype {scale.dtype}; "
                        "expected float32")
    if w_q.dim() != 2 or not w_q.is_contiguous() or w_q.data_ptr() % 16:
        raise ValueError("dequant_matmul: w_q must be a contiguous, 16-byte "
                         f"aligned [K, N] matrix, got {tuple(w_q.shape)}")
    K, N = w_q.shape
    if x.shape[-1] != K:
        raise ValueError(f"dequant_matmul: x [..., {x.shape[-1]}] against "
                         f"w_q [{K}, {N}]")
    if scale.numel() != N:
        raise ValueError(f"dequant_matmul: scale has {scale.numel()} "
                         f"elements for N={N}")
    if N % 16 or K % 8:
        raise ValueError(f"dequant_matmul: K={K} must be a multiple of 8 "
                         f"and N={N} of 16 (16-byte weight and row loads)")


def dequant_matmul(x, w_q, scale):
    """x [..., K] @ weight-only quantized ``w_q`` [K, N] -> [..., N] in
    x's dtype.  ``scale``: per-output-channel fp32, any shape of N
    elements (``[N]`` or ``[1, N]``)."""
    global launches
    K, N = w_q.shape
    lead = x.shape[:-1]
    if x.device.type == "cpu":
        M = math.prod(lead)
        out = _ref_dequant_matmul(x.reshape(M, K), w_q, scale)
        return out.reshape(*lead, N)
    if x.device.type != "cuda":
        raise ValueError(f"dequant_matmul: unsupported device {x.device}")
    _check_cuda(x, w_q, scale)
    x2, lda = _rows(x, K)
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out.reshape(*lead, N)
    s = scale.reshape(N)
    if not s.is_contiguous():
        s = s.contiguous()
    lib, fn = _kernel()
    tpb, ksplit = _split(
        M, N, K, lib.pt_dequant_matmul_bk(_DTYPE_CODE[x.dtype]),
        _BLOCKS_PER_SM * _sm_count(x.device))
    ws = tickets = None
    if ksplit > 1:
        ws = torch.empty((ksplit, M, N), dtype=torch.float32,
                         device=x.device)
        tickets = _ticket_buffer(x.device, -(-M // _BM) * -(-N // _BN))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x2.data_ptr(), lda, w_q.data_ptr(), s.data_ptr(),
                 out.data_ptr(), 0 if ws is None else ws.data_ptr(),
                 0 if tickets is None else tickets.data_ptr(),
                 M, N, K, tpb, ksplit, _DTYPE_CODE[x.dtype], stream)
    build.check(lib, err, "dequant_matmul")
    launches += 1
    return out.reshape(*lead, N)
