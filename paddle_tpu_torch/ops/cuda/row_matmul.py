"""Row-invariant matrix product: the CUDA kernel ``csrc/row_matmul.cu`` and
its plain PyTorch version.

It replaces no TPU kernel.  It keeps the reference's commit-bytes contract
on the card (``paddle_tpu/models/gpt.py:1103`` ``_paged_verify_block``):
the lanes a speculative verify accepts commit the bytes a sequential
decode writes.  The verify runs a block's weight products at M = S * W
rows and the decode at M = S; cuBLAS sums each output in an order it
picks from M, so the two round differently.  The kernel's order is fixed
by K and N alone, so every output row's bits depend only on that row of x
and on W (see the source's notes).  ``models.gpt.block_apply`` routes
float weights through :func:`matmul` on the two paths whose pool writes
that contract compares: the paged decode and the fp verify.

:func:`matmul` takes the plain version, ``x @ w`` in the compute dtype,
for tensors on the CPU (bit-equal to the reference there) and launches
the kernel for CUDA tensors, never falling back from one to the other.
It is a forward only: on the card it refuses inputs that need a gradient.
``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fns = None


def _ref_matmul(x, w):
    """The plain version: ``x @ w`` (cuBLAS on the card, the CPU's BLAS
    here), x [..., K], w [K, N] of one dtype."""
    return x @ w


def _kernels():
    global _fns
    if _fns is None:
        lib = build.load("row_matmul")
        fn = lib.pt_row_matmul
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.pt_error_string.argtypes = [ctypes.c_int]
        lib.pt_error_string.restype = ctypes.c_char_p
        _fns = (lib, fn)
    return _fns


def matmul(x, w):
    """x [..., K] @ w [K, N] -> [..., N] in x's dtype (float32 or
    bfloat16; w of the same dtype and device)."""
    global launches
    if x.device.type == "cpu":
        return _ref_matmul(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"row_matmul: unsupported device {x.device}")
    if w.device != x.device:
        raise ValueError(f"row_matmul: w on {w.device}, x on {x.device}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"row_matmul: x {x.dtype}, w {w.dtype}; the kernel "
                        "takes float32 or bfloat16, both the same")
    if w.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"row_matmul: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} do not multiply")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("row_matmul: the kernel is a forward only; run "
                           "it under no_grad or inference_mode")
    K, N = w.shape
    x2 = x.reshape(-1, K).contiguous()
    w = w.contiguous()
    M = x2.shape[0]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M and N:
        lib, fn = _kernels()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fn(x2.data_ptr(), w.data_ptr(), y.data_ptr(), M, K, N,
                     _DTYPE_CODE[x.dtype], stream)
        build.check(lib, err, "row_matmul")
        launches += 1
    return y.reshape(*x.shape[:-1], N)
