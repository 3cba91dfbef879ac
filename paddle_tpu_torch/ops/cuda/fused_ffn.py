"""Fused transformer FFN: the CUDA kernel ``csrc/fused_ffn.cu`` and its
plain PyTorch versions.

Counterpart of ``paddle_tpu/ops/pallas/fused_ffn.py``: the kernel replaces
``_ffn_kernel`` (launched by ``_fused_ffn_tpu``).  :func:`_ref_ffn` mirrors
that module's ``_ref_ffn`` op for op, in x's dtype; :func:`_ref_fused_ffn`
is the plain version of the kernel's own function, which rounds h to x's
dtype once and the output once (fp32 products, b1, gelu and b2 in fp32, as
``_ffn_kernel`` does).  In float32 the two are the same function.

:func:`fused_ffn` takes ``[..., H]``.  For tensors on the CPU it is
:func:`_ref_ffn`, as the reference falls back to its ``_ref_ffn`` off the
TPU.  For CUDA tensors (float32 or bfloat16, H a multiple of 8 up to 2048)
it is a ``torch.autograd.Function`` whose forward launches the kernel, or
raises, and whose backward is autograd of :func:`_ref_ffn`: the reference's
``_ffn_bwd`` is ``jax.vjp(_ref_ffn)``, with no backward kernel.  The TPU's
``_pick_blocks`` layout rules (H and F multiples of 128, M a multiple of
the sublane minimum) do not carry over: the kernel masks ragged row and F
tiles, so any M goes in as it is, and H and F need only be multiples of 8
(16-byte row loads), H at most 2048.  In bf16 the wrapper hands the kernel
the two weights transposed (one copy each a call), so that a thread loads
16 contiguous bytes of each B fragment.  ``launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import build

launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fns = None


def set_default_blocks(blocks=None):
    """The reference's ``(block_m, block_f)`` tiling override.  The kernel's
    tiles are fixed (32 rows a two-block cluster in bf16, 16 a block in
    float32; F tiles of 128 and 32), so anything but ``None`` raises."""
    if blocks is not None:
        raise NotImplementedError(
            "fused FFN tiles are fixed in csrc/fused_ffn.cu; a (block_m, "
            "block_f) override is not ported")


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _ref_ffn(x, w1, b1, w2, b2):
    """``gelu_tanh(x @ w1 + b1) @ w2 + b2`` with every operand cast to x's
    dtype first: the reference's ``_ref_ffn`` op for op."""
    dt = x.dtype
    h = F.gelu(x @ w1.to(dt) + b1.to(dt), approximate="tanh")
    return h @ w2.to(dt) + b2.to(dt)


def _ref_fused_ffn(x, w1, b1, w2, b2):
    """Plain version of the kernel: fp32 products from the stored values,
    b1 and gelu in fp32, h rounded once to x's dtype, the second product
    and b2 in fp32, the output rounded once."""
    dt = x.dtype
    h = x.float() @ w1.to(dt).float() + b1.to(dt).float()
    h = F.gelu(h, approximate="tanh").to(dt).float()
    return (h @ w2.to(dt).float() + b2.to(dt).float()).to(dt)


# --------------------------------------------------------------------------
# kernel
# --------------------------------------------------------------------------

def _kernel():
    global _fns
    if _fns is None:
        lib = build.load("fused_ffn")
        fn = lib.pt_fused_ffn
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.pt_error_string.argtypes = [ctypes.c_int]
        lib.pt_error_string.restype = ctypes.c_char_p
        _fns = (lib, fn)
    return _fns


_MAX_H = 2048     # csrc/fused_ffn.cu MAX_H: the fp32 accumulator a block holds


def _check_cuda(x, w1, b1, w2, b2):
    dev = x.device
    H = x.shape[-1]
    for name, t in (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if t.device != dev:
            raise ValueError(f"fused_ffn: {name} on {t.device}, x on {dev}")
        if t.dtype != x.dtype:
            raise TypeError(f"fused_ffn: {name} is {t.dtype}, x is {x.dtype};"
                            " the kernel takes every operand in x's dtype")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_ffn: dtype {x.dtype}; the kernel takes "
                        "float32 or bfloat16")
    if w1.dim() != 2 or w1.shape[0] != H:
        raise ValueError(f"fused_ffn: w1 {tuple(w1.shape)} must be [{H}, F]")
    Fd = w1.shape[1]
    if w2.shape != (Fd, H) or b1.shape != (Fd,) or b2.shape != (H,):
        raise ValueError(f"fused_ffn: w2 {tuple(w2.shape)}, b1 "
                         f"{tuple(b1.shape)}, b2 {tuple(b2.shape)} must be "
                         f"[{Fd}, {H}], [{Fd}], [{H}]")
    if H % 8 or H > _MAX_H:
        raise ValueError(f"fused_ffn: H={H}; the kernel takes H a multiple "
                         f"of 8 up to {_MAX_H} (a block holds its rows' "
                         "fp32 accumulator in registers)")
    if Fd % 8:
        raise ValueError(f"fused_ffn: F={Fd}; the kernel takes F a multiple "
                         "of 8 (16-byte weight row loads)")


def _launch(x, w1, b1, w2, b2):
    """The kernel on x [..., H]; no autograd."""
    global launches
    H = x.shape[-1]
    lead = x.shape[:-1]
    M = math.prod(lead)
    x2 = x.reshape(M, H)
    if not x2.is_contiguous() or x2.data_ptr() % 16:    # 16-byte row loads
        x2 = x2.clone(memory_format=torch.contiguous_format)
    if x.dtype == torch.bfloat16:           # the kernel reads w1t, w2t
        w1, w2 = w1.t(), w2.t()
    ops = [x2] + [t if t.is_contiguous() else t.contiguous()
                  for t in (w1, b1, w2, b2)]
    out = torch.empty((M, H), dtype=x.dtype, device=x.device)
    if M == 0:
        return out.reshape(*lead, H)
    lib, fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*(t.data_ptr() for t in ops), out.data_ptr(), M, H,
                 b1.shape[0], _DTYPE_CODE[x.dtype], stream)
    build.check(lib, err, "fused_ffn")
    launches += 1
    return out.reshape(*lead, H)


class _FusedFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return _launch(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        ins = [t.detach().requires_grad_(t.requires_grad)
               for t in ctx.saved_tensors]
        want = [t for t in ins if t.requires_grad]
        with torch.enable_grad():
            y = _ref_ffn(*ins)
        got = iter(torch.autograd.grad(y, want, g) if want else ())
        return tuple(next(got) if t.requires_grad else None for t in ins)


def fused_ffn(x, w1, b1, w2, b2):
    """``gelu_tanh(x @ w1 + b1) @ w2 + b2`` for x [..., H], w1 [H, F], b1
    [F], w2 [F, H], b2 [H] -> [..., H] in x's dtype.  CPU tensors:
    :func:`_ref_ffn`.  CUDA tensors: the kernel, with the backward of
    :func:`_ref_ffn`."""
    if x.device.type == "cpu":
        return _ref_ffn(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ffn: unsupported device {x.device}")
    _check_cuda(x, w1, b1, w2, b2)
    return _FusedFFN.apply(x, w1, b1, w2, b2)


def fused_ffn_fwd(x, w1, b1, w2, b2):
    """The kernel alone, no autograd.  For checks and timing beside
    :func:`_ref_fused_ffn`."""
    _check_cuda(x, w1, b1, w2, b2)
    return _launch(x, w1, b1, w2, b2)
