"""Fused transformer FFN: the CUDA kernel ``csrc/fused_ffn.cu`` and its
plain PyTorch versions.

Counterpart of ``paddle_tpu/ops/pallas/fused_ffn.py``: the kernel replaces
``_ffn_kernel`` (launched by ``_fused_ffn_tpu``).  :func:`_ref_ffn` mirrors
that module's ``_ref_ffn`` op for op, in x's dtype; :func:`_ref_fused_ffn`
is the plain version of the kernel's own function, which rounds h to x's
dtype once and the output once (fp32 products, b1, gelu and b2 in fp32, as
``_ffn_kernel`` does).  In float32 the two are the same function.

:func:`fused_ffn` takes ``[..., H]`` and is the custom op
``paddle_tpu_torch::fused_ffn``: its body is :func:`_ref_ffn` for tensors
on the CPU, as the reference falls back to its ``_ref_ffn`` off the TPU,
and the kernel for CUDA tensors (float32 or bfloat16), which launches or
raises.  Its backward is autograd of :func:`_ref_ffn` recomputed from the
inputs: the reference's ``_ffn_bwd`` is ``jax.vjp(_ref_ffn)``, with no
backward kernel, and it keeps only the inputs as residuals.  Being an op
that the dispatcher sees, a selective-checkpoint policy can save its output
(``models/gpt.py`` does under remat), so a recompute in the backward never
runs the body again: the counterpart of XLA dropping the reference's
unread recomputed ``pallas_call``.

The TPU's ``_pick_blocks`` layout rules (H and F multiples of 128, M a
multiple of the sublane minimum) do not carry over: the kernel masks
ragged row, column and F tiles itself and takes the weights as stored.  It
needs H and F multiples of 8 (16-byte rows for TMA), so the wrapper
zero-pads other widths (:func:`_padded`): zero x columns and w1 rows for H,
zero w1 columns, b1 and w2 rows for F (gelu(0) times a zero row adds
nothing), then slices the output back to H.  ``launches`` counts kernel
launches; ``bodies`` counts runs of the op's body on either device.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import build

launches = 0
bodies = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fns = None


def set_default_blocks(blocks=None):
    """The reference's ``(block_m, block_f)`` tiling override.  The kernel's
    tiles are fixed (128 rows a cluster in bf16, 16 a block in float32; F
    tiles of 64 and 32), so anything but ``None`` raises."""
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


def _padded(fn, x, w1, b1, w2, b2):
    """``fn`` on x [M, H] and the weights zero-padded to H and F multiples
    of 8, its output sliced back to [M, H].  Exact: padded x columns meet
    zero w1 rows, padded F columns give gelu(0 + 0) = 0 against zero w2
    rows, and padded output columns are dropped."""
    H, Fd = w1.shape
    ph, pf = -H % 8, -Fd % 8
    if ph == 0 and pf == 0:
        return fn(x, w1, b1, w2, b2)
    x = F.pad(x, (0, ph))
    w1 = F.pad(w1, (0, pf, 0, ph))
    b1 = F.pad(b1, (0, pf))
    w2 = F.pad(w2, (0, ph, 0, pf))
    b2 = F.pad(b2, (0, ph))
    return fn(x, w1, b1, w2, b2)[:, :H].contiguous()


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


def _kernel_operand(t):
    """``t`` contiguous and 16-byte aligned (TMA and the 16-byte row
    loads); a copy only where it is not."""
    if not t.is_contiguous() or t.data_ptr() % 16:
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def _kernel_2d(x, w1, b1, w2, b2):
    """The kernel on x [M, H] with H and F multiples of 8."""
    global launches
    M, H = x.shape
    ops = [_kernel_operand(t) for t in (x, w1, b1, w2, b2)]
    out = torch.empty((M, H), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    lib, fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*(t.data_ptr() for t in ops), out.data_ptr(), M, H,
                 w1.shape[1], _DTYPE_CODE[x.dtype], stream)
    build.check(lib, err, "fused_ffn")
    launches += 1
    return out


def _launch(x, w1, b1, w2, b2):
    """The kernel on x [..., H], padded as it needs; no autograd."""
    H = x.shape[-1]
    lead = x.shape[:-1]
    out = _padded(_kernel_2d, x.reshape(math.prod(lead), H), w1, b1, w2, b2)
    return out.reshape(*lead, H)


@torch.library.custom_op("paddle_tpu_torch::fused_ffn", mutates_args=())
def _ffn_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
            w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    global bodies
    bodies += 1
    if x.device.type == "cpu":
        return _ref_ffn(x, w1, b1, w2, b2)
    return _launch(x, w1, b1, w2, b2)


@_ffn_op.register_fake
def _(x, w1, b1, w2, b2):
    return torch.empty_like(x)


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, g):
    ins = [t.detach().requires_grad_(n)
           for t, n in zip(ctx.saved_tensors, ctx.needs_input_grad)]
    want = [t for t in ins if t.requires_grad]
    with torch.enable_grad():
        y = _ref_ffn(*ins)
    got = iter(torch.autograd.grad(y, want, g) if want else ())
    return tuple(next(got) if t.requires_grad else None for t in ins)


_ffn_op.register_autograd(_backward, setup_context=_setup_context)

#: the op a checkpoint policy names to keep the FFN's output
op = torch.ops.paddle_tpu_torch.fused_ffn.default


def fused_ffn(x, w1, b1, w2, b2):
    """``gelu_tanh(x @ w1 + b1) @ w2 + b2`` for x [..., H], w1 [H, F], b1
    [F], w2 [F, H], b2 [H] -> [..., H] in x's dtype.  CPU tensors:
    :func:`_ref_ffn`.  CUDA tensors: the kernel.  Either way the backward
    is autograd of :func:`_ref_ffn`."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_ffn: unsupported device {x.device}")
    if x.device.type == "cuda":
        _check_cuda(x, w1, b1, w2, b2)
    return _ffn_op(x, w1, b1, w2, b2)


def fused_ffn_fwd(x, w1, b1, w2, b2):
    """The kernel alone, no autograd.  For checks and timing beside
    :func:`_ref_fused_ffn`."""
    _check_cuda(x, w1, b1, w2, b2)
    return _launch(x, w1, b1, w2, b2)
