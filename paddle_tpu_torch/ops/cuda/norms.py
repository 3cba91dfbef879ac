"""Row LayerNorm and RMSNorm: the CUDA kernels ``csrc/layer_norm.cu`` and
their plain PyTorch versions.

Counterpart of ``paddle_tpu/ops/pallas/norms.py``: the kernels replace
``_ln_kernel`` and ``_rms_kernel`` (launched by ``_pallas_norm`` through
``layer_norm`` and ``rms_norm``), and :func:`_ref_layer_norm` and
:func:`_ref_rms_norm` mirror ``_ref_layer_norm`` and ``_ref_rms_norm``.

:func:`layer_norm` and :func:`rms_norm` are ``torch.autograd.Function``s,
as the reference's are ``jax.custom_vjp``s: the forward takes the plain
version for a tensor on the CPU and launches the kernel for a tensor on a
CUDA device, never falling back from one to the other; the backward is
autograd of the plain version recomputed from the saved inputs (the
reference's ``_ln_bwd`` and ``_rms_bwd``; no backward kernel exists there
either).

Each forward is one ``torch.library`` op, ``paddle_tpu::layer_norm`` and
``paddle_tpu::rms_norm``, so that ``torch.export`` records it as one node
(``inference/export.py``): its CPU implementation is the plain version,
its CUDA implementation checks its inputs, launches the kernel and counts
the launch, and its fake implementation gives the output's shape and
dtype without reading data.  A call that needs no gradient calls the op;
one that does goes through the ``autograd.Function``, whose forward is
the same op.  ``launches`` counts LayerNorm kernel launches and
``rms_launches`` RMSNorm kernel launches.  The reference's ``_tileable``
gate has no counterpart: every CUDA tensor launches the kernel, whatever
its H (one-element loads where rows are not 16-byte aligned, rows read
again from L2 where they are too wide for registers).  A strided x is
copied to contiguous rows first.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0
rms_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fns = None


def _ref_layer_norm(x, g, b, eps):
    """Plain PyTorch LayerNorm over the last axis: fp32 mean and two-pass
    variance, fp32 affine, cast back to ``x.dtype``."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * g.float() + b.float()).to(x.dtype)


def _ref_rms_norm(x, g, eps):
    """Plain PyTorch RMSNorm over the last axis: fp32 mean of x^2,
    ``x * rsqrt(ms + eps) * g`` in fp32, cast back to ``x.dtype``."""
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * g.float()).to(x.dtype)


def _kernels():
    global _fns
    if _fns is None:
        lib = build.load("layer_norm")
        ln = lib.pt_layer_norm_fwd
        ln.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        rms = lib.pt_rms_norm_fwd
        rms.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        ln.restype = rms.restype = ctypes.c_int
        lib.pt_error_string.argtypes = [ctypes.c_int]
        lib.pt_error_string.restype = ctypes.c_char_p
        _fns = (lib, ln, rms)
    return _fns


def _check_cuda(x, g, b):
    H = x.shape[-1]
    dev = x.device
    for name, t in (("x", x), ("g", g), ("b", b)):
        if t.device != dev:
            raise ValueError(f"layer_norm: {name} on {t.device}, x on {dev}")
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"layer_norm: {name} dtype {t.dtype}; the kernel "
                            "takes float32 or bfloat16")
    if g.dtype != b.dtype:
        raise TypeError(f"layer_norm: g is {g.dtype} but b is {b.dtype}")
    if g.shape != (H,) or b.shape != (H,):
        raise ValueError(f"layer_norm: g {tuple(g.shape)} and b "
                         f"{tuple(b.shape)} must be [{H}]")


def _forward(x, g, b, eps):
    """``paddle_tpu::layer_norm`` on CUDA tensors: the kernel."""
    global launches
    _check_cuda(x, g, b)
    # the kernel reads contiguous rows: a strided view is copied once
    # (any H and any alignment go in as they are)
    x, g, b = (t.contiguous() for t in (x, g, b))
    rows = x.numel() // max(x.shape[-1], 1)
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    lib, fn, _ = _kernels()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
                 rows, x.shape[-1], float(eps), _DTYPE_CODE[x.dtype],
                 _DTYPE_CODE[g.dtype], stream)
    build.check(lib, err, "layer_norm")
    launches += 1
    return y


def _plain_grads(ref, ctx, n_in, dy):
    """Gradients of the first ``n_in`` inputs: autograd of the plain
    version ``ref`` recomputed from the saved inputs and ``ctx.eps``."""
    need = ctx.needs_input_grad[:n_in]
    ins = [t.detach().requires_grad_(n)
           for t, n in zip(ctx.saved_tensors, need)]
    with torch.enable_grad():
        y = ref(*ins, ctx.eps)
        wrt = [t for t, n in zip(ins, need) if n]
        got = iter(torch.autograd.grad(y, wrt, dy))
    return tuple(next(got) if n else None for n in need)


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, b, eps):
        ctx.save_for_backward(x, g, b)
        ctx.eps = eps
        return torch.ops.paddle_tpu.layer_norm(x, g, b, eps)

    @staticmethod
    def backward(ctx, dy):
        return (*_plain_grads(_ref_layer_norm, ctx, 3, dy), None)


def layer_norm(x, g, b, eps=1e-5):
    """LayerNorm over the last axis.  x: [..., H] float32 or bfloat16, any
    H >= 1, any strides; g, b: [H] float32 or bfloat16.  Returns x's
    shape and dtype; differentiable in x, g and b."""
    return _LayerNorm.apply(x, g, b, eps)


def _check_rms_cuda(x, g):
    H = x.shape[-1]
    for name, t in (("x", x), ("g", g)):
        if t.device != x.device:
            raise ValueError(f"rms_norm: {name} on {t.device}, x on "
                             f"{x.device}")
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"rms_norm: {name} dtype {t.dtype}; the kernel "
                            "takes float32 or bfloat16")
    if g.shape != (H,):
        raise ValueError(f"rms_norm: g {tuple(g.shape)} must be [{H}]")


def _rms_forward(x, g, eps):
    """``paddle_tpu::rms_norm`` on CUDA tensors: the kernel."""
    global rms_launches
    _check_rms_cuda(x, g)
    # as for LayerNorm: a strided view is copied to rows once (any
    # alignment goes in as it is)
    x, g = x.contiguous(), g.contiguous()
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    lib, _, fn = _kernels()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), g.data_ptr(), y.data_ptr(),
                 x.numel() // x.shape[-1], x.shape[-1], float(eps),
                 _DTYPE_CODE[x.dtype], _DTYPE_CODE[g.dtype], stream)
    build.check(lib, err, "rms_norm")
    rms_launches += 1
    return y


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, eps):
        ctx.save_for_backward(x, g)
        ctx.eps = eps
        return torch.ops.paddle_tpu.rms_norm(x, g, eps)

    @staticmethod
    def backward(ctx, dy):
        return (*_plain_grads(_ref_rms_norm, ctx, 2, dy), None)


def rms_norm(x, g, eps=1e-6):
    """RMSNorm over the last axis.  x: [..., H] float32 or bfloat16, any
    H >= 1, any strides; g: [H] float32 or bfloat16.  Returns x's shape and dtype;
    differentiable in x and g."""
    if _needs_grad(x, g):
        return _RMSNorm.apply(x, g, float(eps))
    return torch.ops.paddle_tpu.rms_norm(x, g, float(eps))


def _needs_grad(*ts):
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


# the ops (module docstring); the CPU implementations return contiguous
# rows, as the kernels do
_LIB = torch.library.Library("paddle_tpu", "FRAGMENT")
_LIB.define("layer_norm(Tensor x, Tensor g, Tensor b, float eps) -> Tensor")
_LIB.define("rms_norm(Tensor x, Tensor g, float eps) -> Tensor")
_LIB.impl("layer_norm", lambda x, g, b, eps: _ref_layer_norm(
    x, g, b, eps).contiguous(), "CPU")
_LIB.impl("layer_norm", _forward, "CUDA")
_LIB.impl("rms_norm", lambda x, g, eps: _ref_rms_norm(x, g, eps).contiguous(),
          "CPU")
_LIB.impl("rms_norm", _rms_forward, "CUDA")


@torch.library.register_fake("paddle_tpu::layer_norm", lib=_LIB)
def _layer_norm_fake(x, g, b, eps):
    return x.new_empty(x.shape)


@torch.library.register_fake("paddle_tpu::rms_norm", lib=_LIB)
def _rms_norm_fake(x, g, eps):
    return x.new_empty(x.shape)
