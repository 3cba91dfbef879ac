"""Row LayerNorm: the CUDA kernel ``csrc/layer_norm.cu`` and its plain
PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas/norms.py``: the kernel replaces
``_ln_kernel`` (launched by ``_pallas_norm`` through ``layer_norm``), and
:func:`_ref_layer_norm` mirrors ``_ref_layer_norm``.

:func:`layer_norm` is a ``torch.autograd.Function``, as the reference's is
a ``jax.custom_vjp``: its forward takes the plain version for a tensor on
the CPU and launches the kernel for a tensor on a CUDA device, never
falling back from one to the other; its backward is autograd of
:func:`_ref_layer_norm` recomputed from the saved ``x, g, b`` (the
reference's ``_ln_bwd``; no backward kernel exists there either).
``launches`` counts forward kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _ref_layer_norm(x, g, b, eps):
    """Plain PyTorch LayerNorm over the last axis: fp32 mean and two-pass
    variance, fp32 affine, cast back to ``x.dtype``."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * g.float() + b.float()).to(x.dtype)


def _kernel():
    global _fn
    if _fn is None:
        lib = build.load("layer_norm")
        fn = lib.pt_layer_norm_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.pt_error_string.argtypes = [ctypes.c_int]
        lib.pt_error_string.restype = ctypes.c_char_p
        _fn = (lib, fn)
    return _fn


def _check_cuda(x, g, b):
    H = x.shape[-1]
    dev = x.device
    for name, t in (("x", x), ("g", g), ("b", b)):
        if t.device != dev:
            raise ValueError(f"layer_norm: {name} on {t.device}, x on {dev}")
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"layer_norm: {name} dtype {t.dtype}; the kernel "
                            "takes float32 or bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"layer_norm: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"layer_norm: {name} is not 16-byte aligned")
    if g.dtype != b.dtype:
        raise TypeError(f"layer_norm: g is {g.dtype} but b is {b.dtype}")
    if g.shape != (H,) or b.shape != (H,):
        raise ValueError(f"layer_norm: g {tuple(g.shape)} and b "
                         f"{tuple(b.shape)} must be [{H}]")
    vec = 16 // x.element_size()
    if H % vec or H > 32 * 32 * 8 * vec:
        raise ValueError(f"layer_norm: H={H} must be a multiple of {vec} "
                         f"and at most {32 * 32 * 8 * vec} for {x.dtype}")


def _forward(x, g, b, eps):
    global launches
    if x.device.type == "cpu":
        return _ref_layer_norm(x, g, b, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: unsupported device {x.device}")
    _check_cuda(x, g, b)
    rows = x.numel() // x.shape[-1]
    y = torch.empty_like(x)
    if rows == 0:
        return y
    lib, fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
                 rows, x.shape[-1], float(eps), _DTYPE_CODE[x.dtype],
                 _DTYPE_CODE[g.dtype], stream)
    build.check(lib, err, "layer_norm")
    launches += 1
    return y


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, b, eps):
        ctx.save_for_backward(x, g, b)
        ctx.eps = eps
        return _forward(x, g, b, eps)

    @staticmethod
    def backward(ctx, dy):
        need = ctx.needs_input_grad[:3]
        ins = [t.detach().requires_grad_(n)
               for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            y = _ref_layer_norm(*ins, ctx.eps)
            wrt = [t for t, n in zip(ins, need) if n]
            got = iter(torch.autograd.grad(y, wrt, dy))
        return (*(next(got) if n else None for n in need), None)


def layer_norm(x, g, b, eps=1e-5):
    """LayerNorm over the last axis.  x: [..., H] float32 or bfloat16;
    g, b: [H] float32 or bfloat16.  Returns x's shape and dtype;
    differentiable in x, g and b."""
    return _LayerNorm.apply(x, g, b, eps)
