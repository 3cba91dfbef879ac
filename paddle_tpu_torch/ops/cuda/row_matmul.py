"""Row-invariant matrix product: the CUDA kernels ``csrc/row_matmul.cu`` and
their plain PyTorch version.

It replaces no TPU kernel.  It keeps the reference's commit-bytes contract
on the card (``paddle_tpu/models/gpt.py:1103`` ``_paged_verify_block``):
the lanes a speculative verify accepts commit the bytes a sequential
decode writes.  The verify runs a block's weight products at M = S * W
rows and the decode at M = S; cuBLAS sums each output in an order it
picks from M, so the two round differently.  The kernels' order is fixed
by K and N alone, so every output row's bits depend only on that row of x
and on W (see the source's notes).  ``models.gpt.block_apply`` routes
float weights through :func:`matmul` on the two paths whose pool writes
that contract compares: the paged decode and the fp verify.

:func:`_route` picks the kernel from the dtype, K, N and W's alignment,
never from M: bf16 with K and N multiples of 8 and W 16-byte aligned (as
TMA reads x and W) and K <= ``_TC_MAX_K`` takes ``row_mm_tc`` on the
tensor cores; float32 (TF32 would not hold the port's 1e-5), and bf16
shapes TMA cannot take, take ``row_mm`` on the CUDA cores.  :func:`_plan` gives each
route's K split from K and N, and :func:`_k_steps` the k ranges in the
order the kernel adds them; :func:`_args` is what a launch passes, in
which only M follows x's row count.

:func:`matmul` takes the plain version, ``x @ w`` in the compute dtype,
for tensors on the CPU (bit-equal to the reference there) and launches a
kernel for CUDA tensors, never falling back from one to the other.  It is
a forward only: on the card it refuses inputs that need a gradient.

:func:`ln_matmul` is ``LayerNorm(x; g, b, eps) @ w`` in one launch of the
same route with a LayerNorm prologue (``ln_row_mm_tc``, ``ln_row_mm``),
with the arithmetic of the reference's ``_ln_kernel``
(``paddle_tpu/ops/pallas/norms.py:47``; its plain version
:func:`_ref_ln_matmul` is ``norms._ref_layer_norm`` then ``x @ w``).
``block_apply`` takes it for ln1 -> qkv and ln2 -> fc1 on the paged decode
and the fp verify.  Each row's moments are summed in an order fixed by K
alone (:func:`_ln_order`), so the rows' bits stay independent of M;
:func:`_ln_route` keeps the tensor route where a block's rows of x fit in
shared memory whole.

``launches`` counts every launch of the row product, with the prologue or
without; ``ln_launches`` counts those with it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .norms import _ref_layer_norm

launches = 0
ln_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ROUTE = {"cuda_core": 0, "tensor": 1}
# row_mm (CUDA cores): 64 columns a block, 16 warps a block, each summing
# one of the cluster's 16 C ranges of K
_CC_N, _CC_WARPS = 64, 16
# row_mm_tc (tensor cores): 64 columns a block, K in 64-row TMA boxes, at
# most 8 boxes a block (all loaded at once) and 16 blocks a cluster;
# _TC_KQ warps share each box's four k16 steps (a warp every _TC_KQ-th);
# the cluster is the fewest
# blocks (a power of two up to 8) that put _TC_BLOCKS blocks on the card
_TC_N, _TC_BOX, _TC_MAX_BOXES, _TC_MAX_CS, _TC_BLOCKS = 64, 64, 8, 16, 64
_TC_KQ = 2
_TC_MAX_K = _TC_BOX * _TC_MAX_BOXES * _TC_MAX_CS
_TC_SMEM = 232448       # shared memory a block may have (H100)
_fns = None


def _ref_matmul(x, w):
    """The plain version: ``x @ w`` (cuBLAS on the card, the CPU's BLAS
    here), x [..., K], w [K, N] of one dtype."""
    return x @ w


def _ref_ln_matmul(x, g, b, eps, w):
    """The plain version of :func:`ln_matmul`: the plain LayerNorm
    (``norms._ref_layer_norm``: fp32 moments and affine, rounded to x's
    dtype), then ``x @ w``."""
    return _ref_layer_norm(x, g, b, eps) @ w


def _kernels():
    global _fns
    if _fns is None:
        lib = build.load("row_matmul")
        fn = lib.pt_row_matmul
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        ln = lib.pt_ln_row_matmul
        ln.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p]
        ln.restype = ctypes.c_int
        lib.pt_error_string.argtypes = [ctypes.c_int]
        lib.pt_error_string.restype = ctypes.c_char_p
        _fns = (lib, fn, ln)
    return _fns


def _route(dtype, K, N, w_addr):
    """``"tensor"`` (``row_mm_tc``) or ``"cuda_core"`` (``row_mm``) for a
    [*, K] x [K, N] product whose weight starts at ``w_addr``."""
    if (dtype == torch.bfloat16 and not N % 8 and not K % 8
            and not w_addr % 16 and 0 < K <= _TC_MAX_K):
        return "tensor"
    return "cuda_core"


@functools.lru_cache(maxsize=None)
def _plan(route, K, N):
    """(cs, kb): the route's K split.  ``"tensor"``: a cluster of cs
    blocks of kb k rows each (whole 64-row boxes, at most 8), every block
    at least one row; cs is the fewest blocks (a power of two up to 8)
    that put ``_TC_BLOCKS`` blocks on the card (at gpt_345m's products on
    an H100, tools/serving_kernels.py, the fastest cluster or within 2%
    of it: qkv 2, proj 4, and fc1 2 and fc2 8, which their K forces).  ``"cuda_core"``: a cluster of cs blocks (8, 4, 2 or
    1, from the 64-column tiles) of 16 warps, each summing kb k rows."""
    if route == "cuda_core":
        tiles = -(-N // _CC_N)
        cs = 8 if tiles <= 16 else 4 if tiles <= 33 else 2 if tiles <= 66 else 1
        return cs, -(-K // (cs * _CC_WARPS))
    tiles, boxes = -(-N // _TC_N), -(-K // _TC_BOX)
    cs = 1
    while cs < 8 and tiles * cs < _TC_BLOCKS:
        cs *= 2
    cs = max(min(cs, boxes), -(-boxes // _TC_MAX_BOXES))
    per = -(-boxes // cs)
    return -(-boxes // per), _TC_BOX * per


def _k_steps(route, K, N):
    """The k ranges of each output's fp32 sum, in the order the kernel
    adds them: [(rank, unit, k0, k1)].  ``"tensor"``: in each rank the
    warp at k16 position kq (unit) of a box chains steps kq, kq + 2, ...
    of every box in k order in one accumulator (a step past K adds zeros),
    and the positions' sums are added in kq order; ``"cuda_core"``: each
    rank's 16 warps (unit: the warp) sum their ranges, added in warp
    order.  Then the ranks in rank order."""
    cs, kb = _plan(route, K, N)
    out = []
    for q in range(cs):
        if route == "cuda_core":
            for w in range(_CC_WARPS):
                k0 = min(K, (q * _CC_WARPS + w) * kb)
                out.append((q, w, k0, min(K, k0 + kb)))
        else:
            k0, kend = q * kb, min(K, q * kb + kb)
            for kq in range(_TC_KQ):
                for s in range(-(-(kend - k0) // _TC_BOX)):
                    for j in range(kq, _TC_BOX // 16, _TC_KQ):
                        a = k0 + _TC_BOX * s + 16 * j
                        out.append((q, kq, min(K, a), min(K, a + 16)))
    return out


def _tc_ln_bytes(K, N):
    """Shared memory of ``ln_row_mm_tc`` at 64 rows a block (the most it
    takes, whatever M is): ``TcLayout`` with the block's rows of x whole,
    ceil(K / 64) boxes, beside its W stages, plus the 1024 bytes of
    alignment the launch adds."""
    cs, kb = _plan("tensor", K, N)
    stages = kb // _TC_BOX
    cw = 4 * -(-_TC_N // (4 * cs))
    w = stages * _TC_BOX * 2 * _TC_N
    part = _TC_KQ * 64 * (_TC_N + 4) * 4
    x_off = -(-max(w, part) // 1024) * 1024
    return (x_off + -(-K // _TC_BOX) * 64 * 128 + cs * 64 * cw * 4
            + 8 * (stages + 1) + 1024)


def _ln_route(dtype, K, N, w_addr):
    """The fused op's route: :func:`_route`'s, but the tensor route only
    where a block's rows of x fit whole beside its W stages
    (:func:`_tc_ln_bytes`; K up to about 1,150 at gpt-sized N); the CUDA
    cores otherwise.  From the dtype, K, N and W's alignment alone."""
    route = _route(dtype, K, N, w_addr)
    if route == "tensor" and _tc_ln_bytes(K, N) > _TC_SMEM:
        return "cuda_core"
    return route


def _ln_order(K):
    """The order in which the LayerNorm prologue sums each row's two
    moments (the mean, then the mean of (x - mu)^2), on either route:
    [(lane, k0, k1)], lane l adding its 8-element groups l, l + 32, ...
    (elements k0 .. k1 - 1) in k order, each group first summed as a
    pairwise tree ((0 + 1) + (2 + 3)) + ((4 + 5) + (6 + 7)) with zeros past
    K, then the 32 lane sums meeting over xor distances 16, 8, 4, 2, 1.  It depends on K alone:
    every block computes it for its rows whole, so every rank of a
    cluster, every column tile and every row count holds the same bits
    (``row_moments`` and ``tc_ln_prologue`` in the source)."""
    return [(lane, k0, min(K, k0 + 8)) for lane in range(32)
            for k0 in range(8 * lane, K, 256)]


def _args(x2, w, route=None, ln=False):
    """(route, the launch's integers: M, K, N, dtype code, route code, cs,
    kb) for x2 [M, K] @ w [K, N] on ``route`` (default :func:`_route`'s,
    with ``ln`` :func:`_ln_route`'s).  Only M follows x2's row count: it
    sizes the grid's row axis and the masks."""
    M, K = x2.shape
    N = w.shape[1]
    if route is None:
        route = (_ln_route if ln else _route)(x2.dtype, K, N, w.data_ptr())
    return route, (M, K, N, _DTYPE_CODE[x2.dtype], _ROUTE[route],
                   *_plan(route, K, N))


def _launch(x2, w, route=None):
    """One launch on x2 [M, K] and w [K, N], contiguous CUDA tensors of
    one dtype, M and N at least 1; returns y [M, N].  ``route`` forces a
    kernel (``chip_smoke.py`` times both on the same bf16 inputs); a
    route the shapes do not allow raises.  The tensor route reads x by
    TMA, so x off 16 bytes is copied first."""
    global launches
    route, ints = _args(x2, w, route)
    if route == "tensor" and x2.data_ptr() % 16:
        x2 = x2.clone()
    y = torch.empty((x2.shape[0], w.shape[1]), dtype=x2.dtype,
                    device=x2.device)
    lib, fn, _ = _kernels()
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = fn(x2.data_ptr(), w.data_ptr(), y.data_ptr(), *ints, stream)
    build.check(lib, err, f"row_matmul ({route})")
    launches += 1
    return y


def matmul(x, w):
    """x [..., K] @ w [K, N] -> [..., N] in x's dtype (float32 or
    bfloat16; w of the same dtype and device)."""
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
    if not (x2.shape[0] and N):
        return x2.new_empty((*x.shape[:-1], N))
    return _launch(x2, w.contiguous()).reshape(*x.shape[:-1], N)


def _ln_launch(x2, g, b, eps, w, route=None):
    """One launch of the LayerNorm-prologue kernel on x2 [M, K], g and b
    [K], w [K, N], contiguous CUDA tensors (x2 and w of one dtype, g and b
    of one), M and N at least 1; returns y [M, N].  ``route`` as
    :func:`_launch`'s; the plan is the product's own.  The tensor route
    copies x, g or b off 16 bytes first."""
    global launches, ln_launches
    route, ints = _args(x2, w, route, ln=True)
    if route == "tensor":     # the prologue reads x, g and b 16 bytes a load
        x2, g, b = (t.clone() if t.data_ptr() % 16 else t
                    for t in (x2, g, b))
    y = torch.empty((x2.shape[0], w.shape[1]), dtype=x2.dtype,
                    device=x2.device)
    lib, _, fn = _kernels()
    M, K, N, dt, rc, cs, kb = ints
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = fn(x2.data_ptr(), g.data_ptr(), b.data_ptr(), w.data_ptr(),
                 y.data_ptr(), M, K, N, dt, _DTYPE_CODE[g.dtype], rc, cs, kb,
                 float(eps), stream)
    build.check(lib, err, f"ln_matmul ({route})")
    launches += 1
    ln_launches += 1
    return y


def _check_ln(x, g, b, w):
    """ln_matmul's refusals, on every device: one device; x and w of one
    dtype, float32 or bfloat16; g and b of one, float32 or bfloat16;
    g, b [K] and w [K, N] for x [..., K]; no input that needs a gradient."""
    for name, t in (("g", g), ("b", b), ("w", w)):
        if t.device != x.device:
            raise ValueError(f"ln_matmul: {name} on {t.device}, x on "
                             f"{x.device}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"ln_matmul: x {x.dtype}, w {w.dtype}; the kernel "
                        "takes float32 or bfloat16, both the same")
    if g.dtype not in _DTYPE_CODE or b.dtype != g.dtype:
        raise TypeError(f"ln_matmul: g {g.dtype}, b {b.dtype}; the kernel "
                        "takes float32 or bfloat16, both the same")
    K = x.shape[-1]
    if w.dim() != 2 or w.shape[0] != K or g.shape != (K,) or b.shape != (K,):
        raise ValueError(f"ln_matmul: x {tuple(x.shape)}, g {tuple(g.shape)}"
                         f", b {tuple(b.shape)} and w {tuple(w.shape)} do "
                         "not multiply")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, g, b, w)):
        raise RuntimeError("ln_matmul: a forward only; run it under no_grad "
                           "or inference_mode")


def ln_matmul(x, g, b, eps, w):
    """LayerNorm(x; g, b, eps) @ w -> [..., N] in x's dtype: x [..., K]
    float32 or bfloat16, w [K, N] of x's dtype, g and b [K] float32 or
    bfloat16.  On the CPU the plain version; on the card one launch,
    counted in ``launches`` and ``ln_launches``.  A forward only."""
    _check_ln(x, g, b, w)
    if x.device.type == "cpu":
        return _ref_ln_matmul(x, g, b, eps, w)
    if x.device.type != "cuda":
        raise ValueError(f"ln_matmul: unsupported device {x.device}")
    K, N = w.shape
    x2 = x.reshape(-1, K).contiguous()
    if not (x2.shape[0] and N):
        return x2.new_empty((*x.shape[:-1], N))
    return _ln_launch(x2, g.contiguous(), b.contiguous(), eps,
                      w.contiguous()).reshape(*x.shape[:-1], N)
