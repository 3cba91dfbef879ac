"""Weight-only int8 matmul: the CUDA kernels ``csrc/dequant_matmul.cu`` and
their plain PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas/dequant_matmul.py``: the kernels
replace ``_dqmm_kernel`` (launched by ``_dqmm_tpu``), and
:func:`_ref_dequant_matmul` mirrors that module's ``_ref_dequant_matmul``
op for op.  Inference only.

:func:`dequant_matmul` takes the plain version for tensors on the CPU and
launches a kernel for tensors on a CUDA device, for int8 weights only; it
never falls back from one to the other.  ``launches`` counts kernel
launches, one a call, and ``rows_launches`` the same launches by their
row count M (``{M: launches}``).  In bf16 :func:`_plan` picks the kernel
from M: up to ``_SMALL_M`` rows the weight-streaming ``dqmm_stream`` (K split over a
thread-block cluster, :func:`_stream_steps` says which block and warp take
each k step), above it the warp-specialised ``dqmm_wg`` on 128-row tiles,
and on 256-row tiles from ``_WG256_M`` rows.  float32 runs
``dqmm_f32`` with K split by :func:`_split`.  The TPU wrapper pads M up to
the sublane minimum; the CUDA kernels mask their ragged tiles, so any M >= 1
goes in as it is.

Any K and N go in, as in the reference: the kernels load 16-byte rows, so
:func:`pad_weight` zero-pads the weight to K a multiple of 8 and N of 16
(the scale to N with it) and copies a strided or misaligned weight, and
x's columns are zero-padded to the weight's K; the output's padded columns
are cut off.  Exact: padded x columns meet zero weight rows.  A caller
that multiplies by one weight many times pads it once (the serving
engine's ``prepare_params`` does) and passes the true N as ``n``; a
weight already in the kernels' form is used as it is, with no copy.

The kernels round once (``(x @ w_q) * scale`` in fp32, then to x's dtype);
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
rows_launches = {}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BM = _BN = 64                # dqmm_f32's output tile
_BLOCKS_PER_SM = 4            # dqmm_f32: split K until about this many
_fn = None
_tickets = {}                 # device -> int32 split-K tickets (kept at 0)

# dqmm_stream (bf16, small M): a block owns _ST_N output columns and a k
# range of whole 64-row TMA boxes, up to _ST_SLOTS of them, all loaded at
# once; eight consumer warps; K split over a cluster of up to _ST_MAX_CS
# blocks.  _SMALL_M: the largest M it takes; above it dqmm_wg is faster
# (tools/serving_kernels.py at [M, 1024] x [1024, 4096]: 0.0157 against
# 0.0173 ms at M = 16, 0.0205 against 0.0174 at M = 32, H100)
_SMALL_M = 16
_ST_N, _ST_ROWS, _ST_SLOTS, _ST_WARPS, _ST_MAX_CS = 128, 64, 16, 8, 8
_SMEM = 232448                # dynamic shared memory a block may take
_K_MULT, _N_MULT = 8, 16      # K and N multiples of the kernels' rows
_WG256_M = 768                # dqmm_wg takes 256-row tiles from this M
_REGIME = {"stream": 0, "wg128": 1, "wg256": 2}


def _ref_dequant_matmul(x2d, w_q, scale):
    """``x2d @ w_q.to(x.dtype)``, then times ``scale`` cast to x's dtype.
    The per-output-channel scale factors out of the contraction, so this
    is the kernel's function; it rounds twice where the kernel rounds
    once."""
    y = x2d @ w_q.to(x2d.dtype)
    return y * scale.reshape(1, -1).to(x2d.dtype)


def kernel_ready(w_q):
    """Whether the kernels take the int8 weight ``w_q`` [..., K, N] as it
    is (and each [K, N] matrix of a stacked one): K a multiple of 8, N of
    16, contiguous and 16-byte aligned."""
    K, N = w_q.shape[-2:]
    return (not K % _K_MULT and not N % _N_MULT and w_q.is_contiguous()
            and not w_q.data_ptr() % 16)


def pad_weight(w_q, scale):
    """The kernels' form of a weight [..., K, N] and its per-column scale
    (N elements a matrix, any shape): (w [..., Kp, Np] contiguous and
    16-byte aligned, K zero-padded to a multiple of 8 and N of 16; scale
    fp32 [..., Np], zeros past N).  A weight already in that form comes
    back as it is, its scale as an [..., N] view."""
    lead, (K, N) = w_q.shape[:-2], w_q.shape[-2:]
    s = scale.reshape(*lead, N)
    if kernel_ready(w_q):
        return w_q, s.contiguous()
    kp, np_ = -(-K // _K_MULT) * _K_MULT, -(-N // _N_MULT) * _N_MULT
    w = w_q.new_zeros((*lead, kp, np_))
    w[..., :K, :N] = w_q
    sp = s.new_zeros((*lead, np_))
    sp[..., :N] = s
    return w, sp


def _pad_cols(x2d, K):
    """x2d [M, k] with its columns zero-padded to K (a copy), or as it
    is."""
    k = x2d.shape[1]
    return x2d if k == K else torch.nn.functional.pad(x2d, (0, K - k))


def held_buffers(dev):
    """The split-K ticket tensor calls on ``dev`` use now (empty if none
    has needed one), for a CUDA graph that captured such a call to keep
    alive."""
    buf = _tickets.get(torch.device(dev))
    return () if buf is None else (buf,)


def _kernel():
    global _fn
    if _fn is None:
        lib = build.load("dequant_matmul")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f32 = lib.pt_dqmm_f32
        f32.argtypes = [p, ll] + [p] * 5 + [i] * 5 + [p]
        f32.restype = i
        bf16 = lib.pt_dqmm_bf16
        bf16.argtypes = [p, ll] + [p] * 3 + [i] * 7 + [p]
        bf16.restype = i
        lib.pt_dqmm_f32_bk.argtypes = []
        lib.pt_dqmm_f32_bk.restype = i
        lib.pt_error_string.argtypes = [i]
        lib.pt_error_string.restype = ctypes.c_char_p
        _fn = (lib, f32, bf16)
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


def _stream_smem(M, kb, cs):
    """Bytes of dynamic shared memory dqmm_stream takes for M rows, kb k
    rows a block and a cluster of cs blocks (the kernel's
    ``StreamLayout``, plus 1 KB to align): the weight stages, which the
    warps' partials later overwrite, x, the receive buffer of the
    cluster's partials and the barriers."""
    mp = 8 if M <= 8 else 16
    stages = kb // _ST_ROWS
    return (max(stages * _ST_ROWS * _ST_N, _ST_WARPS * mp * (_ST_N + 4) * 4)
            + mp * (kb + 8) * 2 + cs * mp * -(-_ST_N // cs) * 4
            + 8 * stages + 1024)


@functools.lru_cache(maxsize=None)
def _plan(M, N, K, sms):
    """The bf16 kernel for an [M, K] x [K, N] product on a card of ``sms``
    SMs: ``("stream", cs, kb)`` (dqmm_stream, K split over a cluster of cs
    blocks of kb k rows each, a multiple of 64), or dqmm_wg, ``("wg256",
    0, 0)`` from ``_WG256_M`` rows (256-row tiles convert the weights half
    as often a flop) and ``("wg128", 0, 0)`` below (more tiles for the
    SMs): at [M, 1024] x [1024, 4096] on an H100 (tools/serving_kernels.py)
    0.0169 against 0.0233 ms at M = 512, 0.0312 against 0.0260 at 1000,
    0.1166 against 0.0952 at 4096.  Up to ``_SMALL_M`` rows, the cluster is
    the fewest blocks (a power of two up to 8) that give 70% of the SMs a
    block, and never more than the 64-row boxes of K; then kb is as few
    boxes as cover K in that many blocks, and the cluster as few blocks as
    kb needs.  (At
    gpt_345m's four decode products that picks the fastest of clusters of
    2, 4, 8 and 16 blocks, tools/serving_kernels.py, H100; a block of 16
    rows holds the registers of one block an SM, so more blocks than SMs
    would run in two waves.)  A block holds at most 16 boxes and must fit
    its x rows in shared memory: larger K goes to dqmm_wg."""
    if M <= _SMALL_M:
        tiles, boxes = -(-N // _ST_N), -(-K // _ST_ROWS)
        cs = 1
        while cs < _ST_MAX_CS and 10 * tiles * cs < 7 * sms:
            cs *= 2
        per = -(-boxes // min(cs, boxes))
        kb, cs = _ST_ROWS * per, -(-boxes // per)
        if kb <= _ST_SLOTS * _ST_ROWS and _stream_smem(M, kb, cs) <= _SMEM:
            return ("stream", cs, kb)
    return ("wg256" if M >= _WG256_M else "wg128", 0, 0)


def _stream_steps(K, cs, kb):
    """dqmm_stream's k steps: [(rank, warp, k0)] for every k16 step
    [k0, k0 + 16) of the k range the blocks read, rank r taking rows
    [r kb, min(K, r kb + kb)) in whole 64-row boxes and warp st % 8 its
    step st."""
    out = []
    for r in range(cs):
        k0, kend = r * kb, min(K, r * kb + kb)
        for st in range(4 * -(-(kend - k0) // _ST_ROWS)):
            out.append((r, st % _ST_WARPS, k0 + 16 * st))
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _ticket_buffer(dev, n):
    """The per-device split-K tickets, grown to ``n``.  Never grown inside
    a CUDA graph capture (the graph would bake a buffer that the next
    growth frees): run the same call eagerly first."""
    buf = _tickets.get(dev)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "dequant_matmul: the split-K tickets must be grown before "
                "a CUDA graph capture, not inside it; run the same call "
                "eagerly first")
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


def _check_cuda(x, w_q, scale, n=None):
    """The checks before a launch.  With ``n``, ``w_q`` and ``scale`` are
    :func:`pad_weight`'s form of a weight of x's K rows and n columns."""
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
    if w_q.dim() != 2:
        raise ValueError(f"dequant_matmul: w_q must be a [K, N] matrix, "
                         f"got {tuple(w_q.shape)}")
    K, N = w_q.shape
    k = x.shape[-1]
    if n is None and k != K:
        raise ValueError(f"dequant_matmul: x [..., {k}] against "
                         f"w_q [{K}, {N}]")
    if n is not None and (K != -(-k // _K_MULT) * _K_MULT
                          or N != -(-n // _N_MULT) * _N_MULT):
        raise ValueError(f"dequant_matmul: w_q [{K}, {N}] is not the padded "
                         f"form of a [{k}, {n}] weight (pad_weight)")
    if scale.numel() != N:
        raise ValueError(f"dequant_matmul: scale has {scale.numel()} "
                         f"elements for N={N}")


def dequant_matmul(x, w_q, scale, n=None):
    """x [..., K] @ weight-only quantized ``w_q`` [K, N] -> [..., N] in
    x's dtype.  ``scale``: per-output-channel fp32, any shape of N
    elements (``[N]`` or ``[1, N]``).  Any K and N.  With ``n``, ``w_q``
    and ``scale`` come padded by :func:`pad_weight` (padded once for many
    calls) and the output has the weight's true ``n`` columns."""
    k = x.shape[-1]
    lead = x.shape[:-1]
    N = w_q.shape[1] if n is None else n
    if x.device.type == "cpu":
        x2 = x.reshape(math.prod(lead), k)
        if n is None:
            out = _ref_dequant_matmul(x2, w_q, scale)
        else:
            out = _ref_dequant_matmul(_pad_cols(x2, w_q.shape[0]), w_q,
                                      scale)[:, :n]
        return out.reshape(*lead, N)
    if x.device.type != "cuda":
        raise ValueError(f"dequant_matmul: unsupported device {x.device}")
    _check_cuda(x, w_q, scale, n)
    w, s = pad_weight(w_q, scale)
    x2, lda = _rows(x, k)
    if w.shape[0] != k:
        x2, lda = _pad_cols(x2, w.shape[0]), w.shape[0]
    out = _launch(x2, lda, w, s.reshape(-1))
    if out.shape[1] != N:
        out = out[:, :N]
    return out.reshape(*lead, N)


def _launch(x2, lda, w_q, s):
    """One kernel launch on operands in the kernels' form: x2 [M, K] rows
    ``lda`` apart, ``w_q`` [K, N] from :func:`pad_weight`, s fp32 [N].
    Returns [M, N] in x's dtype."""
    global launches
    M = x2.shape[0]
    K, N = w_q.shape
    out = torch.empty((M, N), dtype=x2.dtype, device=x2.device)
    if M == 0:
        return out
    dev = x2.device
    lib, f32, bf16 = _kernel()
    sms = _sm_count(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if x2.dtype == torch.bfloat16:
            regime, cs, kb = _plan(M, N, K, sms)
            err = bf16(x2.data_ptr(), lda, w_q.data_ptr(), s.data_ptr(),
                       out.data_ptr(), M, N, K, _REGIME[regime], cs, kb, sms,
                       stream)
        else:
            tpb, ksplit = _split(M, N, K, lib.pt_dqmm_f32_bk(),
                                 _BLOCKS_PER_SM * sms)
            ws = tickets = None
            if ksplit > 1:
                ws = torch.empty((ksplit, M, N), dtype=torch.float32,
                                 device=dev)
                tickets = _ticket_buffer(dev, -(-M // _BM) * -(-N // _BN))
            err = f32(x2.data_ptr(), lda, w_q.data_ptr(), s.data_ptr(),
                      out.data_ptr(), 0 if ws is None else ws.data_ptr(),
                      0 if tickets is None else tickets.data_ptr(),
                      M, N, K, tpb, ksplit, stream)
    build.check(lib, err, "dequant_matmul")
    launches += 1
    rows_launches[M] = rows_launches.get(M, 0) + 1
    return out
