"""Paged decode attention: the CUDA kernel ``csrc/paged_attn.cu`` and its
plain PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas/paged_attn.py``: the kernel
replaces ``_paged_decode_kernel`` (launched by ``_paged_attention_tpu``),
and :func:`_ref_paged_attention` mirrors ``_ref_paged_attention`` op for
op.  Over an int8 pool, the kernel ``paged_decode_q8`` of the same source
replaces ``_paged_decode_kernel_quant`` (launched by
``_paged_attention_quant_tpu``) and :func:`_ref_paged_attention_quant`
mirrors its namesake.  Inference only: the decode step never
differentiates.

:func:`paged_attention` and :func:`paged_attention_quant` take the plain
version for tensors on the CPU and launch the kernel for tensors on a CUDA
device; they never fall back from one to the other.  Any head width up to
32 16-byte slices (256 in bf16, 128 in fp32; 512 over the int8 pool) runs:
the kernels mask the lanes past hd, and take one-element loads where rows
are not 16-byte aligned, so the pool is never padded or copied.
``launches`` and ``quant_launches`` count their kernel launches, one a
call.  Both kernels split each slot's pages over blocks
(:func:`_split_pages`) and merge the splits in the same launch through a
workspace and tickets kept per device: ``paged_decode`` on a plan sized
from the table (:func:`_split_plan`), ``paged_decode_q8`` on one sized
from the grid (:func:`_grid_plan`).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build
from .dequant_matmul import _sm_count

NEG_INF = -1e30

launches = 0
quant_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fn = None
_SPLIT_POSITIONS = 64         # positions a split takes at least
_GRID_SPLIT_POSITIONS = 512   # the same for paged_decode_q8, whose merge
                              # costs more than walking fewer positions
_MAX_SPLITS = 32              # splits of a slot at most (the merge's room)
_work = {}                    # device -> (fp32 workspace, int32 tickets)


def _ref_paged_attention(q, k_pages, v_pages, page_table, lens):
    """Gather each slot's pages into its contiguous view and run the masked
    attention: fp32 scores, mask to -1e30 past ``lens[s]``, fp32 softmax,
    probabilities cast to q's dtype, then p.V in that dtype.

    q: [S, 1, nh, hd]; k/v_pages: [P, ps, nh, hd]; page_table: int32
    [S, maxP]; lens: int32 [S] (the new token sits at position lens[s]).
    Returns [S, 1, nh, hd]."""
    S, maxP = page_table.shape
    ps = k_pages.shape[1]
    hd = q.shape[-1]
    cd = q.dtype
    view = maxP * ps
    idx = page_table.long()
    kc = k_pages[idx].reshape(S, view, *k_pages.shape[2:])
    vc = v_pages[idx].reshape(S, view, *v_pages.shape[2:])
    logits = torch.einsum("sqhd,skhd->shqk", q.float(),
                          kc.float()) / math.sqrt(hd)
    pos = torch.arange(view, device=q.device)
    mask = pos[None, :] <= lens[:, None].long()             # [S, view]
    logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, -1).to(cd)
    return torch.einsum("shqk,skhd->sqhd", probs, vc.to(cd))


def _ref_paged_attention_quant(q, k_pages, k_scale, v_pages, v_scale,
                               page_table, lens):
    """Dequantize the int8 pool to fp32 (``int8 * scale`` per position per
    head) and run :func:`_ref_paged_attention` on it.  k/v_pages: int8
    [P, ps, nh, hd]; k/v_scale: fp32 [P, ps, nh]."""
    return _ref_paged_attention(
        q, k_pages.float() * k_scale[..., None],
        v_pages.float() * v_scale[..., None], page_table, lens)


def _kernel():
    global _fn
    if _fn is None:
        lib = build.load("paged_attn")
        fn = lib.pt_paged_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        qfn = lib.pt_paged_attention_quant_fwd
        qfn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        qfn.restype = ctypes.c_int
        lib.pt_error_string.argtypes = [ctypes.c_int]
        lib.pt_error_string.restype = ctypes.c_char_p
        _fn = (lib, fn, qfn)
    return _fn


@functools.lru_cache(maxsize=None)
def _split_plan(maxP, ps):
    """(pages a split, splits) for ``paged_decode``: whole pages, at least
    ``_SPLIT_POSITIONS`` positions a split, doubled until a full table
    takes at most ``_MAX_SPLITS`` splits.  Sized from the table, not from
    lens, which the host does not read."""
    pps = max(1, _SPLIT_POSITIONS // ps)
    while -(-maxP // pps) > _MAX_SPLITS:
        pps *= 2
    return pps, -(-maxP // pps)


@functools.lru_cache(maxsize=None)
def _grid_plan(S, nh, maxP, ps, sms):
    """(pages a split, splits) for ``paged_decode_q8``, sized from the
    grid: one split a slot while the ``S * nh`` blocks of one reach the
    ``sms`` SMs, else the most splits that keep the grid within one block
    an SM (at most ``_MAX_SPLITS``), of whole pages and at least
    ``_GRID_SPLIT_POSITIONS`` positions each.  Reads no device value, so
    a CUDA graph can capture the call."""
    want = min(_MAX_SPLITS, max(1, sms // (S * nh)))
    pps = min(maxP, max(-(-maxP // want),
                        -(-_GRID_SPLIT_POSITIONS // ps)))
    return pps, -(-maxP // pps)


def _split_pages(lens, ps, maxP, pps):
    """The pages each block reads, as the kernel assigns them: for every
    slot, [(split, [page index into the table row, ...]), ...] in the
    order the merge sums them.  Splits past a slot's fill take nothing
    and are left out."""
    view = maxP * ps
    out = []
    for ln in lens:
        n = max(0, min(int(ln) + 1, view))
        span = pps * ps
        ns = max(1, -(-n // span))
        out.append([(j, sorted({p // ps for p in range(j * span,
                                                       min(n, j * span
                                                           + span))}))
                    for j in range(ns)])
    return out


def _workspace(dev, floats, slots_heads):
    """Pointers to the per-device fp32 partials and int32 tickets (zeroed
    once; the merging block resets its ticket), grown when a call needs
    more.  Calls on one device share them, so they must be ordered on one
    stream, as the engine's are.  The hit path reads only ints: the
    decode step is host-bound."""
    got = _work.get(dev)
    if got is not None and got[2] >= floats and got[3] >= slots_heads:
        return got[0], got[1]
    ws, tickets = (got[4], got[5]) if got is not None else (None, None)
    if ws is None or ws.numel() < floats:
        ws = torch.empty(max(floats, 1 << 20), dtype=torch.float32,
                         device=dev)
    if tickets is None or tickets.numel() < slots_heads:
        tickets = torch.zeros(max(slots_heads, 4096), dtype=torch.int32,
                              device=dev)
    _work[dev] = (ws.data_ptr(), tickets.data_ptr(), ws.numel(),
                  tickets.numel(), ws, tickets)
    return ws.data_ptr(), tickets.data_ptr()


def _check_operands(what, q, k_pages, v_pages, page_table, lens,
                    scales=()):
    """The checks both kernels share: one device, contiguous operands,
    q [S, 1, nh, hd] in float32 or bfloat16,
    pages [P, ps, nh, hd], int32 table [S, maxP] and lens [S]."""
    dev = q.device
    named = (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
             *scales, ("page_table", page_table), ("lens", lens))
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: q dtype {q.dtype}; the kernel takes "
                        "float32 or bfloat16")
    if page_table.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError(f"{what}: page_table and lens must be int32")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"{what}: q must be [S, 1, nh, hd], got "
                         f"{tuple(q.shape)}")
    S, _, nh, hd = q.shape
    if (k_pages.dim() != 4 or tuple(k_pages.shape[2:]) != (nh, hd)
            or v_pages.shape != k_pages.shape):
        raise ValueError(
            f"{what}: pages {tuple(k_pages.shape)} / "
            f"{tuple(v_pages.shape)} must both be [P, ps, {nh}, {hd}]")
    if (page_table.dim() != 2 or page_table.shape[0] != S
            or tuple(lens.shape) != (S,)):
        raise ValueError(
            f"{what}: page_table {tuple(page_table.shape)} must be "
            f"[{S}, maxP] and lens {tuple(lens.shape)} must be [{S}]")
    if S > 65535:
        raise ValueError(f"{what}: S={S} exceeds 65535 slots")


def _check_cuda(q, k_pages, v_pages, page_table, lens):
    _check_operands("paged_attention", q, k_pages, v_pages, page_table,
                    lens)
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("paged_attention: k/v pages must have q's dtype "
                        f"({q.dtype}), got {k_pages.dtype}/{v_pages.dtype}")
    hd = q.shape[-1]
    widest = 32 * 16 // q.element_size()
    if not 1 <= hd <= widest:
        raise ValueError(
            f"paged_attention: hd={hd} must be 1 to {widest} for {q.dtype} "
            "(up to 32 threads of 16 bytes a position)")


def paged_attention(q, k_pages, v_pages, page_table, lens):
    """Decode attention through a page table.  q: [S, 1, nh, hd] (one new
    token per slot, already scattered into its page); k/v_pages:
    [P, ps, nh, hd]; page_table: int32 [S, maxP]; lens: int32 [S].
    Returns [S, 1, nh, hd] in q's dtype."""
    global launches
    if q.device.type == "cpu":
        return _ref_paged_attention(q, k_pages, v_pages, page_table, lens)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    _check_cuda(q, k_pages, v_pages, page_table, lens)
    S, _, nh, hd = q.shape
    P, ps = k_pages.shape[:2]
    maxP = page_table.shape[1]
    pps, splits = _split_plan(maxP, ps)
    out = torch.empty_like(q)
    ws = tickets = 0
    if splits > 1:
        ws, tickets = _workspace(q.device, S * nh * splits * (hd + 2),
                                 S * nh)
    lib, fn, _ = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 page_table.data_ptr(), lens.data_ptr(), out.data_ptr(),
                 ws, tickets, S, nh, hd, P, ps, maxP, pps, splits,
                 math.sqrt(hd), _DTYPE_CODE[q.dtype], stream)
    build.check(lib, err, "paged_attention")
    launches += 1
    return out


def _check_cuda_quant(q, k_pages, k_scale, v_pages, v_scale, page_table,
                      lens):
    what = "paged_attention_quant"
    _check_operands(what, q, k_pages, v_pages, page_table, lens,
                    (("k_scale", k_scale), ("v_scale", v_scale)))
    if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
        raise TypeError(f"{what}: k/v pages must be int8, got "
                        f"{k_pages.dtype}/{v_pages.dtype}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError(f"{what}: k/v scales must be float32")
    if (k_scale.shape != k_pages.shape[:3]
            or v_scale.shape != k_pages.shape[:3]):
        raise ValueError(
            f"{what}: scales {tuple(k_scale.shape)} / "
            f"{tuple(v_scale.shape)} must both be "
            f"{tuple(k_pages.shape[:3])}")
    # 16 int8 elements of K and V per thread, up to a warp a position
    hd = q.shape[-1]
    if not 1 <= hd <= 512:
        raise ValueError(
            f"{what}: hd={hd} must be 1 to 512 (up to 32 threads of 16 "
            "int8 elements a position)")


def paged_attention_quant(q, k_pages, k_scale, v_pages, v_scale,
                          page_table, lens):
    """Decode attention through a page table over the int8 pool.  q:
    [S, 1, nh, hd] float32 or bfloat16; k/v_pages: int8 [P, ps, nh, hd];
    k/v_scale: fp32 [P, ps, nh]; page_table: int32 [S, maxP]; lens: int32
    [S].  Returns [S, 1, nh, hd] in q's dtype.  Any page size: the
    TPU kernel's ``page_size % 32`` rule is a sublane rule of int8 tiles
    and does not apply here."""
    global quant_launches
    if q.device.type == "cpu":
        return _ref_paged_attention_quant(q, k_pages, k_scale, v_pages,
                                          v_scale, page_table, lens)
    if q.device.type != "cuda":
        raise ValueError(
            f"paged_attention_quant: unsupported device {q.device}")
    _check_cuda_quant(q, k_pages, k_scale, v_pages, v_scale, page_table,
                      lens)
    S, _, nh, hd = q.shape
    P, ps = k_pages.shape[:2]
    maxP = page_table.shape[1]
    pps, splits = _grid_plan(S, nh, maxP, ps, _sm_count(q.device))
    out = torch.empty_like(q)
    ws = tickets = 0
    if splits > 1:
        ws, tickets = _workspace(q.device, S * nh * splits * (hd + 2),
                                 S * nh)
    lib, _, qfn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = qfn(q.data_ptr(), k_pages.data_ptr(), k_scale.data_ptr(),
                  v_pages.data_ptr(), v_scale.data_ptr(),
                  page_table.data_ptr(), lens.data_ptr(), out.data_ptr(),
                  ws, tickets, S, nh, hd, P, ps, maxP, pps, splits,
                  math.sqrt(hd), _DTYPE_CODE[q.dtype], stream)
    build.check(lib, err, "paged_attention_quant")
    quant_launches += 1
    return out
