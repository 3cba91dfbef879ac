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
device; they never fall back from one to the other.  Any head width runs:
up to 32 16-byte slices (256 in bf16, 128 in fp32, 512 over the int8
pool) a position spreads over up to a warp, and a wider head is cut into
head-width groups of 32 slices (:func:`_head_groups`), each a block that
owns its columns of the output and sums its scores over the whole width.
The kernels mask the lanes past hd and take one-element loads where rows
are not 16-byte aligned, so the pool is never padded or copied.  Any
number of slots runs, in launches of at most 65,535 (:func:`_slot_chunks`).
A table entry outside [0, P) reads the page the reference's gather reads:
a negative entry wraps once (e + P), then the index is clamped to
[0, P - 1] (:func:`_table_pages`).  ``launches`` and ``quant_launches``
count the kernel launches, one a call up to 65,535 slots.  Both kernels
split each slot's pages over blocks (:func:`_split_pages`) and merge the
splits in the same launch through a workspace and tickets kept per device:
``paged_decode`` on a plan sized from the table (:func:`_split_plan`),
``paged_decode_q8`` on one sized from the grid (:func:`_grid_plan`).

Under CUDA-graph capture a call bakes the workspace's and tickets'
addresses into the graph, so a capture never grows them (it raises:
run the same call eagerly first), and :func:`held_buffers` hands the
capturer the tensors it baked, to keep them alive after a later eager call
has grown (replaced) the per-device buffers.
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
_MAX_SLOTS = 65535            # slots a launch at most (grid y)
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
    idx = _table_pages(page_table, k_pages.shape[0])
    kc = k_pages[idx].reshape(S, view, *k_pages.shape[2:])
    vc = v_pages[idx].reshape(S, view, *v_pages.shape[2:])
    logits = torch.einsum("sqhd,skhd->shqk", q.float(),
                          kc.float()) / math.sqrt(hd)
    pos = torch.arange(view, device=q.device)
    mask = pos[None, :] <= lens[:, None].long()             # [S, view]
    logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, -1).to(cd)
    return torch.einsum("shqk,skhd->sqhd", probs, vc.to(cd))


def _table_pages(page_table, P):
    """The pages a table names, as the reference's ``k_pages[page_table]``
    gathers them: a negative entry wraps once (e + P), then the index is
    clamped to [0, P - 1] (at P = 5, entries -1, -7, 5, 9 read pages 4, 0,
    4, 4).  Returns int64 indices."""
    idx = page_table.long()
    return torch.where(idx < 0, idx + P, idx).clamp(0, P - 1)


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
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        qfn = lib.pt_paged_attention_quant_fwd
        qfn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [
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


def _head_groups(hd, per):
    """(head-width groups, a split partial's stride) for a head of ``hd``
    elements, ``per`` elements a 16-byte slice: one group of stride hd up
    to 32 slices, else groups of 32 slices (the kernels' WIDE instances),
    each partial 32 slices wide."""
    width = 32 * per
    if hd <= width:
        return 1, hd
    return -(-hd // width), width


def _slot_chunks(S):
    """The launches of S slots: [(first slot, slots), ...], at most
    ``_MAX_SLOTS`` a launch (the grid's y extent), in order."""
    return [(s0, min(_MAX_SLOTS, S - s0)) for s0 in range(0, S, _MAX_SLOTS)]


def _workspace(dev, floats, slots_heads):
    """Pointers to the per-device fp32 partials and int32 tickets (zeroed
    once; the merging block resets its ticket), grown when a call needs
    more.  Calls on one device share them, so they must be ordered on one
    stream, as the engine's are.  The hit path reads only ints: the
    decode step is host-bound.  Growing them while a CUDA graph is being
    captured raises: the graph would bake a buffer that the next growth
    frees."""
    got = _work.get(dev)
    if got is not None and got[2] >= floats and got[3] >= slots_heads:
        return got[0], got[1]
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "paged attention: the workspace must be grown before a CUDA "
            "graph capture, not inside it; run the same call eagerly first")
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


def held_buffers(dev):
    """The workspace and ticket tensors calls on ``dev`` use now (empty if
    none has needed them): a CUDA graph that captured such a call keeps
    these alive, since a later call that needs more replaces them."""
    got = _work.get(torch.device(dev))
    return () if got is None else (got[4], got[5])


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
    if min(q.shape) < 1 or min(k_pages.shape) < 1:
        raise ValueError(f"{what}: empty operand q {tuple(q.shape)} / "
                         f"pages {tuple(k_pages.shape)}")


def _check_cuda(q, k_pages, v_pages, page_table, lens):
    _check_operands("paged_attention", q, k_pages, v_pages, page_table,
                    lens)
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("paged_attention: k/v pages must have q's dtype "
                        f"({q.dtype}), got {k_pages.dtype}/{v_pages.dtype}")


def _launch(fn, ptrs, S, nh, hd, P, ps, maxP, pps, splits, per, esize,
            dtype_code, dev, name):
    """Launch ``fn`` over S slots in launches of at most ``_MAX_SLOTS``:
    ``ptrs`` are (the operands before the table, table, lens, out) data
    pointers; each launch gets its slots' q, table, lens and out and its
    own slice of the workspace and tickets.  Returns the launches made."""
    *pre, table, lens, out = ptrs
    kc, ld = _head_groups(hd, per)
    ws = tickets = 0
    if splits > 1:
        ws, tickets = _workspace(dev, S * nh * kc * splits * (ld + 2),
                                 S * nh * kc)
    lib = _kernel()[0]
    chunks = _slot_chunks(S)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for s0, n in chunks:
            err = fn(pre[0] + s0 * nh * hd * esize, *pre[1:],
                     table + s0 * maxP * 4, lens + s0 * 4,
                     out + s0 * nh * hd * esize,
                     ws and ws + s0 * nh * kc * splits * (ld + 2) * 4,
                     tickets and tickets + s0 * nh * kc * 4,
                     n, nh, hd, P, ps, maxP, pps, splits, kc, math.sqrt(hd),
                     dtype_code, stream)
            build.check(lib, err, name)
    return len(chunks)


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
    launches += _launch(
        _kernel()[1], (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                       page_table.data_ptr(), lens.data_ptr(),
                       out.data_ptr()),
        S, nh, hd, P, ps, maxP, pps, splits, 16 // q.element_size(),
        q.element_size(), _DTYPE_CODE[q.dtype], q.device, "paged_attention")
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
    pps, splits = _grid_plan(min(S, _MAX_SLOTS), nh, maxP, ps,
                             _sm_count(q.device))
    out = torch.empty_like(q)
    quant_launches += _launch(
        _kernel()[2], (q.data_ptr(), k_pages.data_ptr(), k_scale.data_ptr(),
                       v_pages.data_ptr(), v_scale.data_ptr(),
                       page_table.data_ptr(), lens.data_ptr(),
                       out.data_ptr()),
        S, nh, hd, P, ps, maxP, pps, splits, 16, q.element_size(),
        _DTYPE_CODE[q.dtype], q.device, "paged_attention_quant")
    return out
