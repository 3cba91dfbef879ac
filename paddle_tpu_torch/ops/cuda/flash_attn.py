"""Flash attention: the CUDA kernels ``csrc/flash_attn.cu`` (forward, the
split backward's dq and dk/dv kernels, and the fused backward) and their
plain PyTorch versions.

Counterpart of ``paddle_tpu/ops/pallas/flash_attn.py``: the kernels
replace ``_fa_kernel`` (launched by ``_flash_attention_tpu``),
``_fa_dq_kernel`` / ``_fa_dkv_kernel`` (the split path of
``_flash_attention_bwd_tpu``, the reference's default) and
``_fa_fused_bwd_kernel`` (its fused path, chosen by
``set_default_blocks(bwd_fused=True)`` as in the reference).
:func:`_ref_attention` mirrors ``_ref_attention``; :func:`_ref_flash_fwd`
and :func:`_ref_flash_bwd` are plain versions of the kernels' own
functions (out with the row logsumexp; the gradients recomputed from it).

:func:`flash_attention` keeps the reference's ``[B, N, nh, hd]`` layout at
its face.  For tensors on the CPU it is autograd of :func:`_ref_attention`,
as the reference's fallback is ``jax.vjp`` of its ``_ref_attention``.  For
CUDA tensors it is a ``torch.autograd.Function`` whose forward and backward
launch the kernels, or raise; it never falls back from one to the other.

The forward is one ``torch.library`` op, ``paddle_tpu::flash_fwd(q, k, v,
causal) -> (out, lse)``, so that ``torch.export`` records it as one node
(``inference/export.py``): its CUDA implementation checks the operands,
makes every plan and shape decision (head-width padding, the rows with no
key, the launches of 65,535 batches) and launches the kernels; its CPU
implementation is the plain version (:func:`_ref_attention`'s out, the
fp32 row logsumexp); its fake implementation gives both shapes without
reading data.  The autograd function's forward is that op; a call that
needs no gradient calls the op alone, on either device.
q/k/v may be strided views (the model's are slices of its fused qkv
projection): the kernels take the strides of the first three axes, so no
copy is made unless a bf16 row is off 16-byte alignment
(:func:`_kernel_operand`).

Head widths.  The kernels have instances for hd 64, 128 and 256 (the
Pallas kernel's own contract, ``_use_pallas``, is 64 and the multiples of
128); any other hd up to 256 is zero-padded to the next of these, and a
wider one to the next multiple of 64 (:func:`_kernel_width`,
:func:`_padded_fwd`, :func:`_padded_bwd`), with the softmax scale kept at
1/sqrt(true hd); out, dq, dk, dv are sliced back: zero columns change
neither q.k nor p.v.  That copies q, k, v (and dO) once.  Heads wider than
256 run on a head-width group axis inside each launch: group g owns
columns [64g, 64g + 64) of the outputs and recomputes the scores over the
full width (``csrc/flash_attn.cu``), so there is no upper limit on hd.
Every launch has the grid (row tiles x groups, nh, B), B in launches of at
most 65,535, so any B * nh runs.  ``fwd_launches``, ``dq_launches``,
``dkv_launches`` and ``fused_launches`` count the wrappers' kernel calls.

Causal with N > Nk (bottom-right aligned) leaves the first N - Nk rows
with no visible key.  The reference's softmax over their -1e30 logits is
uniform: out is the mean of V, lse -1e30 (+ log Nk, lost in fp32), and
the gradient is dq = 0, nothing into dk, dv += dO / Nk.  The wrapper gives
those rows to two small kernels (``fa_nokey_fwd``, ``fa_nokey_dv``,
counted by ``nokey_launches``) and the rows after them, a square causal
problem, to the kernels above through a row-offset view of q and dO
(:func:`_fwd_rows`, :func:`_bwd_kernels`), so no kernel recomputes p from
an lse of -1e30.

The fused backward keeps a K/V tile stationary and adds each q tile's
``ds @ k`` into a zeroed fp32 dq buffer, which the wrapper then casts to
q's dtype: in bf16 each 64-row tile goes through shared memory into one
bulk tensor reduction a 32-column box (``cp.reduce.async.bulk.tensor``
``.add.f32``), in fp32 by atomic adds.  The reference writes one fp32 dq
partial per K block and sums them after.  That buffer is O(N^2 hd /
block_k), so the reference falls back to the split kernels above
``_FUSED_DQP_BYTES_CAP``; the port's is O(N hd), so every backward with
``bwd_fused=True`` takes the fused kernel.  The routes differ there, not
the results: both compute :func:`_ref_flash_bwd`'s function.  The adds'
order varies from run to run, and with it dq's last bits; the split
kernels write each of dq, dk and dv once, so they give the same bits on
the same inputs.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

NEG_INF = -1e30

fwd_launches = 0
dq_launches = 0
dkv_launches = 0
fused_launches = 0
nokey_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)
_GROUP = 64          # columns of a head-width group above 256
_fns = None
# Backward strategy, as the reference's _BWD_FUSED: False = the split dq
# and dk/dv kernels, True = the fused kernel.
_BWD_FUSED = False


def set_default_blocks(fwd=None, bwd=None, bwd_fused=None):
    """The reference's tiling/strategy switch.  ``bwd_fused`` sets the
    backward strategy (``None`` keeps it).  The kernels' tiles are fixed,
    so a ``fwd`` or ``bwd`` tiling raises."""
    global _BWD_FUSED
    if fwd is not None or bwd is not None:
        raise NotImplementedError(
            "flash attention tiles are fixed per kernel in "
            "csrc/flash_attn.cu; per-call block sizes are not ported")
    if bwd_fused is not None:
        _BWD_FUSED = bool(bwd_fused)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _causal_mask(n, m, device):
    """Bottom-right causal mask ``tril(ones(n, m), k=m-n)``: query i sees
    key j <= i + m - n."""
    return torch.ones((n, m), dtype=torch.bool, device=device).tril(m - n)


def _ref_attention(q, k, v, causal):
    """Dense attention, the reference's ``_ref_attention`` op for op:
    logits in q's dtype, fp32 softmax, probabilities cast to q's dtype.
    q: [B, N, nh, hd]; k, v: [B, Nk, nh, hd].  Returns [B, N, nh, hd]."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    if causal:
        mask = _causal_mask(logits.shape[-2], logits.shape[-1], q.device)
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits.float(), -1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _scores(q, k, causal, scale=None):
    """fp32 scaled scores [B, nh, N, Nk] and the visibility mask; ``scale``
    defaults to 1/sqrt(hd)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if scale is None:
        s = s / math.sqrt(q.shape[-1])
    else:
        s = s * scale
    n, m = s.shape[-2:]
    mask = (_causal_mask(n, m, q.device) if causal
            else torch.ones((n, m), dtype=torch.bool, device=q.device))
    return s, mask


def _ref_flash_fwd(q, k, v, causal, scale=None):
    """Plain version of the forward kernel: (out [B, N, nh, hd] in q's
    dtype, lse [B, nh, N] fp32).  Scores, softmax and lse in fp32 from the
    stored values, probabilities cast to q's dtype before an fp32 p.V; in
    float32 this is :func:`_ref_attention`.  ``scale`` defaults to
    1/sqrt(hd)."""
    s, mask = _scores(q, k, causal, scale)
    s = s.masked_fill(~mask, NEG_INF)
    lse = torch.logsumexp(s, -1)
    probs = torch.softmax(s, -1).to(q.dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype), lse


def _probs_and_ds(q, k, v, out, lse, do, causal, scale):
    """The backward's p = exp(s - lse) (0 where masked) and ds = p (dp -
    delta) scale in fp32, delta = rowsum(dO * O).  A row that sees no key
    (causal, N > Nk) has the reference's uniform p = 1/Nk and ds = 0: its
    logits were all masked, so no gradient reaches q or k through them."""
    s, mask = _scores(q, k, causal, scale)
    nokey = ~mask.any(-1, keepdim=True)                         # [N, 1]
    p = torch.exp(s - lse[..., None]).masked_fill(~mask, 0.0)
    p = torch.where(nokey, 1.0 / k.shape[1], p)
    dof = do.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    delta = (dof * out.float()).sum(-1).transpose(1, 2)        # [B, nh, N]
    ds = p * (dp - delta[..., None])
    ds = ds / math.sqrt(q.shape[-1]) if scale is None else ds * scale
    return p, torch.where(nokey, 0.0, ds), dof


def _ref_flash_bwd(q, k, v, out, lse, do, causal, scale=None):
    """Plain version of the backward kernels: p = exp(s - lse) recomputed
    from the saved logsumexp, delta = rowsum(dO * O), ds = p (dp - delta)
    scale, with p and ds cast to the stored dtype before their products and
    fp32 sums (``scale`` defaults to 1/sqrt(hd)); rows that see no key as
    :func:`_probs_and_ds` gives them.  Returns (dq, dk, dv) in the inputs'
    dtypes."""
    dt = q.dtype
    p, ds, dof = _probs_and_ds(q, k, v, out, lse, do, causal, scale)
    p_c, ds_c = p.to(dt).float(), ds.to(dt).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p_c, dof)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds_c, q.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds_c, k.float())
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype)


def _ref_flash_bwd_terms(q, k, v, out, lse, do, causal, scale=None):
    """The magnitudes of the terms each gradient element of
    :func:`_ref_flash_bwd` sums, in fp32 from its p and ds: (|ds| |k| for
    dq, |ds|^T |q| for dk, |p|^T |dO| for dv), shaped as the gradients.  A
    bf16 gate scales its relative tolerance by these: where the terms
    cancel, one bf16 step of a term can exceed a step of the sum."""
    p, ds, dof = _probs_and_ds(q, k, v, out, lse, do, causal, scale)
    ds = ds.abs()
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.float().abs()),
            torch.einsum("bhqk,bqhd->bkhd", ds, q.float().abs()),
            torch.einsum("bhqk,bqhd->bkhd", p, dof.abs()))


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------

def _kernels():
    global _fns
    if _fns is None:
        lib = build.load("flash_attn")
        ll, i, f, p = (ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                       ctypes.c_void_p)
        fwd = lib.pt_flash_fwd
        fwd.argtypes = [p] * 5 + [i] * 5 + [ll] * 9 + [i, f, i, p]
        dq = lib.pt_flash_bwd_dq
        dq.argtypes = [p] * 7 + [i] * 5 + [ll] * 12 + [i, f, i, p]
        dkv = lib.pt_flash_bwd_dkv
        dkv.argtypes = [p] * 8 + [i] * 5 + [ll] * 12 + [i, f, i, p]
        fused = lib.pt_flash_bwd_fused
        fused.argtypes = [p] * 9 + [i] * 5 + [ll] * 12 + [i, f, i, p]
        lib.pt_flash_nokey_fwd.argtypes = [p] * 3 + [i] * 5 + [ll] * 3 + [
            i, p]
        lib.pt_flash_nokey_dv.argtypes = [p] * 2 + [i] * 5 + [ll] * 3 + [
            i, p]
        for fn in (fwd, dq, dkv, fused, lib.pt_flash_nokey_fwd,
                   lib.pt_flash_nokey_dv):
            fn.restype = ctypes.c_int
        lib.pt_error_string.argtypes = [ctypes.c_int]
        lib.pt_error_string.restype = ctypes.c_char_p
        _fns = (lib, fwd, dq, dkv, fused)
    return _fns


def _kernel_width(hd):
    """The head width the kernels run ``hd`` at: the next of
    :data:`_HEAD_DIMS`, or above them the next multiple of
    :data:`_GROUP` (the wide instances' head-width groups)."""
    for D in _HEAD_DIMS:
        if hd <= D:
            return D
    return -(-hd // _GROUP) * _GROUP


def _check_cuda(q, k, v, causal):
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{dev}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is "
                            f"{q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be "
                             f"[B, N, nh, hd], got {tuple(t.shape)}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention: dtype {q.dtype}; the kernels "
                        "take float32 or bfloat16")
    B, N, nh, hd = q.shape
    Nk = k.shape[1]
    if (k.shape[0], k.shape[2:]) != (B, (nh, hd)) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} must be [{B}, Nk, {nh}, {hd}]")
    if min(N, Nk, B * nh, hd) < 1:
        raise ValueError(f"flash_attention: N={N}, Nk={Nk}, B*nh="
                         f"{B * nh} and hd={hd} must be >= 1")


def _pad_hd(ts, D):
    """Each tensor's last axis zero-padded to D (a copy), or as it is."""
    return [t if t.shape[-1] == D else
            torch.nn.functional.pad(t, (0, D - t.shape[-1])) for t in ts]


def _padded_fwd(fwd, q, k, v, causal):
    """``fwd(q, k, v, causal, scale) -> (out, lse)`` on q, k, v zero-padded
    to the kernels' next head width, at the true width's scale; out sliced
    back to hd."""
    hd = q.shape[-1]
    D = _kernel_width(hd)
    out, lse = fwd(*_pad_hd((q, k, v), D), causal, 1.0 / math.sqrt(hd))
    return (out if D == hd else out[..., :hd].contiguous()), lse


def _padded_bwd(bwd, q, k, v, out, lse, do, causal):
    """``bwd(q, k, v, out, lse, do, causal, scale) -> (dq, dk, dv)`` on
    operands zero-padded as :func:`_padded_fwd` pads them; the gradients
    sliced back to hd."""
    hd = q.shape[-1]
    D = _kernel_width(hd)
    grads = bwd(*_pad_hd((q, k, v, out), D), lse, *_pad_hd((do,), D),
                causal, 1.0 / math.sqrt(hd))
    if D == hd:
        return grads
    return tuple(g[..., :hd].contiguous() for g in grads)


def _kernel_operand(t):
    """``t`` with a unit last stride; a bf16 operand also with 16-byte
    aligned rows and batch, row and head strides (the tensor-core kernels
    load 16-byte chunks, the TMA loads need both).  The model's q/k/v views
    of its fused projection pass as they are."""
    if t.stride(-1) != 1:
        t = t.contiguous()
    if t.dtype == torch.bfloat16 and (
            t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])):
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def _strides(t):
    return list(t.stride()[:3])


def _fwd_kernel(q, k, v, causal, scale):
    """The forward kernel on q, k, v of a kernel head width."""
    global fwd_launches
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    B, N, nh, hd = q.shape
    Nk = k.shape[1]
    out = torch.empty((B, N, nh, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, nh, N), dtype=torch.float32, device=q.device)
    lib, fwd, *_ = _kernels()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  lse.data_ptr(), B, nh, N, Nk, hd, *_strides(q),
                  *_strides(k), *_strides(v), int(causal), scale,
                  _DTYPE_CODE[q.dtype], stream)
    build.check(lib, err, "flash_attention forward")
    fwd_launches += 1
    return out, lse


def _nokey_rows(q, k, causal):
    """The rows that see no key: N - Nk where causal and N > Nk, else 0."""
    return max(0, q.shape[1] - k.shape[1]) if causal else 0


def _nokey_fwd(v, rows):
    """``fa_nokey_fwd``: (out [B, rows, nh, hd], the mean of v over its keys,
    lse [B, nh, rows] of -1e30) for the rows that see no key."""
    global nokey_launches
    v = _kernel_operand(v)
    B, Nk, nh, hd = v.shape
    out = torch.empty((B, rows, nh, hd), dtype=v.dtype, device=v.device)
    lse = torch.empty((B, nh, rows), dtype=torch.float32, device=v.device)
    lib = _kernels()[0]
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = lib.pt_flash_nokey_fwd(v.data_ptr(), out.data_ptr(),
                                     lse.data_ptr(), B, nh, Nk, hd, rows,
                                     *_strides(v), _DTYPE_CODE[v.dtype],
                                     stream)
    build.check(lib, err, "flash_attention forward (rows with no key)")
    nokey_launches += 1
    return out, lse


def _nokey_dv(do, dv):
    """``fa_nokey_dv``: dv (contiguous [B, Nk, nh, hd]) += the gradient of
    the rows that see no key, whose dO is ``do`` [B, rows, nh, hd]."""
    global nokey_launches
    do = _kernel_operand(do)
    B, rows, nh, hd = do.shape
    lib = _kernels()[0]
    with torch.cuda.device(do.device):
        stream = torch.cuda.current_stream(do.device).cuda_stream
        err = lib.pt_flash_nokey_dv(do.data_ptr(), dv.data_ptr(), B, nh,
                                    dv.shape[1], hd, rows, *_strides(do),
                                    _DTYPE_CODE[do.dtype], stream)
    build.check(lib, err, "flash_attention backward (rows with no key)")
    nokey_launches += 1


def _fwd_rows(q, k, v, causal, scale):
    """The forward on operands of a kernel head width.  Causal with N > Nk:
    the rows that see no key by :func:`_nokey_fwd`, the rest (query i sees
    key j <= i - (N - Nk): square causal) by the forward kernel on a
    row-offset view of q."""
    rows = _nokey_rows(q, k, causal)
    if not rows:
        return _fwd_kernel(q, k, v, causal, scale)
    out_t, lse_t = _fwd_kernel(q[:, rows:], k, v, True, scale)
    out_h, lse_h = _nokey_fwd(v, rows)
    return torch.cat((out_h, out_t), 1), torch.cat((lse_h, lse_t), 2)


def _flash_fwd_cuda(q, k, v, causal):
    return _padded_fwd(_fwd_rows, q, k, v, causal)


def _bwd_operands(q, k, v, out, do):
    """(q, k, v, dO as the kernels take them, delta [B, nh, N]).
    delta = rowsum(dO * O) in fp32, outside the kernels as in the
    reference (flash_attn.py:402)."""
    q, k, v, do = (_kernel_operand(t) for t in (q, k, v, do))
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, delta


def _bwd_args(q, k, v, do, lse, delta, causal, scale):
    B, N, nh, hd = q.shape
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    dims = (B, nh, N, k.shape[1], hd, *_strides(q), *_strides(k),
            *_strides(v), *_strides(do), int(causal), scale,
            _DTYPE_CODE[q.dtype])
    return ptrs, dims


def _launch_dq(q, k, v, do, lse, delta, causal, scale):
    """The dq kernel on operands from :func:`_bwd_operands`."""
    global dq_launches
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    ptrs, dims = _bwd_args(q, k, v, do, lse, delta, causal, scale)
    lib, _, dq_fn, *_ = _kernels()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = dq_fn(*ptrs, dq.data_ptr(), *dims, stream)
    build.check(lib, err, "flash_attention backward dq")
    dq_launches += 1
    return dq


def _launch_dkv(q, k, v, do, lse, delta, causal, scale):
    """The dk/dv kernel on operands from :func:`_bwd_operands`."""
    global dkv_launches
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    ptrs, dims = _bwd_args(q, k, v, do, lse, delta, causal, scale)
    lib, _, _, dkv_fn, _ = _kernels()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = dkv_fn(*ptrs, dk.data_ptr(), dv.data_ptr(), *dims, stream)
    build.check(lib, err, "flash_attention backward dk/dv")
    dkv_launches += 1
    return dk, dv


def _launch_fused(q, k, v, do, lse, delta, causal, scale):
    """The fused backward kernel on operands from :func:`_bwd_operands`:
    dk, dv, and dq summed in a zeroed fp32 buffer (bulk reductions in
    bf16, atomic adds in fp32), then cast to q's dtype."""
    global fused_launches
    dq32 = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    ptrs, dims = _bwd_args(q, k, v, do, lse, delta, causal, scale)
    lib, *_, fused_fn = _kernels()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fused_fn(*ptrs, dq32.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                       *dims, stream)
    build.check(lib, err, "flash_attention fused backward")
    fused_launches += 1
    return dq32.to(q.dtype), dk, dv


def _bwd_kernels(q, k, v, out, lse, do, causal, scale):
    """The backward kernels, split or fused, on operands of a kernel head
    width.  Causal with N > Nk: the kernels over the rows that see a key
    (row-offset views, as :func:`_fwd_rows`), dq = 0 on the rows that see
    none, and their dO / Nk added into dv by :func:`_nokey_dv`."""
    rows = _nokey_rows(q, k, causal)
    if not rows:
        return _bwd_square(q, k, v, out, lse, do, causal, scale)
    dq_t, dk, dv = _bwd_square(q[:, rows:], k, v, out[:, rows:],
                               lse[:, :, rows:].contiguous(), do[:, rows:],
                               True, scale)
    _nokey_dv(do[:, :rows], dv)
    dq = torch.cat((dq_t.new_zeros((q.shape[0], rows, *q.shape[2:])),
                    dq_t), 1)
    return dq, dk, dv


def _bwd_square(q, k, v, out, lse, do, causal, scale):
    """:func:`_bwd_kernels` where every row sees a key."""
    q, k, v, do, delta = _bwd_operands(q, k, v, out, do)
    if _BWD_FUSED:
        return _launch_fused(q, k, v, do, lse, delta, causal, scale)
    dq = _launch_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = _launch_dkv(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


def _flash_bwd_cuda(q, k, v, out, lse, do, causal):
    return _padded_bwd(_bwd_kernels, q, k, v, out, lse, do, causal)


def _flash_fwd_op_cuda(q, k, v, causal):
    """``paddle_tpu::flash_fwd`` on CUDA tensors: the kernels."""
    _check_cuda(q, k, v, causal)
    return _flash_fwd_cuda(q, k, v, causal)


def _flash_fwd_op_cpu(q, k, v, causal):
    """``paddle_tpu::flash_fwd`` on CPU tensors: :func:`_ref_attention`
    (the CPU's plain path) and the fp32 logsumexp of the scaled scores."""
    s, mask = _scores(q, k, causal)
    lse = torch.logsumexp(s.masked_fill(~mask, NEG_INF), -1)
    return _ref_attention(q, k, v, causal).contiguous(), lse


_LIB = torch.library.Library("paddle_tpu", "FRAGMENT")
_LIB.define("flash_fwd(Tensor q, Tensor k, Tensor v, bool causal) -> "
            "(Tensor, Tensor)")
_LIB.impl("flash_fwd", _flash_fwd_op_cpu, "CPU")
_LIB.impl("flash_fwd", _flash_fwd_op_cuda, "CUDA")


@torch.library.register_fake("paddle_tpu::flash_fwd", lib=_LIB)
def _flash_fwd_fake(q, k, v, causal):
    B, N, nh, _ = q.shape
    return (q.new_empty(q.shape),
            q.new_empty((B, nh, N), dtype=torch.float32))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = torch.ops.paddle_tpu.flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_cuda(q, k, v, out, lse, do, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal=False):
    """Attention over q [B, N, nh, hd] and k, v [B, Nk, nh, hd] (causal:
    bottom-right aligned).  Returns [B, N, nh, hd] in q's dtype.  CPU
    tensors: autograd of :func:`_ref_attention`.  CUDA tensors (float32 or
    bfloat16, any hd): the flash kernels, forward and backward (the split
    or the fused backward, per :func:`set_default_blocks`).  A call that
    needs no gradient is the forward op alone, on either device."""
    if not (torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return torch.ops.paddle_tpu.flash_fwd(q, k, v, bool(causal))[0]
    if q.device.type == "cpu":
        return _ref_attention(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_cuda(q, k, v, causal)
    return _FlashAttention.apply(q, k, v, bool(causal))


def flash_fwd(q, k, v, causal=False):
    """The forward kernel alone: (out, lse [B, nh, N] fp32), no autograd.
    For checks and timing beside :func:`_ref_flash_fwd`."""
    _check_cuda(q, k, v, causal)
    return torch.ops.paddle_tpu.flash_fwd(q, k, v, bool(causal))


def flash_bwd(q, k, v, out, lse, do, causal=False):
    """The backward kernels alone, split or fused per
    :func:`set_default_blocks`: (dq, dk, dv).  For checks and timing beside
    :func:`_ref_flash_bwd`."""
    _check_cuda(q, k, v, causal)
    if do.shape != q.shape or do.dtype != q.dtype or out.shape != q.shape:
        raise ValueError(f"flash_bwd: out {tuple(out.shape)} and do "
                         f"{tuple(do.shape)} {do.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    return _flash_bwd_cuda(q, k, v, out, lse, do, causal)
