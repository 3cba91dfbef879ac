"""The sixteen ``sequence_*`` ops in the padded-plus-lengths form
(counterpart of ``paddle_tpu/nn/functional/sequence.py``).

The reference redesigned the LoD sequence operators for static shapes:
each op takes a padded ``[B, T, ...]`` batch and a ``lengths [B]``
vector and masks, and ``sequence_pad`` / ``sequence_unpad`` convert the
concatenated-rows layout at the boundary.  The port keeps that form and
its conventions op for op: an output keeps the padded width; a width
that depends on the data (``sequence_pad`` without ``maxlen``,
``sequence_expand``, ``sequence_concat``) is read from the lengths on
the host.
"""
from __future__ import annotations

import torch

from ...ops.dispatch import call
from ...tensor.tensor import Tensor


def _mask(lengths, T, dtype=torch.float32):
    return (torch.arange(T, device=lengths.device)[None, :]
            < lengths[:, None]).to(dtype)


def _host_max(lengths):
    v = lengths.value if isinstance(lengths, Tensor) else torch.as_tensor(
        lengths)
    return int(v.max())


def _trail(t, nd):
    """``t`` [B, T] with ``nd - 2`` trailing unit dims."""
    return t.reshape(t.shape + (1,) * (nd - 2))


def sequence_pad(x, lengths, pad_value=0.0, maxlen=None, name=None):
    """Concatenated rows x [sum(lengths), ...] -> [B, maxlen, ...]."""
    T = int(maxlen) if maxlen is not None else _host_max(lengths)

    def _pad(flat, lens):
        starts = torch.cumsum(lens, 0) - lens
        t = torch.arange(T, device=flat.device)[None, :]
        idx = (starts[:, None] + t).clamp(0, flat.shape[0] - 1)
        out = flat[idx]
        valid = _trail(t < lens[:, None], out.dim())
        return torch.where(valid, out, torch.as_tensor(
            pad_value, dtype=out.dtype, device=out.device))
    return call(_pad, x, lengths, _name="sequence_pad")


def sequence_unpad(x, lengths, name=None):
    """[B, T, ...] -> concatenated rows [B * T, ...]; entries past
    sum(lengths) are zeros."""
    def _unpad(padded, lens):
        B, T = padded.shape[:2]
        starts = torch.cumsum(lens, 0) - lens
        t = torch.arange(T, device=padded.device)[None, :]
        valid = t < lens[:, None]
        flat_idx = torch.where(valid, starts[:, None] + t,
                               B * T - 1).reshape(-1)
        src = padded.reshape((B * T,) + padded.shape[2:])
        vmask = valid.reshape((B * T,) + (1,) * (src.dim() - 1))
        vals = torch.where(vmask, src, torch.zeros((), dtype=src.dtype,
                                                   device=src.device))
        return torch.zeros_like(src).index_add(0, flat_idx.long(), vals)
    return call(_unpad, x, lengths, _name="sequence_unpad")


def sequence_pool(x, lengths, pool_type="sum", pad_value=0.0, name=None):
    """Masked pooling over time: sum, average, sqrt, max, first, last."""
    pool_type = pool_type.lower()
    if pool_type not in ("sum", "average", "mean", "avg", "sqrt", "max",
                         "first", "last"):
        raise ValueError(f"unknown pool_type {pool_type}")

    def _pool(padded, lens):
        nd = padded.dim()
        mm = _trail(_mask(lens, padded.shape[1], padded.dtype), nd)
        per_row = (-1,) + (1,) * (nd - 2)
        if pool_type == "sum":
            return (padded * mm).sum(1)
        if pool_type in ("average", "mean", "avg"):
            return (padded * mm).sum(1) / torch.clamp(
                lens.to(padded.dtype), min=1).reshape(per_row)
        if pool_type == "sqrt":
            return (padded * mm).sum(1) / torch.clamp(
                lens.to(padded.dtype), min=1).sqrt().reshape(per_row)
        if pool_type == "max":
            neg = torch.finfo(padded.dtype).min
            return torch.where(mm > 0, padded, neg).amax(1)
        if pool_type == "first":
            return padded[:, 0]
        idx = torch.clamp(lens - 1, min=0).long()
        return padded[torch.arange(padded.shape[0], device=padded.device),
                      idx]
    return call(_pool, x, lengths, _name=f"sequence_pool_{pool_type}")


def sequence_softmax(x, lengths, name=None):
    """Softmax over each row's valid steps (0 past the length)."""
    def _sm(padded, lens):
        v = _trail(_mask(lens, padded.shape[1]) > 0, padded.dim())
        logits = torch.where(v, padded.float(), float("-inf"))
        out = torch.softmax(logits, 1)
        return torch.where(v, out, 0.0).to(padded.dtype)
    return call(_sm, x, lengths, _name="sequence_softmax")


def sequence_reverse(x, lengths, name=None):
    """Each row's valid prefix reversed; padding stays in place."""
    def _rev(padded, lens):
        t = torch.arange(padded.shape[1], device=padded.device)[None, :]
        src = torch.where(t < lens[:, None], lens[:, None] - 1 - t, t)
        rows = torch.arange(padded.shape[0], device=padded.device)[:, None]
        return padded[rows, src.long()]
    return call(_rev, x, lengths, _name="sequence_reverse")


def sequence_expand(x, ref_lengths, name=None):
    """Row i of x repeated over ref_lengths[i] steps: [B, max, ...]."""
    T = _host_max(ref_lengths)

    def _expand(xv, lens):
        out = xv[:, None].expand((xv.shape[0], T) + xv.shape[1:])
        return out * _trail(_mask(lens, T, xv.dtype), xv.dim() + 1)
    return call(_expand, x, ref_lengths, _name="sequence_expand")


def sequence_concat(xs, lengths_list, name=None):
    """Row i of the result: every input's valid prefix of row i, in
    order.  Returns (padded [B, sum of maxima, ...], lengths)."""
    T_out = sum(_host_max(ln) for ln in lengths_list)

    def _concat(*vals):
        n = len(vals) // 2
        padded, lens = vals[:n], vals[n:]
        B = padded[0].shape[0]
        feat = padded[0].shape[2:]
        dev = padded[0].device
        out = torch.zeros((B, T_out) + feat, dtype=padded[0].dtype,
                          device=dev)
        offset = torch.zeros((B,), dtype=torch.int32, device=dev)
        rows_b = torch.arange(B, device=dev)[:, None]
        for p, ln in zip(padded, lens):
            t = torch.arange(p.shape[1], device=dev)[None, :]
            valid = t < ln[:, None]
            dest = torch.where(valid, offset[:, None] + t, T_out - 1)
            rows = rows_b.expand(dest.shape)
            vals_m = torch.where(_trail(valid, p.dim()), p,
                                 torch.zeros((), dtype=p.dtype, device=dev))
            out = out.index_put((rows.reshape(-1), dest.reshape(-1).long()),
                                vals_m.reshape((-1,) + feat),
                                accumulate=True)
            offset = offset + ln.to(torch.int32)
        return out, offset
    return call(_concat, *(list(xs) + list(lengths_list)),
                _name="sequence_concat")


def sequence_enumerate(x, win_size, pad_value=0, name=None):
    """Sliding windows of ids: [B, T] -> [B, T, win_size], positions past
    T filled with ``pad_value``."""
    def _enum(ids):
        T = ids.shape[1]
        t = (torch.arange(T, device=ids.device)[:, None]
             + torch.arange(win_size, device=ids.device)[None, :])
        out = ids[:, t.clamp(0, T - 1)]
        return torch.where((t < T)[None], out, torch.as_tensor(
            pad_value, dtype=ids.dtype, device=ids.device))
    return call(_enum, x, _name="sequence_enumerate")


def sequence_erase(x, lengths, tokens, pad_value=0, name=None):
    """The listed ids removed and each row's valid prefix compacted.
    Returns (compacted [B, T], new lengths)."""
    tokens = tuple(int(t) for t in tokens)

    def _erase(ids, lens):
        T = ids.shape[1]
        t = torch.arange(T, device=ids.device)[None, :]
        keep = t < lens[:, None]
        for tok in tokens:
            keep = keep & (ids != tok)
        key = torch.where(keep, t, T + t)
        order = torch.argsort(key, 1)
        compacted = torch.gather(ids, 1, order)
        new_len = keep.to(torch.int32).sum(1, dtype=torch.int32)
        return (torch.where(t < new_len[:, None], compacted, torch.as_tensor(
            pad_value, dtype=ids.dtype, device=ids.device)), new_len)
    return call(_erase, x, lengths, _name="sequence_erase")


def sequence_conv(x, lengths, weight, context_size=3, context_start=None,
                  name=None):
    """Each step's context window (zeros outside the row) times
    ``weight [context_size * H, F]``; 0 past the length."""
    if context_start is None:
        context_start = -((context_size - 1) // 2)

    def _conv(padded, lens, w):
        B, T, H = padded.shape
        t = torch.arange(T, device=padded.device)[None, :]
        valid = t < lens[:, None]
        rows = torch.arange(B, device=padded.device)[:, None]
        cols = []
        for k in range(context_size):
            src = t + context_start + k
            ok = valid & (src >= 0) & (src < lens[:, None])
            g = padded[rows, src.clamp(0, T - 1).expand(B, T)]
            cols.append(torch.where(ok[..., None], g, 0.0))
        out = torch.cat(cols, -1) @ w
        return torch.where(valid[..., None], out, 0.0)
    return call(_conv, x, lengths, weight, _name="sequence_conv")


def sequence_first_step(x, lengths, name=None):
    return sequence_pool(x, lengths, "first")


def sequence_last_step(x, lengths, name=None):
    return sequence_pool(x, lengths, "last")


def sequence_reshape(x, lengths, new_dim, name=None):
    """[B, T, D] -> [B, T * D / new_dim, new_dim]; lengths scale by
    D / new_dim.  Returns (out, new lengths)."""
    D, T = int(x.shape[-1]), int(x.shape[1])
    if (T * D) % new_dim:
        raise ValueError(f"sequence_reshape: T * D = {T * D} is not a "
                         f"multiple of new_dim {new_dim}")
    return call(lambda p, lens: (p.reshape(p.shape[0], T * D // new_dim,
                                           new_dim),
                                 lens * D // new_dim),
                x, lengths, _name="sequence_reshape")


def sequence_expand_as(x, ref_lengths, maxlen=None, name=None):
    """x [B, ...] -> [B, T, ...], row b repeated over ref_lengths[b]."""
    T = int(maxlen) if maxlen is not None else _host_max(ref_lengths)

    def _ea(xv, lens):
        out = xv[:, None].expand((xv.shape[0], T) + xv.shape[1:])
        return out * _trail(_mask(lens, T, out.dtype), out.dim())
    return call(_ea, x, ref_lengths, _name="sequence_expand_as")


def sequence_slice(x, lengths, offset, length, name=None):
    """out[b, j] = x[b, offset[b] + j] for j < length[b] (and inside the
    row), zeros beyond; the padded width kept.  Returns (out, length)."""
    def _sl(padded, lens, off, ln):
        B, T = padded.shape[:2]
        off = off.reshape(B).to(torch.int32)
        ln = ln.reshape(B).to(torch.int32)
        t = torch.arange(T, device=padded.device)[None, :]
        idx = off[:, None] + t
        valid = (t < ln[:, None]) & (idx < lens[:, None].to(torch.int32))
        rows = torch.arange(B, device=padded.device)[:, None]
        out = padded[rows, idx.clamp(0, T - 1).long()]
        return (torch.where(_trail(valid, out.dim()), out,
                            torch.zeros((), dtype=out.dtype,
                                        device=out.device)), ln)
    return call(_sl, x, lengths, offset, length, _name="sequence_slice")


def sequence_scatter(x, index, updates, lengths, name=None):
    """out[b, index[b, s]] += updates[b, s] for s < lengths[b]."""
    def _sc(xv, idx, upd, lens):
        B, S = idx.shape
        valid = torch.arange(S, device=xv.device)[None, :] < lens[:, None]
        idx = idx.to(torch.int64).clamp(0, xv.shape[1] - 1)
        upd = torch.where(valid, upd, torch.zeros(
            (), dtype=upd.dtype, device=upd.device)).to(xv.dtype)
        bidx = torch.arange(B, device=xv.device)[:, None].expand(B, S)
        return xv.index_put((bidx.reshape(-1), idx.reshape(-1)),
                            upd.reshape(-1), accumulate=True)
    return call(_sc, x, index, updates, lengths, _name="sequence_scatter")
