"""Shape and indexing ops (counterpart of
``paddle_tpu/tensor/manipulation.py``).  The in-place forms
(``reshape_`` ...) rebind their tensor, as the reference's do.  Index
outputs are int32 (the reference's int64 under x64-off); the ops whose
output size depends on the data (``unique``, ``unique_consecutive``,
``masked_select``) run on the input's device and read their size back
from it; the reference computes them on the host, so they record no
gradient here either."""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..ops.dispatch import call
from .math import _i64, _promoted
from .tensor import Tensor, _readable


def _v(x):
    return x.value if isinstance(x, Tensor) else x


def _ints(seq):
    if isinstance(seq, Tensor):
        return tuple(int(s) for s in seq.tolist())
    if isinstance(seq, (int, np.integer)):
        return (int(seq),)
    return tuple(int(s.item()) if isinstance(s, Tensor) else _dim(s)
                 for s in seq)


def _dim(s):
    """``s`` as an int; a symbolic size stays symbolic, so that
    ``torch.export`` keeps a dynamic batch through shape arithmetic."""
    return s if isinstance(s, torch.SymInt) else int(s)


def _int(v):
    return int(v.item()) if isinstance(v, Tensor) else int(v)


def reshape(x, shape, name=None):
    """-1 infers a dim; 0 copies the input's dim at that index."""
    shp = _ints(shape)

    def _r(a):
        return a.reshape([a.shape[i] if s == 0 else s
                          for i, s in enumerate(shp)])
    return call(_r, x, _name="reshape")


def reshape_(x, shape, name=None):
    return x._rebind(reshape(x, shape))


def transpose(x, perm=None, name=None):
    p = _ints(perm) if perm is not None else None
    return call(lambda a: a.permute(p if p is not None
                                    else tuple(range(a.dim()))[::-1]), x,
                _name="transpose")


def t(x, name=None):
    return call(lambda a: a.t() if a.dim() == 2 else a.clone(), x, _name="t")


def concat(x, axis=0, name=None):
    ax = _int(axis)
    return call(lambda xs: torch.cat(_promoted(*xs), dim=ax), list(x),
                _name="concat")


def stack(x, axis=0, name=None):
    return call(lambda xs: torch.stack(_promoted(*xs), dim=int(axis)), list(x),
                _name="stack")


def split(x, num_or_sections, axis=0, name=None):
    """``num_or_sections`` equal parts, or parts of the given sizes (one
    of them may be -1: the rest).  Returns a list of Tensors."""
    ax = _int(axis)
    dim = x.shape[ax]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections:
            raise ValueError(f"split: {dim} does not divide into "
                             f"{num_or_sections} parts")
        secs = [dim // num_or_sections] * num_or_sections
    else:
        secs = list(_ints(num_or_sections))
        if -1 in secs:
            secs[secs.index(-1)] = dim - builtins.sum(s for s in secs
                                                      if s != -1)
    outs = call(lambda a: tuple(torch.split(a, secs, dim=ax)), x,
                _name="split")
    return list(outs)


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def unstack(x, axis=0, num=None):
    n = num if num is not None else x.shape[axis]
    outs = call(lambda a: tuple(a.movedim(axis, 0)[i] for i in range(n)), x,
                _name="unstack")
    return list(outs) if isinstance(outs, tuple) else [outs]


def unbind(input, axis=0):
    return unstack(input, axis)


def squeeze(x, axis=None, name=None):
    """Drops the given dims (those of size 1; others stay), or every dim
    of size 1."""
    def _sq(a):
        if axis is None:
            return a.squeeze()
        axes = tuple(d % a.dim() for d in _ints(axis)) if a.dim() else ()
        axes = tuple(d for d in axes if a.shape[d] == 1)
        return a.squeeze(axes) if axes else a.clone()
    return call(_sq, x, _name="squeeze")


def squeeze_(x, axis=None, name=None):
    return x._rebind(squeeze(x, axis))


def unsqueeze(x, axis, name=None):
    axes = _ints(axis)

    def _usq(a):
        out = a
        nd = a.dim() + len(axes)
        for d in sorted(d % nd for d in axes):
            out = out.unsqueeze(d)
        return out
    return call(_usq, x, _name="unsqueeze")


def unsqueeze_(x, axis, name=None):
    return x._rebind(unsqueeze(x, axis))


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    """Dims ``start_axis`` to ``stop_axis`` (inclusive) joined into one."""
    def _fl(a):
        nd = a.dim()
        s = start_axis % nd if nd else 0
        e = stop_axis % nd if nd else 0
        return a.reshape(tuple(a.shape[:s]) + (-1,) + tuple(a.shape[e + 1:]))
    return call(_fl, x, _name="flatten")


def flatten_(x, start_axis=0, stop_axis=-1, name=None):
    return x._rebind(flatten(x, start_axis, stop_axis))


def gather(x, index, axis=0, name=None):
    ax = _int(axis)

    def _g(a, i):
        return torch.index_select(a, ax, i.reshape(-1).long())
    return call(_g, x, index, _name="gather")


def gather_nd(x, index, name=None):
    def _gnd(a, i):
        return a[tuple(i.long().movedim(-1, 0))]
    return call(_gnd, x, index, _name="gather_nd")


def scatter(x, index, updates, overwrite=True, name=None):
    """Rows ``index`` of x set to ``updates`` (``overwrite``), or zeroed
    and then summed over the updates that index them."""
    def _sc(a, i, u):
        i = (i.reshape(-1).long(),)
        u = u.to(a.dtype)
        if overwrite:
            return a.index_put(i, u)
        return a.index_put(i, torch.zeros_like(u)).index_put(
            i, u, accumulate=True)
    return call(_sc, x, index, updates, _name="scatter")


def scatter_(x, index, updates, overwrite=True, name=None):
    return x._rebind(scatter(x, index, updates, overwrite))


def scatter_nd_add(x, index, updates, name=None):
    def _snd(a, i, u):
        return a.index_put(tuple(i.long().movedim(-1, 0)), u.to(a.dtype),
                           accumulate=True)
    return call(_snd, x, index, updates, _name="scatter_nd_add")


def scatter_nd(index, updates, shape, name=None):
    shp = _ints(shape)

    def _snd(i, u):
        z = torch.zeros(shp, dtype=u.dtype, device=u.device)
        return z.index_put(tuple(i.long().movedim(-1, 0)), u,
                           accumulate=True)
    return call(_snd, index, updates, _name="scatter_nd_add")


def slice(input, axes, starts, ends):
    axes, starts, ends = _ints(axes), _ints(starts), _ints(ends)

    def _sl(a):
        idx = [builtins.slice(None)] * a.dim()
        for ax, s, e in zip(axes, starts, ends):
            idx[ax] = builtins.slice(s, e)
        return a[tuple(idx)]
    return call(_sl, input, _name="slice")


def strided_slice(x, axes, starts, ends, strides, name=None):
    """Python slicing along ``axes``; a negative stride walks backwards
    (torch slices only forwards, so those dims are gathered)."""
    axes, starts, ends, strides = map(_ints, (axes, starts, ends, strides))

    def _ss(a):
        out = a
        for ax, s, e, st in zip(axes, starts, ends, strides):
            sl = builtins.slice(s, e, st)
            if st > 0:
                idx = [builtins.slice(None)] * a.dim()
                idx[ax] = sl
                out = out[tuple(idx)]
            else:
                r = range(*sl.indices(out.shape[ax]))
                out = torch.index_select(out, ax, torch.arange(
                    r.start, r.stop, r.step, device=a.device))
        return out
    return call(_ss, x, _name="strided_slice")


def tile(x, repeat_times, name=None):
    reps = _ints(repeat_times)
    return call(lambda a: torch.tile(a, reps), x, _name="tile")


def expand(x, shape, name=None):
    shp = list(_ints(shape))

    def _ex(a):
        tgt = list(shp)
        off = len(tgt) - a.dim()
        for i in range(a.dim()):
            if tgt[off + i] == -1:
                tgt[off + i] = a.shape[i]
        return torch.broadcast_to(a, tuple(tgt))
    return call(_ex, x, _name="expand")


def expand_as(x, y, name=None):
    return expand(x, y.shape)


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def broadcast_tensors(input, name=None):
    outs = call(lambda xs: tuple(torch.broadcast_tensors(*xs)), list(input),
                _name="broadcast_tensors")
    return list(outs) if isinstance(outs, tuple) else [outs]


def flip(x, axis, name=None):
    axes = _ints(axis)
    return call(lambda a: torch.flip(a, axes), x, _name="flip")


def reverse(x, axis, name=None):
    return flip(x, axis)


def roll(x, shifts, axis=None, name=None):
    sh = _ints(shifts)
    ax = _ints(axis) if axis is not None else None

    def _roll(a):
        if ax is None:
            return torch.roll(a.reshape(-1), builtins.sum(sh)).reshape(
                a.shape)
        return torch.roll(a, sh, ax)
    return call(_roll, x, _name="roll")


def rot90(x, k=1, axes=(0, 1), name=None):
    return call(lambda a: torch.rot90(a, k, tuple(axes)), x, _name="rot90")


def _first_index(inv, n, length, device):
    """For each of ``n`` groups, the smallest position whose ``inv`` is
    that group."""
    pos = torch.arange(length, device=device)
    first = torch.full((n,), length, dtype=pos.dtype, device=device)
    return first.scatter_reduce(0, inv, pos, "amin")


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """The sorted unique values (of the flattened input, or slices along
    ``axis``), with the first index, the inverse and the counts asked
    for, as ``np.unique`` gives them."""
    def _u(a):
        _readable(a, "unique")
        vals, inv, counts = torch.unique(a, sorted=True, return_inverse=True,
                                         return_counts=True, dim=axis)
        outs = [vals]
        if return_index:
            flat = inv.reshape(-1)
            outs.append(_first_index(flat, counts.shape[0], flat.shape[0],
                                     a.device).to(_i64()))
        if return_inverse:
            outs.append(inv.to(_i64()))
        if return_counts:
            outs.append(counts.to(_i64()))
        return tuple(outs) if len(outs) > 1 else outs[0]
    # computed on the host in the reference: no gradient
    return call(_u, x.detach(), _name="unique")


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    def _uc(a):
        _readable(a, "unique_consecutive")
        vals, inv, counts = torch.unique_consecutive(
            a.reshape(-1) if axis is None else a, return_inverse=True,
            return_counts=True, dim=None if axis is None else 0)
        outs = [vals]
        if return_inverse:
            outs.append(inv.to(_i64()))
        if return_counts:
            outs.append(counts.to(_i64()))
        return tuple(outs) if len(outs) > 1 else outs[0]
    return call(_uc, x.detach(), _name="unique_consecutive")


def masked_select(x, mask, name=None):
    return call(lambda a, m: a[_readable(m, "masked_select").bool()],
                x.detach(), mask, _name="masked_select")


def index_select(x, index, axis=0, name=None):
    return call(lambda a, i: torch.index_select(a, int(axis), i.long()),
                x, index, _name="index_select")


def index_sample(x, index):
    """out[i, j] = x[i, index[i, j]]."""
    return call(lambda a, i: torch.gather(a, 1, i.long()), x, index,
                _name="index_sample")


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    """Global ids -> ids local to shard ``shard_id`` (``ignore_value``
    for ids of other shards)."""
    def _si(i):
        size = (index_num + nshards - 1) // nshards
        return torch.where(torch.div(i, size, rounding_mode="floor")
                           == shard_id, torch.remainder(i, size),
                           torch.full((), ignore_value, dtype=i.dtype,
                                      device=i.device))
    return call(_si, input, _name="shard_index")


def moveaxis(x, source, destination, name=None):
    return call(lambda a: torch.movedim(a, source, destination), x,
                _name="moveaxis")


def take_along_axis(arr, indices, axis):
    def _ta(a, i):
        i = i.long()
        shape = [builtins.max(sa, si) if d != axis % a.dim() else si
                 for d, (sa, si) in enumerate(zip(a.shape, i.shape))]
        a_shape = list(shape)
        a_shape[axis % a.dim()] = a.shape[axis]
        return torch.gather(a.expand(a_shape), axis, i.expand(shape))
    return call(_ta, arr, indices, _name="take_along_axis")


def put_along_axis(arr, indices, values, axis, reduce="assign"):
    """x with ``values`` written (``assign``), added (``add``) or
    multiplied (``multiply``) at ``indices`` along ``axis``."""
    if reduce not in ("assign", "add", "multiply"):
        raise ValueError(reduce)

    def _pa(a, i, v):
        i = i.long()
        if isinstance(v, torch.Tensor):
            v = torch.broadcast_to(v.to(a.dtype), i.shape)
        else:
            v = torch.full(i.shape, v, dtype=a.dtype, device=a.device)
        if reduce == "assign":
            return a.scatter(axis, i, v)
        if reduce == "add":
            return a.scatter_add(axis, i, v)
        return a.scatter_reduce(axis, i, v, "prod")
    return call(_pa, arr, indices, values, _name="put_along_axis")


def as_complex(x, name=None):
    return call(lambda a: torch.complex(a[..., 0], a[..., 1]), x,
                _name="as_complex")


def as_real(x, name=None):
    return call(lambda a: torch.stack([torch.real(a), torch.imag(a)], -1), x,
                _name="as_real")


def repeat_interleave(x, repeats, axis=None, name=None):
    r = _v(repeats)

    def _ri(a):
        rep = r.to(a.device) if isinstance(r, torch.Tensor) else r
        if axis is None:
            return torch.repeat_interleave(a.reshape(-1), rep)
        return torch.repeat_interleave(a, rep, dim=axis)
    return call(_ri, x, _name="repeat_interleave")


def crop(x, shape=None, offsets=None, name=None):
    shp = _ints(shape)
    offs = _ints(offsets) if offsets is not None else (0,) * len(shp)

    def _crop(a):
        return a[tuple(builtins.slice(o, o + s if s != -1 else None)
                       for o, s in zip(offs, shp))]
    return call(_crop, x, _name="crop")


# legacy 1.x name (fluid/layers/nn.py::crop_tensor)
crop_tensor = crop


def _install():
    T = Tensor
    for nm in ("reshape reshape_ transpose t concat split chunk unbind "
               "squeeze squeeze_ unsqueeze unsqueeze_ flatten flatten_ gather "
               "gather_nd scatter scatter_ scatter_nd_add tile expand "
               "expand_as broadcast_to flip roll rot90 unique "
               "unique_consecutive masked_select index_select index_sample "
               "moveaxis take_along_axis put_along_axis repeat_interleave "
               "unstack as_complex as_real").split():
        setattr(T, nm, globals()[nm])


_install()


__all__ = [_n for _n, _v in list(globals().items())
           if not _n.startswith("_")
           and getattr(_v, "__module__", None) == __name__]
