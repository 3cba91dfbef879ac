"""Search and sort ops (counterpart of ``paddle_tpu/tensor/search.py``).
Index outputs are int32; sorts are stable, so ties keep their order as
the reference's ``jnp.argsort`` keeps it.  ``nonzero`` and ``where``
with one argument read their output size back from the input's device;
``mode`` runs on the device (the reference's on the host) and picks the
same value (the smallest of the most frequent) and index (its last)."""
from __future__ import annotations

import torch

from ..framework import core
from ..ops.dispatch import call
from .math import _i64, _promoted
from .tensor import Tensor, _readable


def _arg(tfn, opname):
    def op(x, axis=None, keepdim=False, dtype="int64", name=None):
        dt = core.convert_dtype(dtype)

        def _am(a):
            if a.dtype == torch.bool:      # torch has no bool argmax
                a = a.to(torch.uint8)
            if axis is None:
                return tfn(a.reshape(-1), 0).to(dt)
            return tfn(a, int(axis), keepdim=keepdim).to(dt)
        return call(_am, x, _name=opname)
    op.__name__ = opname
    return op


argmax = _arg(torch.argmax, "argmax")
argmin = _arg(torch.argmin, "argmin")


def argsort(x, axis=-1, descending=False, name=None):
    return call(lambda a: torch.sort(a, dim=int(axis), descending=descending,
                                     stable=True).indices.to(_i64()),
                x, _name="argsort")


def sort(x, axis=-1, descending=False, name=None):
    return call(lambda a: torch.sort(a, dim=int(axis), descending=descending,
                                     stable=True).values, x, _name="sort")


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    kk = int(k.item()) if isinstance(k, Tensor) else int(k)

    def _tk(a):
        ax = -1 if axis is None else int(axis)
        # a stable sort: ties come lowest index first, as lax.top_k's do
        v, i = torch.sort(a, dim=ax, descending=largest, stable=True)
        return v.narrow(ax, 0, kk), i.narrow(ax, 0, kk).to(_i64())
    return call(_tk, x, _name="topk")


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    return call(lambda c, a, b: torch.where(
        c.bool(), *_promoted(a, b, scalars=True)), condition, x, y,
        _name="where")


def nonzero(x, as_tuple=False):
    """[n, ndim] int32 indices of the nonzero entries, or a tuple of
    ndim [n, 1] columns."""
    def _nz(a):
        nz = torch.nonzero(_readable(a, "nonzero")).to(_i64())
        if as_tuple:
            return tuple(nz[:, d:d + 1] for d in range(a.dim()))
        return nz
    return call(_nz, x, _name="nonzero")


def masked_select(x, mask, name=None):
    from .manipulation import masked_select as _ms
    return _ms(x, mask)


def index_select(x, index, axis=0, name=None):
    from .manipulation import index_select as _is
    return _is(x, index, axis)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    # int64 is narrowed to int32 under the reference's x64-off, so both
    # settings of out_int32 give int32
    return call(lambda s, v: torch.searchsorted(
        *_promoted(s, v), right=right).to(_i64()),
        sorted_sequence, values, _name="searchsorted")


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32, right)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    """The k-th smallest along ``axis`` and its index (ties in stable
    order)."""
    def _kv(a):
        ax = int(axis)
        vals, idxs = torch.sort(a, dim=ax, stable=True)
        v = vals.select(ax, k - 1)
        i = idxs.select(ax, k - 1)
        if keepdim:
            v, i = v.unsqueeze(ax), i.unsqueeze(ax)
        return v, i.to(_i64())
    return call(_kv, x, _name="kthvalue")


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the smallest of those
    tied) and the index of its last occurrence."""
    def _mode(a):
        ax = axis % a.dim()
        # a stable sort puts equal values in runs, each run's original
        # indices ascending; the first of the longest runs holds the
        # smallest of the most frequent values, and its last element
        # the index of that value's last occurrence
        s, order = torch.sort(a.movedim(ax, -1), dim=-1, stable=True)
        start = torch.ones_like(s, dtype=torch.bool)
        start[..., 1:] = s[..., 1:] != s[..., :-1]
        run = start.cumsum(-1) - 1
        length = torch.zeros_like(run).scatter_add_(-1, run,
                                                    torch.ones_like(run))
        length = length.gather(-1, run)
        most = length.amax(-1, keepdim=True)
        first = (length == most).to(torch.uint8).argmax(-1, keepdim=True)
        val = s.gather(-1, first).squeeze(-1)
        idx = order.gather(-1, first + most - 1).squeeze(-1)
        if keepdim:
            val, idx = val.unsqueeze(ax), idx.unsqueeze(ax)
        return val, idx.to(_i64())
    # computed on the host in the reference: no gradient
    return call(_mode, x.detach(), _name="mode")


def _install():
    T = Tensor
    for nm in ("argmax argmin argsort sort topk where nonzero searchsorted "
               "bucketize kthvalue mode").split():
        setattr(T, nm, globals()[nm])


_install()


__all__ = [_n for _n, _v in list(globals().items())
           if not _n.startswith("_")
           and getattr(_v, "__module__", None) == __name__]
