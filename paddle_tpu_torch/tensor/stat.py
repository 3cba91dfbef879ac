"""Statistics ops (counterpart of ``paddle_tpu/tensor/stat.py``).

``median`` and ``quantile`` interpolate linearly between the order
statistics, as ``jnp.median`` and ``jnp.quantile`` do (``torch.median``
takes the lower middle value); ``nanmedian`` does the same over the
entries that are not NaN.  Integer inputs give float32."""
from __future__ import annotations

import torch

from ..ops.dispatch import call
from .math import _all_dims, _axis, _dims, _float_in
from .tensor import Tensor


def mean(x, axis=None, keepdim=False, name=None):
    from .math import mean as _m
    return _m(x, axis, keepdim)


def _moment(tfn, x, axis, unbiased, keepdim, opname):
    ax = _axis(axis)
    ddof = 1 if unbiased else 0
    return call(_float_in(lambda a: tfn(a, dim=_dims(ax, a), correction=ddof,
                                        keepdim=keepdim)), x, _name=opname)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _moment(torch.std, x, axis, unbiased, keepdim, "std")


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _moment(torch.var, x, axis, unbiased, keepdim, "var")


def _quantiles(v, q, dim):
    """Linear interpolation at quantiles ``q`` (a 0-d or 1-d float tensor)
    of ``v`` along ``dim``, where ``n`` (broadcast against ``v`` without
    ``dim``) entries of each row count and they are sorted first."""
    s = torch.sort(v, dim=dim).values
    n = s.shape[dim]
    pos = q.to(s.dtype) * (n - 1)
    lo = torch.floor(pos)
    frac = pos - lo
    lo = lo.long().clamp(0, n - 1)
    hi = (lo + 1).clamp(max=n - 1)
    s = s.movedim(dim, -1)
    a = s[..., lo]
    b = s[..., hi]
    out = a + (b - a) * frac
    return out.movedim(-1, 0) if q.dim() else out


def median(x, axis=None, keepdim=False, name=None):
    ax = None if axis is None else int(axis)

    def _med(a):
        q = torch.full((), 0.5, device=a.device)
        return _all_dims(a, ax, keepdim, lambda v, d, k: (
            _quantiles(v, q, d).unsqueeze(d) if k else _quantiles(v, q, d)))
    return call(_float_in(_med), x, _name="median")


def _nanmedian_row(v, d, k):
    """The median of the entries of ``v`` along ``d`` that are not NaN
    (NaN where there is none)."""
    s = torch.sort(v, dim=d).values.movedim(d, -1)      # NaNs sort last
    n = (~torch.isnan(s)).sum(-1, keepdim=True)
    pos = (n - 1).clamp(min=0).to(s.dtype) * 0.5
    lo = torch.floor(pos).long()
    hi = torch.ceil(pos).long()
    a = torch.gather(s, -1, lo)
    b = torch.gather(s, -1, hi)
    out = (a + (b - a) * (pos - lo)).squeeze(-1)
    out = torch.where(n.squeeze(-1) > 0, out,
                      torch.full((), float("nan"), dtype=s.dtype,
                                 device=s.device))
    return out.unsqueeze(d) if k else out


def nanmedian(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return call(_float_in(lambda a: _all_dims(a, ax, keepdim,
                                              _nanmedian_row)),
                x, _name="nanmedian")


def quantile(x, q, axis=None, keepdim=False, name=None):
    """Quantile(s) ``q`` along ``axis`` (every entry for None); a list of
    q puts its dim first, as ``jnp.quantile``."""
    ax = None if axis is None else int(axis)

    def _quant(a):
        qt = torch.as_tensor(q, dtype=a.dtype).to(a.device)
        if ax is None:
            out = _quantiles(a.reshape(-1), qt, 0)
            if keepdim:
                out = out.reshape(tuple(qt.shape) + (1,) * a.dim())
            return out
        out = _quantiles(a, qt, ax)
        if keepdim:
            out = out.unsqueeze(ax + (1 if qt.dim() else 0)
                                if ax >= 0 else ax)
        return out
    return call(_float_in(_quant), x, _name="quantile")


def numel(x, name=None):
    from .creation import numel as _n
    return _n(x)


def _install():
    for nm in "std var median nanmedian quantile".split():
        setattr(Tensor, nm, globals()[nm])


_install()


__all__ = [_n for _n, _v in list(globals().items())
           if not _n.startswith("_")
           and getattr(_v, "__module__", None) == __name__]
