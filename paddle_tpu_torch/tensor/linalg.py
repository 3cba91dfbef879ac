"""Linear algebra ops (counterpart of ``paddle_tpu/tensor/linalg.py``) on
``torch.linalg`` (cuSOLVER and cuBLAS on the card).

``eig`` and ``eigvals`` run where their input is, as ``torch.linalg``
runs them; the reference computes them on the host, and so they do not
record a gradient here either.  ``lstsq`` solves through the SVD as
``jnp.linalg.lstsq`` does (``torch.linalg.lstsq`` has no residuals, rank
or singular values on the card) and returns its four outputs."""
from __future__ import annotations

import torch

from ..ops.dispatch import call
from .math import _i64, bmm, dot, matmul, multi_dot, mv  # noqa: F401
from .tensor import Tensor

_INF = float("inf")


def _pnorm(a, p, dim, keepdim):
    if p == _INF:
        return torch.amax(torch.abs(a), dim=dim, keepdim=keepdim)
    if p == -_INF:
        return torch.amin(torch.abs(a), dim=dim, keepdim=keepdim)
    if p == 0:
        return torch.sum((a != 0).to(a.dtype), dim=dim, keepdim=keepdim,
                         dtype=a.dtype)
    return torch.pow(torch.sum(torch.pow(torch.abs(a), p), dim=dim,
                               keepdim=keepdim), 1.0 / p)


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    """The 2-norm of every entry (``fro`` or 2) or a p-norm, of the
    flattened tensor (``axis`` None) or along ``axis``."""
    def _norm(a):
        if axis is None:
            flat = a.reshape(-1)
            if p in ("fro", 2):
                return torch.sqrt(torch.sum(flat * flat))
            return _pnorm(flat, p, 0, False)
        ax = tuple(axis) if isinstance(axis, (list, tuple)) else int(axis)
        if p == "fro":
            return torch.sqrt(torch.sum(a * a, dim=ax, keepdim=keepdim))
        return _pnorm(a, p, ax, keepdim)
    return call(_norm, x, _name="norm")


def dist(x, y, p=2, name=None):
    return call(lambda a, b: _pnorm((a - b).reshape(-1), p, 0, False), x, y,
                _name="dist")


def cross(x, y, axis=9, name=None):
    def _c(a, b):
        ax = axis
        if ax == 9:  # the first axis of size 3
            ax = next(i for i, s in enumerate(a.shape) if s == 3)
        return torch.linalg.cross(a, b, dim=ax)
    return call(_c, x, y, _name="cross")


def t(x, name=None):
    from .manipulation import t as _t
    return _t(x)


def cholesky(x, upper=False, name=None):
    return call(lambda a: torch.linalg.cholesky(a, upper=upper), x,
                _name="cholesky")


def histogram(input, bins=100, min=0, max=0, name=None):
    """Counts (int32) of ``bins`` equal bins over [min, max], or over
    the input's own range when both are 0."""
    def _h(a):
        a = a.reshape(-1)
        if a.dtype not in (torch.float32, torch.float64):
            a = a.to(torch.float32)
        lo, hi = ((min, max) if (min != 0 or max != 0)
                  else (a.min(), a.max()))
        return _histc(a, bins, lo, hi).to(_i64())
    return call(_h, input, _name="histogram")


def _histc(a, bins, lo, hi):
    """``np.histogram`` counts: bins of width (hi - lo) / bins, the last
    closed on the right, entries outside [lo, hi] dropped."""
    edges = torch.linspace(lo, hi, bins + 1, dtype=a.dtype, device=a.device)
    idx = torch.searchsorted(edges, a, right=True) - 1
    idx = torch.where(a == hi, bins - 1, idx)
    keep = (a >= lo) & (a <= hi)
    return torch.zeros(bins, dtype=torch.int64, device=a.device).index_add_(
        0, idx.clamp(0, bins - 1), keep.to(torch.int64))


def matrix_power(x, n, name=None):
    return call(lambda a: torch.linalg.matrix_power(a, n), x,
                _name="matrix_power")


def _inexact(a):
    """``a``, a bool or integer input as float32: the decompositions
    compute in float, as jnp's do."""
    return a if a.is_floating_point() or a.is_complex() else a.to(
        torch.float32)


def svd(x, full_matrices=False, name=None):
    return call(lambda a: tuple(torch.linalg.svd(
        _inexact(a), full_matrices=full_matrices)), x, _name="svd")


def qr(x, mode="reduced", name=None):
    def _qr(a):
        a = _inexact(a)
        if mode == "r":
            return torch.linalg.qr(a, mode="r").R
        return tuple(torch.linalg.qr(a, mode=mode))
    return call(_qr, x, _name="qr")


def eig(x, name=None):
    return call(lambda a: tuple(torch.linalg.eig(a)), x.detach(),
                _name="eig")


def eigh(x, UPLO="L", name=None):
    return call(lambda a: tuple(torch.linalg.eigh(a, UPLO=UPLO)), x,
                _name="eigh")


def eigvals(x, name=None):
    return call(torch.linalg.eigvals, x.detach(), _name="eigvals")


def eigvalsh(x, UPLO="L", name=None):
    return call(lambda a: torch.linalg.eigvalsh(a, UPLO=UPLO), x,
                _name="eigvalsh")


def inv(x, name=None):
    return call(torch.linalg.inv, x, _name="inv")


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return call(lambda a: torch.linalg.pinv(_inexact(a), rtol=rcond,
                                            hermitian=hermitian),
                x, _name="pinv")


def det(x, name=None):
    return call(torch.linalg.det, x, _name="det")


def slogdet(x, name=None):
    """[sign, log|det|] stacked."""
    return call(lambda a: torch.stack(tuple(torch.linalg.slogdet(a))), x,
                _name="slogdet")


def solve(x, y, name=None):
    return call(torch.linalg.solve, x, y, _name="solve")


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    def _ts(a, b):
        aa = a.transpose(-1, -2) if transpose else a
        # a transposed upper matrix is lower
        return torch.linalg.solve_triangular(
            aa, b, upper=upper != transpose, unitriangular=unitriangular)
    return call(_ts, x, y, _name="triangular_solve")


def cholesky_solve(x, y, upper=False, name=None):
    """Solves A z = x where ``y`` is A's Cholesky factor."""
    def _cs(b, f):
        z = torch.linalg.solve_triangular(f, b, upper=upper)
        return torch.linalg.solve_triangular(f.transpose(-1, -2), z,
                                             upper=not upper)
    return call(_cs, x, y, _name="cholesky_solve")


def lstsq(x, y, rcond=None, driver=None, name=None):
    """(solution, residuals, rank, singular values), through the SVD for
    every LAPACK routine Paddle's signature may name."""
    def _ls(a, b):
        vec = b.dim() == 1
        if vec:
            b = b[:, None]
        m, n = a.shape
        eps = torch.finfo(a.dtype).eps
        rc = eps * max(m, n) if rcond is None else (
            eps if rcond < 0 else rcond)
        u, s, vt = torch.linalg.svd(a, full_matrices=False)
        mask = (s > 0) & (s >= rc * s[0])
        rank = mask.sum().to(_i64())
        s_inv = torch.where(mask, 1 / torch.where(mask, s, 1.0), 0.0)[:, None]
        sol = vt.transpose(0, 1) @ (s_inv * (u.transpose(0, 1) @ b))
        resid = torch.sum((b - a @ sol) ** 2, dim=0)
        return (sol.reshape(-1) if vec else sol), resid, rank, s
    return call(_ls, x, y, _name="lstsq")


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return call(lambda a: torch.linalg.matrix_rank(
        _inexact(a), rtol=tol, hermitian=hermitian).to(_i64()), x,
        _name="matrix_rank")


def cond(x, p=None, name=None):
    return call(lambda a: torch.linalg.cond(_inexact(a), p=p), x,
                _name="cond")


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    def _cov(a, fw, aw):
        a = _inexact(a)
        return torch.cov(a if rowvar else a.transpose(0, 1),
                         correction=1 if ddof else 0,
                         fweights=fw, aweights=aw)
    return call(_cov, x, fweights, aweights, _name="cov")


def corrcoef(x, rowvar=True, name=None):
    return call(lambda a: torch.corrcoef(
        _inexact(a) if rowvar else _inexact(a).transpose(0, 1)),
        x, _name="corrcoef")


def _install():
    for nm in ("norm dist cross cholesky histogram matrix_power svd qr eigh "
               "eigvalsh inv pinv det slogdet solve triangular_solve "
               "cholesky_solve lstsq matrix_rank cond").split():
        setattr(Tensor, nm, globals()[nm])


_install()


__all__ = [_n for _n, _v in list(globals().items())
           if not _n.startswith("_")
           and getattr(_v, "__module__", None) == __name__]
