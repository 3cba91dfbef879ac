"""Math ops (counterpart of ``paddle_tpu/tensor/math.py``), under the
reference's op names (``amp.auto_cast``'s lists select by them), with its
dtypes under JAX's x64-off default.

Promotion follows ``jnp``'s, not torch's (:func:`_result_type`): two
tensors promote by their dtypes whatever their ranks (a 0-d float32
tensor times a bf16 tensor is float32), a Python scalar is weak (it
keeps the tensor's dtype unless its kind is higher: an int tensor and
2.5 give float32, a bool tensor and 1 give int32), and no result is
int64 unless an input is.  ``divide`` of two integer operands truncates
toward zero, ``round`` rounds half away from zero, and integer sums,
products and cumulative ops stay int32.
"""
from __future__ import annotations

import builtins
import functools

import numpy as np
import torch

from ..framework import core
from ..ops.dispatch import call
from .tensor import Tensor, convert

def _v(x):
    return x.value if isinstance(x, Tensor) else x


def _i64():
    """The dtype of an index or count output: int64 narrowed, int32."""
    return core.convert_dtype("int64")


def _weak(dt, s):
    """The dtype of tensor dtype ``dt`` combined with Python scalar ``s``
    (jnp's weak typing, x64 off)."""
    if isinstance(s, bool):
        return dt
    if isinstance(s, int):
        return torch.int32 if dt == torch.bool else dt
    if isinstance(s, float):
        return dt if (dt.is_floating_point or dt.is_complex) else torch.float32
    if isinstance(s, complex):
        if dt.is_complex:
            return dt
        return torch.complex128 if dt == torch.float64 else torch.complex64
    return dt


def _scalar_dtype(s):
    if isinstance(s, bool):
        return torch.bool
    if isinstance(s, int):
        return torch.int32
    if isinstance(s, float):
        return torch.float32
    return torch.complex64


def _result_type(*args):
    """The dtype jnp gives ``args`` (torch tensors and Python scalars;
    ``None`` is skipped)."""
    dt = None
    for a in args:
        if isinstance(a, torch.Tensor):
            dt = a.dtype if dt is None else torch.promote_types(dt, a.dtype)
    scalars = [a for a in args if isinstance(a, (bool, int, float, complex))]
    if dt is None:
        dt = _scalar_dtype(scalars[0]) if scalars else core.get_default_dtype()
        scalars = scalars[1:]
    for s in scalars:
        dt = _weak(dt, s)
    return dt


def _device(*args):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return core.get_place().device


def _promoted(*args, scalars=False):
    """``args`` with every tensor cast to :func:`_result_type`; with
    ``scalars`` Python scalars become 0-d tensors of it too (for torch
    functions that take tensors only)."""
    dt = _result_type(*args)
    dev = _device(*args)
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(a if a.dtype == dt else a.to(dt))
        elif scalars and isinstance(a, (bool, int, float, complex)):
            out.append(torch.full((), a, dtype=dt, device=dev))
        else:
            out.append(a)
    return out


def _acc_dtype(dt):
    """The dtype of jnp's sum or product over an input of dtype ``dt``
    (x64 off): bool and the signed integers give int32, uint8 gives
    uint32, the rest keep their dtype."""
    if dt in (torch.bool, torch.int8, torch.int16, torch.int32):
        return torch.int32
    if dt == torch.uint8:
        return torch.uint32
    return dt


def _is_int(v):
    """An integer operand (a tensor or a Python int; bool is not one)."""
    if isinstance(v, torch.Tensor):
        return not (v.is_floating_point() or v.is_complex()
                    or v.dtype == torch.bool)
    return isinstance(v, int) and not isinstance(v, bool)


def _int_div(a, b, mode):
    """Integer ``a / b`` rounded by ``mode`` ("trunc" or "floor"), with
    XLA's result where ``b`` is 0 (torch raises there on the CPU and is
    undefined on the card): all ones for trunc (-1, or the unsigned
    maximum); for floor, the same on unsigned operands and -1 for a zero
    ``a`` and -2 otherwise on signed ones, as jnp's ``floor_divide``
    gives."""
    zero = b == 0
    q = torch.div(a, torch.where(zero, torch.ones_like(b), b),
                  rounding_mode=mode)
    ones = ~torch.zeros_like(q)
    if mode == "floor" and q.is_signed():
        ones = torch.where(a == 0, ones, ones - 1)
    return torch.where(zero, ones, q)


def _narrow_index(out, *inputs):
    """``out`` in int32 where torch gave int64 and no input was int64."""
    if out.dtype == torch.int64 and not builtins.any(
            isinstance(a, torch.Tensor) and a.dtype == torch.int64
            for a in inputs):
        return out.to(torch.int32)
    return out


# ---------------------------------------------------------------- factories
def _unary(tfn, opname):
    def op(x, name=None):
        return call(tfn, x, _name=opname)
    op.__name__ = opname
    return op


def _same_type(a, b, scalars):
    """True when ``a`` and ``b`` need no promotion: two tensors of one
    dtype, or (unless the op takes tensors only) a tensor and a Python
    scalar whose kind is not above the tensor's."""
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return a.dtype == b.dtype
    if scalars:
        return False
    t, s = (a, b) if isinstance(a, torch.Tensor) else (b, a)
    return isinstance(t, torch.Tensor) and _weak(t.dtype, s) == t.dtype


def _binary(tfn, opname, scalars=False):
    def fn(a, b):
        if _same_type(a, b, scalars):
            return tfn(a, b)
        return _narrow_index(tfn(*_promoted(a, b, scalars=scalars)), a, b)

    def op(x, y, name=None):
        return call(fn, x, y, _name=opname)
    op.__name__ = opname
    return op


def _float_in(tfn):
    """``tfn`` on a float operand: integer and bool inputs are cast to
    float32 first, as jnp's float-valued functions do."""
    def f(a):
        if not (a.is_floating_point() or a.is_complex()):
            a = a.to(torch.float32)
        return tfn(a)
    return f


def _keep_int(tfn):
    """``tfn`` on floats; an integer or bool input comes back as it is
    (jnp's rounding functions are the identity on integers)."""
    def f(a):
        if a.is_floating_point() or a.is_complex():
            return tfn(a)
        return a.clone()
    return f


# ---------------------------------------------------------------- basic
add = _binary(torch.add, "add")
subtract = _binary(torch.sub, "subtract")
multiply = _binary(torch.mul, "multiply")


def _remainder(a, b):
    a2, b2 = _bool_pair_int(a, b)
    if _is_int(a2):
        # x % 0 is 0 in jnp
        b2 = torch.where(b2 == 0, torch.ones_like(b2), b2)
    return _narrow_index(torch.remainder(a2, b2), a, b)


def _floor_divide(a, b):
    a2, b2 = _bool_pair_int(a, b)
    if _is_int(a2):
        return _narrow_index(_int_div(a2, b2, "floor"), a, b)
    return _narrow_index(torch.floor_divide(a2, b2), a, b)


def remainder(x, y, name=None):
    return call(_remainder, x, y, _name="remainder")


def floor_divide(x, y, name=None):
    return call(_floor_divide, x, y, _name="floor_divide")


mod = floor_mod = remainder
maximum = _binary(torch.maximum, "maximum", True)
minimum = _binary(torch.minimum, "minimum", True)
fmax = _binary(torch.fmax, "fmax", True)
fmin = _binary(torch.fmin, "fmin", True)


def _atan2(a, b):
    a, b = _promoted(a, b, scalars=True)
    if not a.is_floating_point():
        a, b = a.to(torch.float32), b.to(torch.float32)
    return torch.atan2(a, b)


def atan2(x, y, name=None):
    return call(_atan2, x, y, _name="atan2")


def _div(a, b):
    both_int = _is_int(a) and _is_int(b)
    dt = _result_type(a, b)
    a, b = _promoted(a, b, scalars=True)
    if both_int:
        # int / int truncates toward zero (C semantics), unlike floor
        # division, which rounds toward -inf; a bool operand is no
        # integer, so it divides in float32
        return _int_div(a, b, "trunc")
    if not (dt.is_floating_point or dt.is_complex):
        a, b = a.to(torch.float32), b.to(torch.float32)
    return torch.true_divide(a, b)


def divide(x, y, name=None):
    return call(_div, x, y, _name="divide")


def _bool_pair_int(a, b):
    """``a`` and ``b`` promoted; two bools become int32, as jnp computes
    the arithmetic ops with no bool form (``pow``, ``floor_divide``,
    ``remainder``)."""
    a, b = _promoted(a, b, scalars=True)
    if a.dtype == torch.bool:
        a, b = a.to(torch.int32), b.to(torch.int32)
    return a, b


def _pow(a, b):
    return _narrow_index(torch.pow(*_bool_pair_int(a, b)), a, b)


def pow(x, y, name=None):
    return call(_pow, x, y, _name="pow")


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    s, b = _v(scale), _v(bias)

    def _scale(a):
        return (a * s + b) if bias_after_scale else (a + b) * s

    def fn(a):
        return _narrow_index(_scale(_promoted(a, s, b)[0]), a)
    out = call(fn, x, _name="scale")
    if act:
        from ..nn import functional as F
        out = getattr(F, act)(out)
    return out


def _round_half_away(a):
    # half away from zero; torch.round rounds half to even
    return torch.sign(a) * torch.floor(torch.abs(a) + 0.5)


abs = _unary(lambda a: a.clone() if a.dtype == torch.bool else torch.abs(a),
             "abs")
ceil = _unary(_keep_int(torch.ceil), "ceil")
floor = _unary(_keep_int(torch.floor), "floor")
round = _unary(_keep_int(_round_half_away), "round")
trunc = _unary(_keep_int(torch.trunc), "trunc")
exp = _unary(_float_in(torch.exp), "exp")
expm1 = _unary(_float_in(torch.expm1), "expm1")
log = _unary(_float_in(torch.log), "log")
log2 = _unary(_float_in(torch.log2), "log2")
log10 = _unary(_float_in(torch.log10), "log10")
log1p = _unary(_float_in(torch.log1p), "log1p")
sqrt = _unary(_float_in(torch.sqrt), "sqrt")
rsqrt = _unary(_float_in(torch.rsqrt), "rsqrt")
square = _unary(lambda a: torch.square(
    a.to(torch.int32) if a.dtype == torch.bool else a), "square")
sin = _unary(_float_in(torch.sin), "sin")
cos = _unary(_float_in(torch.cos), "cos")
tan = _unary(_float_in(torch.tan), "tan")
asin = _unary(_float_in(torch.asin), "asin")
acos = _unary(_float_in(torch.acos), "acos")
atan = _unary(_float_in(torch.atan), "atan")
sinh = _unary(_float_in(torch.sinh), "sinh")
cosh = _unary(_float_in(torch.cosh), "cosh")
tanh = _unary(_float_in(torch.tanh), "tanh")
asinh = _unary(_float_in(torch.asinh), "asinh")
acosh = _unary(_float_in(torch.acosh), "acosh")
atanh = _unary(_float_in(torch.atanh), "atanh")
erf = _unary(_float_in(torch.erf), "erf")
reciprocal = _unary(_float_in(torch.reciprocal), "reciprocal")
sign = _unary(torch.sign, "sign")
neg = _unary(torch.neg, "neg")
# digamma's poles: jnp gives nan at 0 as at the negative integers, torch
# -inf at 0
digamma = _unary(_float_in(lambda a: torch.where(
    a == 0, torch.full_like(a, float("nan")), torch.digamma(a))), "digamma")
lgamma = _unary(_float_in(torch.lgamma), "lgamma")
sigmoid = _unary(_float_in(torch.sigmoid), "sigmoid")


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return call(_float_in(lambda a: scale_b * torch.tanh(scale_a * a)), x,
                _name="stanh")


def multiplex(inputs, index, name=None):
    """Row i of the output is row i of ``inputs[index[i]]``."""
    def _mpx(ins, idx):
        stacked = torch.stack(_promoted(*ins), 0)         # [n, batch, ...]
        idx = idx.reshape(-1).long()
        sel = idx.reshape((1, -1) + (1,) * (stacked.dim() - 2)).expand(
            (1,) + tuple(stacked.shape[1:]))
        return torch.gather(stacked, 0, sel)[0]
    return call(_mpx, list(inputs), index, _name="multiplex")


# ---------------------------------------------------------------- reductions
def _axis(axis):
    if axis is None:
        return None
    if isinstance(axis, Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(ax, a):
    """A torch ``dim`` argument for axis ``ax`` of ``a`` (None: every
    dim, named)."""
    return tuple(range(a.dim())) if ax is None else ax


def _all_dims(a, ax, keepdim, fn):
    """``fn(a, dim, keepdim)`` for reductions whose torch form takes one
    dim: every dim (``ax`` None) flattens first."""
    if ax is None:
        out = fn(a.reshape(-1), 0, False)
        return out.reshape((1,) * a.dim()) if keepdim else out
    if isinstance(ax, tuple):
        nd = a.dim()
        axes = sorted(d % nd for d in ax)
        rest = [d for d in range(nd) if d not in axes]
        moved = a.permute(rest + axes).reshape(
            [a.shape[d] for d in rest] + [-1])
        out = fn(moved, -1, False)
        if keepdim:
            for d in axes:
                out = out.unsqueeze(d)
        return out
    return fn(a, ax, keepdim)


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    """Bool and signed integer sums give int32 (the reference's int64
    under x64-off), uint8 sums uint32, unless ``dtype`` says otherwise."""
    ax = _axis(axis)
    dt = core.convert_dtype(dtype)

    def _sum(a):
        out = torch.sum(a, dim=_dims(ax, a), keepdim=keepdim)
        return out.to(dt if dt is not None else _acc_dtype(a.dtype))
    return call(_sum, x, _name="sum")


def mean(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return call(_float_in(lambda a: torch.mean(a, dim=_dims(ax, a),
                                               keepdim=keepdim)),
                x, _name="mean")


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    ax = _axis(axis)
    dt = core.convert_dtype(dtype)

    def _prod(a):
        if dt is not None:
            a = a.to(dt)
        elif a.dtype == torch.bool:
            a = a.to(torch.int32)
        out = _all_dims(a, ax, keepdim,
                        lambda v, d, k: torch.prod(v, d, keepdim=k))
        return out if dt is not None else out.to(_acc_dtype(a.dtype))
    return call(_prod, x, _name="prod")


def max(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return call(lambda a: torch.amax(a, dim=_dims(ax, a), keepdim=keepdim), x,
                _name="max")


def min(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return call(lambda a: torch.amin(a, dim=_dims(ax, a), keepdim=keepdim), x,
                _name="min")


def amax(x, axis=None, keepdim=False, name=None):
    return max(x, axis, keepdim)


def amin(x, axis=None, keepdim=False, name=None):
    return min(x, axis, keepdim)


def logsumexp(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return call(_float_in(lambda a: torch.logsumexp(
        a, dim=tuple(range(a.dim())) if ax is None else ax,
        keepdim=keepdim)), x, _name="logsumexp")


def _cum(tfn, a, ax, dt):
    """The cumulative op in jnp's dtype: ``dt``, int32 for bool, else the
    input's own (torch accumulates integers in int64; the cast back wraps
    as jnp's narrow accumulator does)."""
    if dt is not None:
        a = a.to(dt)
    elif a.dtype == torch.bool:
        a = a.to(torch.int32)
    if ax is None:
        a, ax = a.reshape(-1), 0
    return tfn(a, int(ax)).to(a.dtype)


def cumsum(x, axis=None, dtype=None, name=None):
    dt = core.convert_dtype(dtype)
    return call(lambda a: _cum(torch.cumsum, a, axis, dt), x, _name="cumsum")


def cumprod(x, dim=None, dtype=None, name=None):
    dt = core.convert_dtype(dtype)
    return call(lambda a: _cum(torch.cumprod, a, dim, dt), x,
                _name="cumprod")


def count_nonzero(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return call(lambda a: torch.sum(a != 0, dim=_dims(ax, a),
                                    keepdim=keepdim).to(_i64()),
                x, _name="count_nonzero")


# ---------------------------------------------------------------- clip & tests
def clip(x, min=None, max=None, name=None):
    lo = _v(min)
    hi = _v(max)

    def _clip(a):
        a, lo_, hi_ = _promoted(a, lo, hi)
        if lo_ is None and hi_ is None:
            return a.clone()
        return torch.clamp(a, lo_, hi_)
    return call(_clip, x, _name="clip")


isfinite = _unary(torch.isfinite, "isfinite")
isinf = _unary(torch.isinf, "isinf")
isnan = _unary(torch.isnan, "isnan")


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return call(lambda a: torch.nan_to_num(a, nan=nan, posinf=posinf,
                                           neginf=neginf),
                x, _name="nan_to_num")


# ---------------------------------------------------------------- linalg-ish
def _bool_product(tfn, a, *rest):
    """``tfn`` of bool operands as jnp gives it: any of the products
    true, computed as a float32 count of them (exact; torch has no bool
    product)."""
    return tfn(a.to(torch.float32), *(r.to(torch.float32) for r in rest)) != 0


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    def _mm(a, b):
        a, b = _promoted(a, b)
        if transpose_x and a.dim() > 1:
            a = a.transpose(-1, -2)
        if transpose_y and b.dim() > 1:
            b = b.transpose(-1, -2)
        if a.dtype == torch.bool:
            return _bool_product(torch.matmul, a, b)
        return torch.matmul(a, b)
    return call(_mm, x, y, _name="matmul")


mm = matmul


def _matmul(a, b):
    return torch.matmul(*_promoted(a, b))


def _dot(a, b):
    # the product wraps in the operands' dtype before the sum, as jnp's
    # sum(a * b) does
    p = torch.mul(*_promoted(a, b))
    return torch.sum(p, dim=-1).to(_acc_dtype(p.dtype))


def dot(x, y, name=None):
    return call(_dot, x, y, _name="dot")


def bmm(x, y, name=None):
    return call(_matmul, x, y, _name="bmm")


def mv(x, vec, name=None):
    return call(_matmul, x, vec, _name="mv")


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return call(lambda i, a, b: beta * i + alpha * _matmul(a, b), input, x, y,
                _name="addmm")


def _inner(a, b):
    a, b = _promoted(a, b)
    if a.dtype == torch.bool:
        return _bool_product(torch.inner, a, b)
    return torch.inner(a, b)


def inner(x, y, name=None):
    return call(_inner, x, y, _name="inner")


def outer(x, y, name=None):
    return call(lambda a, b: torch.outer(*_promoted(a.reshape(-1),
                                                   b.reshape(-1))),
                x, y, _name="outer")


def kron(x, y, name=None):
    return call(lambda a, b: torch.kron(*_promoted(a, b)), x, y, _name="kron")


def _multi_dot(xs):
    xs = _promoted(*xs)
    if xs[0].dtype == torch.bool:
        return _bool_product(lambda *f: torch.linalg.multi_dot(f), *xs)
    return torch.linalg.multi_dot(xs)


def multi_dot(x, name=None):
    return call(_multi_dot, list(x), _name="multi_dot")


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return call(lambda a: torch.sum(torch.diagonal(
        a, offset, axis1, axis2), -1).to(_acc_dtype(a.dtype)), x,
        _name="trace")


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return call(lambda a: torch.diagonal(a, offset, axis1, axis2), x,
                _name="diagonal")


# ---------------------------------------------------------------- misc
def increment(x, value=1.0, name=None):
    out = call(lambda a: a + value, x, _name="increment")
    return x._rebind(out)


def all(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return call(lambda a: torch.all(a.bool(), dim=_dims(ax, a),
                                    keepdim=keepdim), x, _name="all")


def any(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return call(lambda a: torch.any(a.bool(), dim=_dims(ax, a),
                                    keepdim=keepdim), x, _name="any")


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def lerp(x, y, weight, name=None):
    if isinstance(weight, (int, float)):
        return call(lambda a, b: a + weight * (b - a), x, y, _name="lerp")
    return call(lambda a, b, w: a + w * (b - a), x, y, weight, _name="lerp")


def deg2rad(x, name=None):
    return call(_float_in(torch.deg2rad), x, _name="deg2rad")


def rad2deg(x, name=None):
    return call(_float_in(torch.rad2deg), x, _name="rad2deg")


def gcd(x, y, name=None):
    return call(lambda a, b: torch.gcd(*_promoted(a, b, scalars=True)), x, y,
                _name="gcd")


def lcm(x, y, name=None):
    return call(lambda a, b: torch.lcm(*_promoted(a, b, scalars=True)), x, y,
                _name="lcm")


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    # the edges are constants of the op, as in the reference: no gradient
    pre = _v(prepend)
    app = _v(append)
    pre = pre.detach() if isinstance(pre, torch.Tensor) else pre
    app = app.detach() if isinstance(app, torch.Tensor) else app

    def _edge(e, a):
        # a scalar or lower-rank edge broadcasts to size 1 along the axis
        if e is None:
            return None
        e = torch.as_tensor(e, dtype=a.dtype, device=a.device)
        if e.dim() < a.dim():
            shape = list(a.shape)
            shape[axis] = 1
            e = e.expand(shape)
        return e

    def _diff(a):
        return torch.diff(a, n=n, dim=axis, prepend=_edge(pre, a),
                          append=_edge(app, a))
    return call(_diff, x, _name="diff")


def angle(x, name=None):
    return call(_float_in(torch.angle), x, _name="angle")


def conj(x, name=None):
    # torch returns a real input itself; the reference's output is a new
    # tensor on the tape
    return call(lambda a: torch.conj_physical(a) if a.is_complex()
                else a.clone(), x, _name="conj")


def real(x, name=None):
    return call(lambda a: torch.real(a).clone(), x, _name="real")


def imag(x, name=None):
    return call(lambda a: torch.imag(a).clone() if a.is_complex()
                else torch.zeros_like(a), x, _name="imag")


def add_n(inputs, name=None):
    """Elementwise sum of a tensor list."""
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    if len(inputs) == 1:
        # a bool plus the weak 0 is int32 in jnp
        return call(lambda a: _narrow_index(a + 0, a), inputs[0],
                    _name="add_n")
    return call(lambda *xs: functools.reduce(torch.add, _promoted(*xs)),
                *inputs, _name="add_n")


def cast(x, dtype, name=None):
    dt = core.convert_dtype(dtype)
    return call(lambda a: convert(a, dt), x, _name="cast")


def tanh_(x, name=None):
    return x._rebind(tanh(x))


# ---------------------------------------------------------------- operators
def _swap(fn):
    def rop(self, other):
        return fn(other, self)
    return rop


def _install():
    T = Tensor
    T.__add__ = lambda s, o: add(s, o)
    T.__radd__ = lambda s, o: add(s, o)
    T.__sub__ = lambda s, o: subtract(s, o)
    T.__rsub__ = _swap(subtract)
    T.__mul__ = lambda s, o: multiply(s, o)
    T.__rmul__ = lambda s, o: multiply(s, o)
    T.__truediv__ = lambda s, o: divide(s, o)
    T.__rtruediv__ = _swap(divide)
    T.__floordiv__ = lambda s, o: floor_divide(s, o)
    T.__rfloordiv__ = _swap(floor_divide)
    T.__mod__ = lambda s, o: mod(s, o)
    T.__rmod__ = _swap(mod)
    T.__pow__ = lambda s, o: pow(s, o)
    T.__rpow__ = _swap(pow)
    T.__matmul__ = lambda s, o: matmul(s, o)
    T.__rmatmul__ = _swap(matmul)
    T.__neg__ = lambda s: neg(s)
    T.__abs__ = lambda s: abs(s)
    T.__iadd__ = lambda s, o: s._rebind(add(s, o))
    T.__isub__ = lambda s, o: s._rebind(subtract(s, o))
    T.__imul__ = lambda s, o: s._rebind(multiply(s, o))
    T.__itruediv__ = lambda s, o: s._rebind(divide(s, o))

    for nm in ("add subtract multiply divide pow matmul mm bmm mv dot inner "
               "outer kron addmm floor_divide mod remainder maximum minimum "
               "fmax fmin atan2 abs ceil floor round trunc exp expm1 log log2 "
               "log10 log1p sqrt rsqrt square sin cos tan asin acos atan sinh "
               "cosh tanh asinh acosh atanh erf reciprocal sign neg sigmoid "
               "stanh digamma lgamma sum mean prod max min amax amin "
               "logsumexp cumsum cumprod clip isfinite isinf isnan nan_to_num "
               "all any scale increment trace diagonal lerp multiplex "
               "count_nonzero deg2rad rad2deg gcd lcm diff angle conj real "
               "imag").split():
        setattr(T, nm, globals()[nm])
    T.multiply_ = lambda s, o: s._rebind(multiply(s, o))
    T.add_ = lambda s, o: s._rebind(add(s, o))
    T.subtract_ = lambda s, o: s._rebind(subtract(s, o))
    T.clip_ = lambda s, lo=None, hi=None: s._rebind(clip(s, lo, hi))
    T.scale_ = lambda s, *a, **k: s._rebind(scale(s, *a, **k))
    T.tanh_ = lambda s: s._rebind(tanh(s))
    T.exp_ = lambda s: s._rebind(exp(s))
    T.sqrt_ = lambda s: s._rebind(sqrt(s))
    T.reciprocal_ = lambda s: s._rebind(reciprocal(s))


_install()


__all__ = [_n for _n, _v in list(globals().items())
           if not _n.startswith("_")
           and getattr(_v, "__module__", None) == __name__]
