"""Comparison and logic ops (counterpart of ``paddle_tpu/tensor/logic.py``),
with the reference's promotion (``math._promoted``) and bool outputs.  The
comparison operators and ``&``, ``|``, ``^``, ``~`` of the Tensor are
bound here, as the reference binds them: ``==`` gives a bool Tensor (a Tensor hashes by identity,
``tensor.py``)."""
from __future__ import annotations

import torch

from ..ops.dispatch import call
from .math import _promoted
from .tensor import Tensor


def _cmp(tfn, opname):
    def op(x, y, name=None):
        return call(lambda a, b: tfn(*_promoted(a, b, scalars=True)), x, y,
                    _name=opname)
    op.__name__ = opname
    return op


equal = _cmp(torch.eq, "equal")
not_equal = _cmp(torch.ne, "not_equal")
greater_than = _cmp(torch.gt, "greater_than")
greater_equal = _cmp(torch.ge, "greater_equal")
less_than = _cmp(torch.lt, "less_than")
less_equal = _cmp(torch.le, "less_equal")
logical_and = _cmp(torch.logical_and, "logical_and")
logical_or = _cmp(torch.logical_or, "logical_or")
logical_xor = _cmp(torch.logical_xor, "logical_xor")
bitwise_and = _cmp(torch.bitwise_and, "bitwise_and")
bitwise_or = _cmp(torch.bitwise_or, "bitwise_or")
bitwise_xor = _cmp(torch.bitwise_xor, "bitwise_xor")


def logical_not(x, name=None):
    return call(torch.logical_not, x, _name="logical_not")


def bitwise_not(x, name=None):
    return call(torch.bitwise_not, x, _name="bitwise_not")


def equal_all(x, y, name=None):
    """A 0-d bool: same shape and every element equal."""
    def _eq(a, b):
        if a.shape != b.shape:
            return torch.zeros((), dtype=torch.bool, device=a.device)
        return torch.all(torch.eq(*_promoted(a, b)))
    return call(_eq, x, y, _name="equal_all")


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return call(lambda a, b: torch.all(torch.isclose(
        *_promoted(a, b, scalars=True), rtol=rtol, atol=atol,
        equal_nan=equal_nan)), x, y, _name="allclose")


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return call(lambda a, b: torch.isclose(
        *_promoted(a, b, scalars=True), rtol=rtol, atol=atol,
        equal_nan=equal_nan), x, y, _name="isclose")


def is_empty(x, name=None):
    return Tensor(torch.full((), x.size == 0, dtype=torch.bool,
                             device=x.value.device))


def is_tensor(x):
    return isinstance(x, Tensor)


def _bool(s):
    return s.dtype == torch.bool


def _install():
    T = Tensor
    T.__eq__ = lambda s, o: equal(s, o)
    T.__ne__ = lambda s, o: not_equal(s, o)
    T.__lt__ = lambda s, o: less_than(s, o)
    T.__le__ = lambda s, o: less_equal(s, o)
    T.__gt__ = lambda s, o: greater_than(s, o)
    T.__ge__ = lambda s, o: greater_equal(s, o)
    T.__invert__ = lambda s: logical_not(s) if _bool(s) else bitwise_not(s)
    T.__and__ = lambda s, o: (logical_and(s, o) if _bool(s)
                              else bitwise_and(s, o))
    T.__or__ = lambda s, o: logical_or(s, o) if _bool(s) else bitwise_or(s, o)
    T.__xor__ = lambda s, o: (logical_xor(s, o) if _bool(s)
                              else bitwise_xor(s, o))
    for nm in ("equal not_equal greater_than greater_equal less_than "
               "less_equal logical_and logical_or logical_xor logical_not "
               "bitwise_and bitwise_or bitwise_xor bitwise_not equal_all "
               "allclose isclose").split():
        setattr(T, nm, globals()[nm])


_install()


__all__ = [_n for _n, _v in list(globals().items())
           if not _n.startswith("_")
           and getattr(_v, "__module__", None) == __name__]
