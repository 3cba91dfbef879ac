"""The Tensor: a paddle-API wrapper over ``torch.Tensor``.

Counterpart of ``paddle_tpu/tensor/tensor.py``, whose payload is a
``jax.Array``.  Here the payload ``value`` is a ``torch.Tensor`` on an
explicit device; ``stop_gradient`` says whether ops on it record, as in
the reference.  A :class:`Parameter` that trains keeps ``requires_grad``
on its value, so ops that record (grad mode on) build torch's graph: that
graph is the eager tape, and ``backward`` runs torch autograd over it
(``autograd/tape.py``).  ``grad`` is the leaf value's ``.grad``: the same
tensors get one as in the reference (leaves that do not stop gradients),
and grads accumulate over backward calls until ``clear_grad``.  A hook
(``register_hook``) sees the complete grad of one backward once, and a
return that is not ``None`` replaces it, on leaves and intermediates, as
the reference's ``_finalize_grad`` and ``out_hooks`` do.
"""
from __future__ import annotations

import operator

import numpy as np
import torch

from ..framework import core
from ..ops import dispatch


def _owned(arr):
    """``arr`` as a C-contiguous, writable array (copied only if it is not;
    a JAX array's numpy view is read-only)."""
    return np.require(arr, requirements=("C", "W"))


def _to_torch_value(data, dtype=None, place=None):
    """``data`` (Tensor, torch tensor, numpy array, Python scalar or
    nested list) -> a torch tensor on ``place`` (default: the default
    place; a torch tensor stays where it is), in ``dtype`` or, for data
    that is not a torch tensor, in the reference's dtype for it."""
    if isinstance(data, Tensor):
        val = data.value
    elif isinstance(data, torch.Tensor):
        val = data
    else:
        arr = np.asarray(data)
        if dtype is None and arr.dtype == np.float64:
            dtype = core.get_default_dtype()
        val = core.narrow(torch.from_numpy(_owned(arr)))
        if place is None:
            place = core.get_place()
    dtype = core.convert_dtype(dtype)
    dev = None if place is None else place.device
    if (dtype is not None and val.dtype != dtype) or (
            dev is not None and val.device != dev):
        val = val.to(device=dev, dtype=dtype)
    return val


class _HookHandle:
    def __init__(self, hooks, fn):
        self._hooks, self._fn = hooks, fn

    def remove(self):
        try:
            self._hooks.remove(self._fn)
        except ValueError:
            pass


class Tensor:
    __slots__ = ("value", "stop_gradient", "name", "persistable",
                 "_grad_hooks", "_backward_ran", "_var_id", "__weakref__")

    _next_id = [0]

    def __init__(self, data=None, dtype=None, place=None, stop_gradient=True,
                 name=None):
        if data is None:
            data = np.zeros((), np.float32)
        self.value = _to_torch_value(data, dtype, place)
        self.stop_gradient = bool(stop_gradient)
        if name is None:
            Tensor._next_id[0] += 1
            name = f"tensor_{Tensor._next_id[0]}"
        self.name = name
        self.persistable = False
        self._grad_hooks = None
        self._backward_ran = 0       # tape._NOT_RUN
        self._var_id = None          # a static program's variable id

    # -- metadata ----------------------------------------------------------
    @property
    def shape(self):
        return list(self.value.shape)

    @property
    def dtype(self):
        return self.value.dtype

    @property
    def ndim(self):
        return self.value.dim()

    @property
    def size(self):
        return self.value.numel()

    @property
    def place(self):
        return core.place_of(self.value.device)

    @property
    def is_leaf(self):
        return self.value.grad_fn is None

    # -- grad --------------------------------------------------------------
    @property
    def grad(self):
        """The accumulated grad of a leaf (a Tensor that stops gradients),
        else ``None``."""
        g = self.value.grad if self.value.grad_fn is None else None
        return None if g is None else Tensor(g, stop_gradient=True)

    @grad.setter
    def grad(self, g):
        self.value.grad = (None if g is None else _to_torch_value(
            g, self.value.dtype, core.place_of(self.value.device)))

    def backward(self, grad_tensor=None, retain_graph=False):
        from ..autograd import tape
        tape.backward(self, grad_tensor, retain_graph=retain_graph)

    def clear_grad(self):
        self.value.grad = None

    clear_gradient = clear_grad

    def gradient(self):
        g = self.grad
        return None if g is None else g.numpy()

    def register_hook(self, hook):
        """Run ``hook(grad)`` on this tensor's complete grad in each
        backward; a return that is not ``None`` replaces the grad (and, on
        an intermediate, what flows upstream).  Returns a handle with
        ``remove()``."""
        if self._grad_hooks is None:
            from ..autograd import tape
            hooks = self._grad_hooks = []
            if self.value.requires_grad:
                self.value.register_hook(
                    lambda g: tape.apply_grad_hooks(hooks, g))
        self._grad_hooks.append(hook)
        return _HookHandle(self._grad_hooks, hook)

    # -- conversion --------------------------------------------------------
    def numpy(self):
        """A snapshot of the value as a numpy array: a copy, never a view
        of the payload, which optimizers and ``set_value`` update in
        place (the reference's values are immutable)."""
        if self.value.dtype == torch.bfloat16:
            raise TypeError("Tensor.numpy: numpy has no bfloat16; call "
                            "astype('float32') first")
        v = self.value.detach()
        return v.cpu().numpy() if v.device.type != "cpu" else v.numpy().copy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def __float__(self):
        return float(self.value.item())

    def item(self, *args):
        return self.numpy().item(*args)

    def tolist(self):
        return self.numpy().tolist()

    def astype(self, dtype):
        dt = core.convert_dtype(dtype)
        return dispatch.call(lambda x: x.to(dt), self, _name="astype")

    cast = astype

    def detach(self):
        return Tensor(self.value.detach(), stop_gradient=True)

    # -- mutation ----------------------------------------------------------
    def set_value(self, value):
        """Copy ``value`` into this tensor's payload, in place, in its
        dtype and on its device.  Raises ``ValueError`` on another
        shape."""
        if isinstance(value, Tensor):
            new = value.value
        elif isinstance(value, torch.Tensor):
            new = value
        else:
            new = torch.from_numpy(_owned(np.asarray(value)))
        if tuple(new.shape) != tuple(self.value.shape):
            raise ValueError(f"set_value: shape {list(new.shape)} into a "
                             f"tensor of shape {self.shape}")
        with torch.no_grad():
            self.value.copy_(new)
        return self

    # -- indexing ----------------------------------------------------------
    def __getitem__(self, item):
        idx = dispatch.unwrap(item)
        return dispatch.call(lambda x: x[idx], self, _name="getitem")

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of a 0-d tensor")
        return self.value.shape[0]

    def __repr__(self):
        prefix = "Parameter" if isinstance(self, Parameter) else "Tensor"
        data = np.array2string(self.value.detach().float().cpu().numpy(),
                               separator=", ", prefix="       ")
        return (f"{prefix}(shape={self.shape}, dtype="
                f"{core.dtype_name(self.dtype)}, place={self.place}, "
                f"stop_gradient={self.stop_gradient},\n       {data})")

    __str__ = __repr__

    # -- operators ---------------------------------------------------------
    def __add__(self, other):
        return dispatch.call(operator.add, self, other, _name="add")

    def __radd__(self, other):
        return dispatch.call(operator.add, other, self, _name="add")

    def __sub__(self, other):
        return dispatch.call(operator.sub, self, other, _name="subtract")

    def __mul__(self, other):
        return dispatch.call(operator.mul, self, other, _name="multiply")

    def __rmul__(self, other):
        return dispatch.call(operator.mul, other, self, _name="multiply")

    def __truediv__(self, other):
        return dispatch.call(operator.truediv, self, other, _name="divide")

    def __pow__(self, other):
        return dispatch.call(operator.pow, self, other, _name="pow")

    def __matmul__(self, other):
        return dispatch.call(operator.matmul, self, other, _name="matmul")

    def sum(self, axis=None, dtype=None, keepdim=False, name=None):
        from .math import sum as _sum
        return _sum(self, axis, dtype, keepdim)

    def mean(self, axis=None, keepdim=False, name=None):
        from .math import mean as _mean
        return _mean(self, axis, keepdim)


class Parameter(Tensor):
    """Trainable tensor (ref: ``paddle_tpu/tensor/tensor.py::Parameter``)."""

    __slots__ = ("trainable", "optimize_attr", "regularizer", "need_clip")

    def __init__(self, data=None, dtype=None, name=None, trainable=True):
        super().__init__(data, dtype=dtype, stop_gradient=not trainable,
                         name=name)
        self.trainable = trainable
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.need_clip = True
        self.persistable = True
        self._mark()

    def _mark(self):
        """Make the value a leaf that requires grad iff the parameter
        trains (floating point only)."""
        self.value = self.value.detach()
        if self.value.is_floating_point():
            self.value.requires_grad_(not self.stop_gradient)
