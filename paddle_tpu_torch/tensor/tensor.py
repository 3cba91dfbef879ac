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

The in-place APIs (``x.add_(y)``, ``x[i] = v``, ``increment`` ...) run
out of place and rebind the tensor to the result (:meth:`_rebind`), as
the reference's do: the tensor then carries the result's graph, and a
leaf rebound that way still reports the grad of the value it held
before (the reference's tape keeps the tensor, not the value, as the
leaf).  ``paddle.grad`` with respect to a rebound tensor sums the grads
of every value it has held (``_past``), as the reference's tape, whose
edges all lead to the one tensor, does.  The operators and most methods are bound by the op modules'
``_install`` (``tensor/math.py``, ``logic.py`` ...), as the reference
binds them.
"""
from __future__ import annotations

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


def convert(a, dt):
    """``a`` in dtype ``dt`` as jnp's ``astype`` converts: a float to an
    integer truncates toward zero, saturates at the integer's range and
    maps NaN to 0 (torch's ``.to`` wraps on the CPU and is undefined on
    the card, so the value is clamped first, in a float wide enough to
    hold the bounds exactly); every other conversion is torch's."""
    if (a.is_floating_point() and not dt.is_floating_point
            and not dt.is_complex and dt != torch.bool):
        info = torch.iinfo(dt)
        wide = torch.float64 if info.bits > 16 else torch.float32
        a = a.to(wide).nan_to_num(0.0).clamp(info.min, info.max)
    return a.to(dt)


def host_payload(value):
    """A torch value as ``(numpy array, dtype tag)`` for pickling:
    bfloat16, which numpy lacks, as its raw bits in a uint16 array with
    the tag ``"bfloat16"``; anything else as its numpy copy and ``None``."""
    v = value.detach().cpu()
    if v.dtype == torch.bfloat16:
        return v.view(torch.int16).numpy().view(np.uint16).copy(), "bfloat16"
    return v.numpy().copy(), None


def from_payload(arr, tag):
    """The inverse of :func:`host_payload`: a CPU torch tensor."""
    if tag == "bfloat16":
        return torch.from_numpy(_owned(np.asarray(arr, np.uint16)).view(
            np.int16)).view(torch.bfloat16)
    return torch.from_numpy(_owned(np.asarray(arr)))


class _HookHandle:
    def __init__(self, hooks, fn):
        self._hooks, self._fn = hooks, fn

    def remove(self):
        try:
            self._hooks.remove(self._fn)
        except ValueError:
            pass


def _readable(v, what):
    """``v``, about to be read on the host by ``what``: inside a CUDA
    graph capture on the card the read raises
    ``jit.functional.GraphBreak`` (``jit.to_static`` then runs eagerly)."""
    if v.is_cuda and torch.cuda.is_current_stream_capturing():
        from ..jit.functional import GraphBreak
        raise GraphBreak(f"{what} reads a value on the host")
    return v


class Tensor:
    __slots__ = ("value", "stop_gradient", "name", "persistable",
                 "_grad_hooks", "_backward_ran", "_var_id", "_leaf",
                 "_past", "__weakref__")

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
        self._leaf = None            # the leaf value a rebind replaced
        self._past = ()              # graph edges of the values replaced

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

    ndimension = ndim
    rank = ndim

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
    def _leaf_value(self):
        """The torch leaf whose ``.grad`` is this tensor's grad: the value,
        or the leaf a rebind replaced; ``None`` for an intermediate."""
        if self.value.grad_fn is None:
            return self.value
        return self._leaf

    @property
    def grad(self):
        """The accumulated grad of a leaf (a Tensor that stops gradients),
        else ``None``."""
        leaf = self._leaf_value()
        g = None if leaf is None else leaf.grad
        return None if g is None else Tensor(g, stop_gradient=True)

    @grad.setter
    def grad(self, g):
        leaf = self._leaf_value()
        if leaf is None:
            return
        leaf.grad = (None if g is None else _to_torch_value(
            g, leaf.dtype, core.place_of(leaf.device)))

    def backward(self, grad_tensor=None, retain_graph=False):
        from ..autograd import tape
        tape.backward(self, grad_tensor, retain_graph=retain_graph)

    def clear_grad(self):
        leaf = self._leaf_value()
        if leaf is not None:
            leaf.grad = None

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
        place (the reference's values are immutable).  numpy has no
        bfloat16 without ``ml_dtypes``, which the port does not import:
        a bfloat16 value raises (the reference returns an ``ml_dtypes``
        array); ``item``, ``tolist``, pickling and ``paddle.save`` read it
        through torch."""
        if self.value.dtype == torch.bfloat16:
            raise TypeError("Tensor.numpy: numpy has no bfloat16; call "
                            "astype('float32') first")
        v = _readable(self.value.detach(), "Tensor.numpy")
        return v.cpu().numpy() if v.device.type != "cpu" else v.numpy().copy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def __float__(self):
        return float(_readable(self.value, "float(Tensor)").item())

    def __bool__(self):
        return bool(_readable(self.value, "bool(Tensor)").item())

    def __int__(self):
        return int(_readable(self.value, "int(Tensor)").item())

    def __index__(self):
        return int(_readable(self.value, "Tensor.__index__").item())

    def __hash__(self):
        return id(self)

    def __reduce__(self):
        # picklable through a numpy payload (bfloat16 as its bits); the
        # graph is not kept
        arr, tag = host_payload(self.value)
        return (_rebuild_tensor, (type(self), arr, self.stop_gradient,
                                  self.name, tag))

    def _host(self):
        """The value on the host as a numpy array, a bfloat16 one as its
        exact float32 copy."""
        v = _readable(self.value.detach(), "Tensor.item")
        return (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()

    def item(self, *args):
        return self._host().item(*args)

    def tolist(self):
        return self._host().tolist()

    def astype(self, dtype):
        dt = core.convert_dtype(dtype)
        return dispatch.call(lambda x: convert(x, dt), self, _name="astype")

    cast = astype

    def detach(self):
        return Tensor(self.value.detach(), stop_gradient=True)

    def detach_(self):
        self.value = self.value.detach()
        self._leaf = None
        self._past = ()
        self.stop_gradient = True
        return self

    def clone(self):
        """A copy on the tape (the gradient flows back to this tensor)."""
        return dispatch.call(torch.clone, self, _name="clone")

    def cpu(self):
        return self._moved(torch.device("cpu"))

    def cuda(self, device_id=None, blocking=True):
        return self._moved(core.CUDAPlace(device_id or 0).device)

    def pin_memory(self):
        """The value in page-locked host memory (on a machine with a
        card; a copy of a CPU tensor), else this tensor."""
        if self.value.device.type != "cpu" or not torch.cuda.is_available():
            return self
        return Tensor(self.value.detach().pin_memory(),
                      stop_gradient=self.stop_gradient)

    def _moved(self, device):
        """This tensor on ``device`` (itself when it is there already);
        the copy is on the tape."""
        if self.value.device == device:
            return self
        return dispatch.call(lambda x: x.to(device), self, _name="memcpy")

    def to(self, *args, **kwargs):
        """``to(device)``, ``to(dtype)`` or both, as names, places or
        torch objects (``blocking`` and ``copy`` are accepted)."""
        out = self
        kwargs.pop("blocking", None)
        kwargs.pop("copy", None)
        for a in list(args) + list(kwargs.values()):
            if a is None:
                continue
            if isinstance(a, core.Place):
                out = out._moved(a.device)
            elif isinstance(a, torch.device):
                out = out._moved(core.place_of(a).device)
            elif isinstance(a, str) and (a.split(":")[0].lower() in
                                         ("cpu", "gpu", "cuda")):
                out = out._moved(core._parse_device(a).device)
            else:
                out = out.astype(a)
        return out

    @property
    def T(self):
        return dispatch.call(lambda x: x.permute(*range(x.dim() - 1, -1, -1)),
                             self, _name="T")

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

    def copy_(self, other, *args):
        """Copy ``other`` into this tensor in place, broadcast to its
        shape, in its dtype (the reference's ``copy_``)."""
        new = other.value if isinstance(other, Tensor) else torch.as_tensor(
            np.asarray(other))
        with torch.no_grad():
            self.value.copy_(new.to(self.value.device).expand(
                self.value.shape))
        return self

    def fill_(self, v):
        with torch.no_grad():
            self.value.fill_(v)
        return self

    def zero_(self):
        with torch.no_grad():
            self.value.zero_()
        return self

    def get_tensor(self):
        """The reference's ``LoDTensor`` handle: ``np.array()`` reads it,
        ``.set(array, place)`` writes it back."""
        owner = self

        class _LoDTensorView:
            def __array__(self, dtype=None, copy=None):
                a = owner.numpy()
                return a.astype(dtype) if dtype is not None else a

            def set(self, array, place=None):
                owner.set_value(array)

            def shape(self):
                return list(owner.shape)

            def _dtype(self):
                return owner.dtype

        return _LoDTensorView()

    def _rebind(self, other):
        """Adopt ``other``'s value and graph (the in-place APIs, run out of
        place).  A leaf keeps its old value as the leaf its grad is read
        from, and the graph edge of every value replaced is kept for
        ``paddle.grad``; a static program's variable follows the
        rebind."""
        if self.value.requires_grad:
            if self._leaf is None and self.value.grad_fn is None:
                self._leaf = self.value
            self._past += (torch.autograd.graph.get_gradient_edge(
                self.value),)
        self.value = other.value
        self.stop_gradient = other.stop_gradient
        if other._var_id is not None:
            self._var_id = other._var_id
        return self

    # -- indexing ----------------------------------------------------------
    def __getitem__(self, item):
        idx = _index(item)
        return dispatch.call(lambda x: x[_long_index(idx)], self,
                             _name="getitem")

    def __setitem__(self, item, val):
        """``x[item] = val``: the value is rebound to a copy with the
        entries replaced (``val`` cast to x's dtype); the gradient flows
        to x's other entries and to ``val``, as the reference's
        ``x.at[item].set``."""
        idx = _index(item)
        if isinstance(val, (np.ndarray, np.generic, list, tuple)):
            val = torch.from_numpy(_owned(np.asarray(val)))

        def _set(x, v):
            out = x.clone()
            out[_long_index(idx)] = (v.to(x.device, x.dtype) if isinstance(
                v, torch.Tensor) else v)
            return out
        self._rebind(dispatch.call(_set, self, val, _name="setitem"))

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

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

    # the operators and the op methods: bound by the op modules' _install


def _index(item):
    """An index with Tensors as their torch values and lists as index
    tensors (the reference's ``_index``)."""
    if isinstance(item, Tensor):
        return item.value
    if isinstance(item, tuple):
        return tuple(_index(i) for i in item)
    if isinstance(item, list):
        return torch.as_tensor(np.asarray(item))
    return item


def _long_index(idx):
    """``idx`` with integer index tensors as int64 (torch indexes with
    int64 or bool tensors; the port's are int32)."""
    if isinstance(idx, torch.Tensor):
        return idx.long() if not (idx.dtype == torch.bool
                                  or idx.dtype == torch.uint8) else idx
    if isinstance(idx, tuple):
        return tuple(_long_index(i) for i in idx)
    return idx


def _rebuild_tensor(cls, arr, stop_gradient, name, tag=None):
    if tag is not None:
        arr = from_payload(arr, tag).to(core.get_place().device)
    if cls is Parameter:
        t = Parameter(arr, name=name, trainable=not stop_gradient)
    else:
        t = Tensor(arr, name=name)
    t.stop_gradient = stop_gradient
    return t


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
