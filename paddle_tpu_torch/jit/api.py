"""The port's ``jit`` API (counterpart of ``paddle_tpu/jit/api.py``):
``to_static``, ``not_to_static``, ``save``, ``load``, ``TracedLayer``,
``InputSpec`` and the static-mode switches.

The reference's ``to_static`` stages a Layer or function through
``jax.jit``: one XLA executable per input signature, whose outputs carry
no tape.  The port's counterpart is **one CUDA graph per signature**:

* On the CPU (no input on the card) a call runs the forward eagerly
  through ``functional.functional_call``, with the tape off.
* On the card the first call of a signature runs the forward eagerly on
  a side stream (the warm-up, which also builds the kernels), then
  captures it into a CUDA graph; every later call copies its tensor
  inputs into the graph's static input buffers and replays it.  The
  capture's increments of the kernels' launch counters are taken back
  and each replay adds them again (``ops.cuda.counters``), so the counts
  read as if the forward had run eagerly.
* The signature holds the layer's ``training`` flag, the static (non
  Tensor) kwargs fingerprinted as the reference's ``_fp`` does, every
  tensor input's shape, dtype and device (a raw ``torch.Tensor`` is an
  input too), the other positional values, the ``auto_cast`` state, grad
  mode and whether the nan guard is on.  Each wrapper keeps up to 32
  graphs, least recently used dropped first (``evictions``).
* A graph reads the parameter and buffer storage it captured: an update
  in place (an optimizer step, ``set_value``, ``set_state_dict``) shows
  at the next replay, while a rebinding (``Layer.to(dtype=...)``, a new
  ``.value``) drops the graph and captures anew.  A function's closure
  tensors are read where they lie; rebinding them is not seen.
* Outputs are copies of the graph's output buffers, so a tensor a caller
  holds keeps its value after the next replay; they stop gradients, as
  the reference's do.  Buffers the forward rebinds (batch norm's running
  statistics) are written back in place, inside the graph.
* Dropout draws from the default generator's stream for the card, which
  every graph registers: each replay draws a fresh mask, and re-seeding
  (``paddle.seed``) gives the first mask again.
* A forward that reads a value on the host through the port
  (``Tensor.item`` and the other host reads, ``while_loop`` on a tensor
  predicate, ``Print``, ``py_func``, ``nonzero``, ``unique``,
  ``masked_select``) raises ``functional.GraphBreak`` during the capture:
  its signature then runs eagerly on the card from then on, counted
  under ``fallbacks``.  Any other capture failure raises, a sync that
  torch refuses included.
* The nan guard and ``debug.check_numerics`` write device flags during
  the capture; the call that replays the graph reads them and raises
  ``NanInfError``.  The guard's state is part of the signature, so
  turning it on or off captures anew.  With the profiler on, a replay is
  one host event under the layer's name.
* ``ProgramTranslator.enable(False)`` (``dispatch.cache_enabled`` reads
  it) makes every call the plain eager call, on the tape.

``ops.dispatch.cache_stats`` counts captures (``misses``), replays
(``hits``), warm-ups (``warming``) and eager calls (``fallbacks``).
"""
from __future__ import annotations

import collections
import os
import pickle
import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..framework import core
from ..ops import dispatch
from ..tensor.tensor import Tensor
from . import functional as fx

_MAX_GRAPHS = 32


class InputSpec:
    """ref: python/paddle/static/input.py::InputSpec."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(shape)
        self.dtype = core.convert_dtype(dtype)
        self.name = name

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype})"


class ProgramTranslator:
    """The ``to_static`` switch (ref ``ProgramTranslator.enable``): off,
    a ``to_static`` call is the plain eager call, on the tape."""
    _inst = None

    @classmethod
    def get_instance(cls):
        if cls._inst is None:
            cls._inst = cls()
        return cls._inst

    def __init__(self):
        self.enable_to_static = True

    def enable(self, enable_to_static=True):
        self.enable_to_static = bool(enable_to_static)


def _fp(v):
    """A hashable fingerprint of a static value; numpy arrays by their
    whole content (their summarized repr elides elements)."""
    if isinstance(v, np.ndarray):
        return ("nd", v.shape, str(v.dtype), hash(v.tobytes()))
    return repr(v)


def _amp_token():
    st = core._state.amp_state
    if st is None:
        return None
    return (st.dtype, st.level, frozenset(st.white_list),
            frozenset(st.black_list))


def _host_sync(e):
    """Did this capture fail on one of the port's host reads (a
    ``GraphBreak`` in the exception's chain)?"""
    while e is not None:
        if isinstance(e, fx.GraphBreak):
            return True
        e = e.__cause__ or e.__context__
    return False


def _leaf_key(x):
    if isinstance(x, Tensor):
        x = x.value
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, x.device)
    return _fp(x)


def _val(x):
    """A leaf's torch value (a Tensor's payload), else the leaf."""
    return x.value if isinstance(x, Tensor) else x


def _same(a, b):
    return len(a) == len(b) and all(x is y for x, y in zip(a, b))


class _Graph:
    """One captured signature: the graph, its static input buffers, its
    output buffers, the state it read, its launch counts, the kernel
    workspaces and debug flags it keeps."""
    __slots__ = ("graph", "ins", "outs", "state", "delta", "held", "flags")

    def __init__(self, graph, ins, outs, state, delta, held, flags):
        self.graph, self.ins, self.outs, self.state = graph, ins, outs, state
        self.delta, self.held, self.flags = delta, held, flags


class TracedLayer:
    """``to_static``'s wrapper around a Layer or a plain function (module
    docstring)."""

    def __init__(self, fn, layer=None, input_spec=None):
        self._fn = fn
        self._layer = layer
        self._input_spec = input_spec
        self._graphs = collections.OrderedDict()
        self._uncapturable = set()
        self._name = type(layer).__name__ if layer is not None else getattr(
            fn, "__name__", "to_static")
        dispatch._graph_caches.add(self)

    # -- the call ---------------------------------------------------------
    def __call__(self, *args, **kwargs):
        if not dispatch.cache_enabled():
            return self._fn(*args, **kwargs)
        # tensor kwargs are inputs; everything else is a constant of the
        # signature (a traced bool would break `if flag:` in the forward)
        tkw = {k: v for k, v in kwargs.items()
               if isinstance(v, (Tensor, torch.Tensor))}
        skw = {k: v for k, v in kwargs.items() if k not in tkw}
        leaves, spec = pytree.tree_flatten((args, tkw))
        dev = next((v.device for v in map(_val, leaves)
                    if isinstance(v, torch.Tensor) and v.is_cuda), None)
        if dev is None:
            return self._eager(leaves, spec, skw)
        key = (self._layer.training if self._layer is not None else True,
               tuple(sorted((k, _fp(v)) for k, v in skw.items())), spec,
               tuple(map(_leaf_key, leaves)), _amp_token(),
               core.grad_enabled(), dispatch.nan_guard)
        if key in self._uncapturable:
            dispatch._stats["fallbacks"] += 1
            return self._eager(leaves, spec, skw)
        g = self._graphs.get(key)
        if g is not None and not _same(g.state, self._state()):
            del self._graphs[key]          # the layer's state was rebound
            g = None
        if g is None:
            return self._capture(key, dev, leaves, spec, skw)
        self._graphs.move_to_end(key)
        return self._replay(g, leaves)

    def _state(self):
        """The torch values of the layer's parameters and buffers (a
        graph keeps these alive: it reads their storage)."""
        if self._layer is None:
            return ()
        params, buffers = fx.collect_state(self._layer)
        return tuple(t.value for t in params.values()) + tuple(
            t.value for t in buffers.values())

    def _eager(self, leaves, spec, skw):
        """The forward eagerly with the tape off, the reference's
        functional call."""
        return fx._to_tensors(self._forward(list(map(_val, leaves)), spec,
                                            skw))

    def _forward(self, leaves, spec, skw):
        """The forward on ``leaves`` (torch values where the call had
        Tensors), the tape off: torch outputs.  Buffers it rebinds are
        copied into their own storage, so a replay writes them too and no
        graph of the layer sees its state rebound."""
        args, tkw = pytree.tree_unflatten(
            [Tensor(x) if isinstance(x, torch.Tensor) else x
             for x in leaves], spec)
        if self._layer is None:
            with fx.trace_mode():
                return fx._to_vals(self._fn(*args, **tkw, **skw))
        pv, bv = fx.param_arrays(self._layer)
        out, new_buf = fx.functional_call(self._layer, pv, bv, args,
                                          {**tkw, **skw})
        with torch.no_grad():
            for k, v in new_buf.items():
                if v is not bv[k]:
                    bv[k].copy_(v)
        return out

    def _capture(self, key, dev, leaves, spec, skw):
        """The first call of a signature on the card: the eager warm-up on
        a side stream, whose outputs it returns, then the capture
        (``counters.capture``)."""
        from .. import debug
        from ..ops.cuda import counters
        ins = [v.detach().clone() if isinstance(v, torch.Tensor) else v
               for v in map(_val, leaves)]
        dispatch._stats["warming"] += 1
        try:
            with debug.capture_flags() as flags:
                out, graph, outs, delta, held = counters.capture(
                    lambda: self._forward(ins, spec, skw), dev,
                    torch.cuda.Stream(dev),
                    generator=core.default_generator().on(dev))
        except Exception as e:
            if not _host_sync(e) or not hasattr(e, "eager_out"):
                raise
            self._uncapturable.add(key)
            dispatch._stats["fallbacks"] += 1
            return fx._to_tensors(e.eager_out)
        self._graphs[key] = _Graph(graph, ins, outs, self._state(), delta,
                                   held, flags)
        dispatch._stats["misses"] += 1
        if len(self._graphs) > _MAX_GRAPHS:
            self._graphs.popitem(last=False)
            dispatch._stats["evictions"] += 1
        return fx._to_tensors(out)

    def _replay(self, g, leaves):
        from ..ops.cuda import counters
        t0 = time.perf_counter()
        with torch.no_grad():
            for buf, x in zip(g.ins, map(_val, leaves)):
                if isinstance(x, torch.Tensor):
                    buf.copy_(x)
            g.graph.replay()
            counters.add_launch_counts(g.delta)
            if g.flags:
                from .. import debug
                debug.raise_flags(g.flags)
            outs = pytree.tree_map(
                lambda v: v.clone() if isinstance(v, torch.Tensor) else v,
                g.outs)
        dispatch._stats["hits"] += 1
        if dispatch.profiling:
            from .. import profiler
            profiler.record_op(self._name, time.perf_counter() - t0,
                               t_start=t0)
        return fx._to_tensors(outs)

    # pass-throughs so a wrapped layer still acts like one
    def __getattr__(self, name):
        d = self.__dict__
        if "_layer" not in d:           # not initialised (unpickling)
            raise AttributeError(name)
        return getattr(d["_layer"] if d["_layer"] is not None else d["_fn"],
                       name)


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    from ..nn.layer.layers import Layer

    def decorate(fn):
        if isinstance(fn, Layer):
            return TracedLayer(fn.forward, layer=fn, input_spec=input_spec)
        return TracedLayer(fn, layer=None, input_spec=input_spec)
    if function is not None:
        return decorate(function)
    return decorate


def not_to_static(fn=None):
    if fn is None:
        return lambda f: f
    return fn


_JIT_SUFFIX = ".pdmodel"
_PARAM_SUFFIX = ".pdiparams"


def save(layer, path, input_spec=None, **configs):
    """The reference's file pair: ``path.pdiparams`` (the parameters and
    buffers by name, numpy arrays; a bfloat16 one as its raw bits with
    its dtype, as ``paddle.save`` stores it) and ``path.pdmodel`` (the
    pickled Layer and its meta)."""
    from ..tensor.tensor import host_payload
    target = layer._layer if isinstance(layer, TracedLayer) else layer
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    params, buffers = fx.collect_state(target)
    state = {}
    for k, v in {**params, **buffers}.items():
        arr, tag = host_payload(v.value)
        state[k] = arr if tag is None else {"__tensor__": arr, "name": k,
                                            "dtype": tag}
    with open(path + _PARAM_SUFFIX, "wb") as f:
        pickle.dump(state, f)
    meta = {"class": type(target).__name__,
            "input_spec": [(s.shape, core.dtype_name(s.dtype))
                           for s in (input_spec or [])],
            "param_names": list(params.keys()),
            "buffer_names": list(buffers.keys())}
    with open(path + _JIT_SUFFIX, "wb") as f:
        pickle.dump({"meta": meta, "layer": target}, f)


def load(path, **configs):
    """The Layer ``save`` wrote, its state from ``path.pdiparams``, as a
    :class:`TracedLayer` on the default place."""
    from ..io.serialization import _from_storable
    with open(path + _JIT_SUFFIX, "rb") as f:
        blob = pickle.load(f)
    layer = blob["layer"]
    with open(path + _PARAM_SUFFIX, "rb") as f:
        state = pickle.load(f)
    layer.set_state_dict({k: _from_storable(v) for k, v in state.items()})
    traced = TracedLayer(layer.forward, layer=layer)
    traced._meta = blob.get("meta", {})
    return traced


def enable_static():
    """Ops record into the default main program from now on
    (``static.graph``)."""
    from ..static.graph import _set_static_mode
    _set_static_mode(True)


def disable_static():
    from ..static.graph import _set_static_mode
    _set_static_mode(False)


def in_static_mode():
    from ..static.graph import in_static_mode as _in
    return _in()
