"""Standalone inference export: a ``torch.export`` program with named IO
(counterpart of ``paddle_tpu/inference/export.py``).

The reference exports StableHLO with its Pallas kernels inside and the
parameters baked in.  The port's artifact is ``torch.export`` of the eval
forward under ``no_grad``, parameters and buffers baked in:

  <prefix>.pt2      ``torch.export.save`` of the ExportedProgram
  <prefix>.pdmeta   the reference's JSON manifest (``format``,
                    ``platforms``, ``dynamic_batch``, ``inputs``,
                    ``outputs``, each with ``name``, ``shape`` (-1 where
                    dynamic) and ``dtype``); ``format`` is "torch.export"

The kernels on the path are ``torch.library`` ops (``paddle_tpu::
layer_norm``, ``rms_norm``, ``flash_fwd``: ``ops/cuda/norms.py``,
``flash_attn.py``), so the program holds one node each where the
reference's holds a ``pallas_call``, and one artifact serves the CPU (the
ops' plain versions) and the card (the kernels), as the reference's
``platforms=("cpu", "tpu")`` artifact does.  Loading needs ``import
paddle_tpu_torch`` for the op registrations, and no Python class of the
model.

:class:`StandaloneModel` keeps the reference's per-signature cache,
bounded at 32, and its pad-to-power-of-two batch buckets with the
row-independence probe.  On the card each signature is one CUDA graph,
captured through ``ops/cuda/counters.capture`` (inputs copied into static
buffers, outputs copied out); ``serving.standalone_compiles`` counts the
captures, and ``profiler.serving_stats()`` reports it.  On the CPU a
signature is the exported module called eagerly, counted at its first
call.
"""
from __future__ import annotations

import collections
import json
import os

import torch
from torch.utils import _pytree as pytree

from ..device import DEFAULT_DEVICE, resolve_device
from ..framework import core
from ..jit import functional as fx
from ..tensor.tensor import Tensor

META_SUFFIX = ".pdmeta"
PT2_SUFFIX = ".pt2"
_MAX_SIGNATURES = 32

# the ``serving`` family's export counter (``profiler.serving_stats``)
_stats = {"standalone_compiles": 0}


def serving_stats():
    return dict(_stats)


class _Forward(torch.nn.Module):
    """A Layer or a function of Tensors as a ``torch.nn.Module`` over torch
    values: a Layer's parameters and buffers are this module's buffers
    (baked into the export), its forward runs through
    ``jit.functional.functional_call``; outputs flattened to a tuple."""

    def __init__(self, layer=None, fn=None):
        super().__init__()
        self._target = [layer if layer is not None else fn]
        self._names = ([], [])
        if layer is not None:
            pv, bv = fx.param_arrays(layer)
            for kind, vals, names in (("p", pv, self._names[0]),
                                      ("b", bv, self._names[1])):
                for i, (k, v) in enumerate(vals.items()):
                    self.register_buffer(f"{kind}{i}", v.detach())
                    names.append(k)
        self._layer = layer is not None

    def forward(self, *xs):
        if self._layer:
            pv = {k: getattr(self, f"p{i}")
                  for i, k in enumerate(self._names[0])}
            bv = {k: getattr(self, f"b{i}")
                  for i, k in enumerate(self._names[1])}
            out, _ = fx.functional_call(self._target[0], pv, bv, xs)
        else:
            with fx.trace_mode():
                out = fx._to_vals(self._target[0](*[Tensor(x) for x in xs]))
        return tuple(pytree.tree_leaves(out))


def _spec_of(s):
    if isinstance(s, (tuple, list)):
        return list(s[0]), s[1]
    return list(s.shape), s.dtype


def _dyn(d):
    return d is None or (isinstance(d, int) and d < 0)


def _dtype_name(dt):
    return core.dtype_name(core.convert_dtype(dt))


def _example(input_spec, symbolic, device):
    """Example inputs (zeros; a dynamic dim 2 when symbolic, else 1) and
    the ``dynamic_shapes`` that mark every dynamic dim as one shared
    ``Dim("b")``."""
    b = torch.export.Dim("b")
    args, dims = [], []
    for s in input_spec:
        shape, dtype = _spec_of(s)
        args.append(torch.zeros(
            [(2 if symbolic else 1) if _dyn(d) else int(d) for d in shape],
            dtype=core.convert_dtype(dtype), device=device))
        dims.append({ax: b for ax, d in enumerate(shape) if _dyn(d)}
                    if symbolic else None)
    return tuple(args), (tuple(dims),)


def _device_of(layer):
    for _, p in (fx.collect_state(layer)[0].items() if layer is not None
                 else ()):
        return p.value.device
    return core.get_place().device


def save_inference_model(path_prefix, layer_or_fn, input_spec,
                         input_names=None, output_names=None,
                         platforms=("cpu", "cuda")):
    """Export ``layer_or_fn`` to ``<path_prefix>.pt2`` and its manifest.

    ``input_spec``: InputSpecs or (shape, dtype) pairs.  None or -1 dims
    become one shared symbolic dim "b" (the dynamic batch); where the
    model cannot keep it symbolic, the export specialises it at 1 and
    records ``dynamic_batch: false``.  The trace runs on the layer's
    device (a function's: the default place), in ``eval()`` under
    ``no_grad``.  Returns the manifest."""
    from ..jit.api import TracedLayer
    from ..nn.layer.layers import Layer
    if isinstance(layer_or_fn, TracedLayer):
        layer_or_fn = layer_or_fn._layer or layer_or_fn._fn
    layer = layer_or_fn if isinstance(layer_or_fn, Layer) else None
    mod = _Forward(layer=layer, fn=None if layer is not None
                   else layer_or_fn)
    device = _device_of(layer)
    symbolic = any(_dyn(d) for s in input_spec for d in _spec_of(s)[0])
    was_training = layer.training if layer is not None else False
    if layer is not None:
        layer.eval()
    try:
        with torch.no_grad():
            try:
                args, dims = _example(input_spec, symbolic, device)
                ep = torch.export.export(mod, args, dynamic_shapes=dims,
                                         strict=False)
            except Exception:                         # noqa: BLE001
                if not symbolic:
                    raise
                # the model specialises the batch: export it at 1
                symbolic = False
                args, dims = _example(input_spec, False, device)
                ep = torch.export.export(mod, args, strict=False)
    finally:
        if was_training:
            layer.train()
    os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
    torch.export.save(ep, path_prefix + PT2_SUFFIX)

    def dims_of(shape):
        return [int(d) if isinstance(d, int) else -1 for d in shape]

    out_vals = [n.meta["val"] for n in ep.graph.output_node().args[0]]
    in_names = list(input_names or [f"x{i}" for i in range(len(args))])
    out_names = list(output_names or
                     [f"out{i}" for i in range(len(out_vals))])
    meta = {
        "format": "torch.export",
        "platforms": list(platforms),
        "dynamic_batch": symbolic,
        "inputs": [{"name": n, "shape": dims_of(
            [-1 if _dyn(d) and symbolic else (1 if _dyn(d) else d)
             for d in _spec_of(s)[0]]),
            "dtype": _dtype_name(_spec_of(s)[1])}
            for n, s in zip(in_names, input_spec)],
        "outputs": [{"name": n, "shape": dims_of(v.shape),
                     "dtype": _dtype_name(v.dtype)}
                    for n, v in zip(out_names, out_vals)],
    }
    with open(path_prefix + META_SUFFIX, "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def _next_bucket(n):
    """The next power of two at or above ``n`` (1 for 0)."""
    b = 1
    while b < n:
        b *= 2
    return b


def _pad_rows(a, axis, bucket, mode):
    """``a`` padded along ``axis`` to ``bucket``: zeros ("constant") or
    copies of its last row ("edge")."""
    n = bucket - a.shape[axis]
    if mode == "constant":
        shape = list(a.shape)
        shape[axis] = n
        pad = a.new_zeros(shape)
    else:
        pad = a.narrow(axis, a.shape[axis] - 1, 1).expand(
            *[n if i == axis else -1 for i in range(a.dim())])
    return torch.cat((a, pad), axis)


class StandaloneModel:
    """A loaded artifact: ``model(*arrays) -> tuple of torch tensors`` on
    its device (default: the card; ``device="cpu"`` for the plain path).

    Calls are cached per input signature (shape and dtype), at most 32,
    least recently used dropped first.  A dynamic-batch artifact pads the
    batch up to a power of two and slices the outputs back, so nearby
    batch sizes share one signature.  Bucketing assumes rows are
    independent; the first conclusive padded call (zero pads and
    edge-replicated pads differ) runs the bucket's signature under both
    and compares, and a mismatch disables bucketing for good and answers
    at the exact shape.  An inconclusive call is answered at its exact
    shape and leaves the probe pending.  Outputs that drop the batch dim
    skip bucketing, and ``batch_bucketing=False`` opts out."""

    def __init__(self, path_prefix, device=DEFAULT_DEVICE,
                 batch_bucketing=True):
        with open(path_prefix + META_SUFFIX) as f:
            self.meta = json.load(f)
        self._device = resolve_device(device)
        ep = torch.export.load(path_prefix + PT2_SUFFIX)
        from torch.export.passes import move_to_device_pass
        ep = move_to_device_pass(ep, str(self._device))
        self._module = ep.module()
        self._in_dyn = [[ax for ax, d in enumerate(i["shape"]) if d == -1]
                        for i in self.meta["inputs"]]
        self._out_dyn = [[ax for ax, d in enumerate(o["shape"]) if d == -1]
                         for o in self.meta["outputs"]]
        self._bucketing = bool(batch_bucketing
                               and self.meta.get("dynamic_batch")
                               and self._out_dyn and all(self._out_dyn))
        self._bucket_probed = False
        # signature -> (graph, static inputs, outputs, launch counts, the
        # workspaces it keeps); None on the CPU
        self._calls = collections.OrderedDict()
        self._pool = None

    def input_names(self):
        return [i["name"] for i in self.meta["inputs"]]

    def output_names(self):
        return [o["name"] for o in self.meta["outputs"]]

    def _run(self, arrays):
        with torch.no_grad():
            return tuple(self._module(*arrays))

    def _call_exact(self, arrays):
        """Run at the true input shapes: the signature's graph on the card
        (captured at its first call), the module eagerly on the CPU."""
        sig = tuple((tuple(a.shape), a.dtype) for a in arrays)
        if sig in self._calls:
            self._calls.move_to_end(sig)
            return self._replay(self._calls[sig], arrays)
        _stats["standalone_compiles"] += 1
        if self._device.type == "cpu":
            self._calls[sig] = None
            out = self._run(arrays)
        else:
            out, self._calls[sig] = self._capture(arrays)
        if len(self._calls) > _MAX_SIGNATURES:
            self._calls.popitem(last=False)
        return out

    def _capture(self, arrays):
        from ..ops.cuda import counters
        ins = [a.clone() for a in arrays]
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        out, graph, outs, delta, held = counters.capture(
            lambda: self._run(ins), self._device,
            torch.cuda.Stream(self._device), pool=self._pool)
        return out, (graph, ins, outs, delta, held)

    def _replay(self, g, arrays):
        if g is None:                       # the CPU: no graph
            return self._run(arrays)
        from ..ops.cuda import counters
        graph, ins, outs, delta, _ = g
        with torch.no_grad():
            for buf, a in zip(ins, arrays):
                buf.copy_(a)
            graph.replay()
            counters.add_launch_counts(delta)
            return tuple(o.clone() for o in outs)

    def _as_input(self, a, spec):
        if isinstance(a, Tensor):
            a = a.value
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(a)
        return a.to(self._device, core.convert_dtype(spec["dtype"]))

    def __call__(self, *arrays):
        arrays = [self._as_input(a, s)
                  for a, s in zip(arrays, self.meta["inputs"])]
        real_b = None
        if self._bucketing:
            for a, axes in zip(arrays, self._in_dyn):
                if axes:
                    real_b = a.shape[axes[0]]
                    break
        if not real_b or _next_bucket(real_b) == real_b:
            return self._call_exact(arrays)
        bucket = _next_bucket(real_b)

        def pad_to_bucket(mode):
            out = []
            for a, axes in zip(arrays, self._in_dyn):
                for ax in axes:
                    a = _pad_rows(a, ax, bucket, mode)
                out.append(a)
            return out

        def slice_back(outs):
            sliced = []
            for o, axes in zip(outs, self._out_dyn):
                for ax in axes:
                    o = o.narrow(ax, 0, real_b)
                sliced.append(o)
            return tuple(sliced) + tuple(outs[len(self._out_dyn):])

        padded = pad_to_bucket("constant")
        if not self._bucket_probed:
            # the manifest cannot tell a per-row model from one that mixes
            # rows and keeps the batch axis (x - x.mean(0)): run the
            # bucket's signature under both pads; a per-row model cannot
            # see them
            alt_in = pad_to_bucket("edge")
            if all(torch.equal(p, q) for p, q in zip(padded, alt_in)):
                # identical pads prove nothing: answer at the exact shape
                return self._call_exact(arrays)
            sliced = slice_back(self._call_exact(padded))
            self._bucket_probed = True
            alt = slice_back(self._call_exact(alt_in))
            for s, e in zip(sliced, alt):
                if not torch.allclose(s.float(), e.float(), rtol=1e-5,
                                      atol=1e-6):
                    self._bucketing = False
                    return self._call_exact(arrays)
            return sliced
        return slice_back(self._call_exact(padded))


def exists(path_prefix):
    return (os.path.exists(path_prefix + PT2_SUFFIX)
            and os.path.exists(path_prefix + META_SUFFIX))
