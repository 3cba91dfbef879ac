"""The Predictor API (counterpart of ``paddle_tpu/inference/predictor.py``;
ref: paddle/fluid/inference/api/analysis_predictor.cc,
paddle_inference_api.h).

Three model sources load into the same :class:`Predictor`:

* a ``.pt2`` artifact (``inference/export.py`` ``save_inference_model``),
  parameters baked in, loadable in a fresh process with no Python class
  of the model: :class:`export.StandaloneModel`, one CUDA graph a batch
  bucket on the card (``serving.standalone_compiles``);
* a ``jit.save`` pair (``.pdmodel`` / ``.pdiparams``): the Layer under
  ``jit.to_static``, one CUDA graph a signature;
* an in-memory Layer (:meth:`Predictor.from_layer`), also under
  ``jit.to_static``.

:class:`Config` selects the device: ``enable_use_gpu`` the card
``cuda:device_id``, ``disable_gpu`` the CPU; with neither, the card, and
with no GPU that raises, as every entry point of the port does.  The
optimisation toggles are accepted and recorded.  The reference's
persistent executable cache (``PADDLE_JIT_CACHE_DIR``) has no counterpart
for a CUDA graph, which lives in its process.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..framework import core
from ..jit import api as jit_api
from ..tensor.tensor import Tensor
from . import export as export_mod
from .export import StandaloneModel


class Config:
    """ref ``paddle_inference_api.h::AnalysisConfig``: the device and the
    optimisation toggles (recorded; nothing to switch)."""

    def __init__(self, model_path=None, params_path=None):
        self.model_path = model_path
        self.params_path = params_path
        self._device = None          # None: the card
        self._memory_pool_mb = 0
        self._ir_optim = True
        self._memory_optim = False
        self._num_threads = 1

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._device = f"cuda:{int(device_id)}"
        self._memory_pool_mb = memory_pool_init_size_mb

    def disable_gpu(self):
        self._device = "cpu"

    def device(self):
        """The ``torch.device`` the Predictor runs on (raises for the card
        when no GPU is visible)."""
        return resolve_device(self._device or DEFAULT_DEVICE)

    def enable_memory_optim(self):
        self._memory_optim = True

    def switch_ir_optim(self, flag=True):
        self._ir_optim = bool(flag)

    def set_cpu_math_library_num_threads(self, n):
        self._num_threads = int(n)


class Predictor:
    def __init__(self, config, _layer=None):
        if isinstance(config, str):
            config = Config(config)
        self._config = config
        self._device = config.device()
        self._model = None
        self._runner = None
        if _layer is not None:
            _layer.eval()
            self._runner = jit_api.to_static(_layer)
            n_in = getattr(config, "_n_inputs", 1)
            self._in_names = [f"x{i}" for i in range(n_in)]
            self._out_names = ["out0"]
        else:
            path = config.model_path
            if path is None:
                raise ValueError(
                    "Config has no model_path: pass an artifact prefix "
                    "(save_inference_model / jit.save output) or use "
                    "Predictor.from_layer(layer) for an in-memory model")
            if path.endswith(jit_api._JIT_SUFFIX):
                path = path[: -len(jit_api._JIT_SUFFIX)]
            if export_mod.exists(path):
                self._model = StandaloneModel(path, device=self._device)
                self._in_names = self._model.input_names()
                self._out_names = self._model.output_names()
            else:
                # the pair's Layer is made on the default place: the
                # Config's, for the load
                prev = core._state.expected_place
                core.set_device(core.place_of(self._device))
                try:
                    traced = jit_api.load(path)
                finally:
                    core._state.expected_place = prev
                traced._layer.eval()
                self._runner = traced
                meta = getattr(traced, "_meta", None) or {}
                n_in = len(meta.get("input_spec", [])) or 1
                self._in_names = [f"x{i}" for i in range(n_in)]
                self._out_names = ["out0"]
        self._inputs = {}
        self._outputs = None

    @classmethod
    def from_layer(cls, layer, config=None, n_inputs=1):
        """Serve an in-memory Layer (no artifact round trip) through
        ``jit.to_static``: one CUDA graph a signature on the card."""
        config = config or Config()
        config._n_inputs = int(n_inputs)
        return cls(config, _layer=layer)

    def get_input_names(self):
        return list(self._in_names)

    def get_output_names(self):
        return list(self._out_names)

    def get_input_handle(self, name):
        if name not in self._in_names:
            raise KeyError(f"unknown input '{name}'; have {self._in_names}")
        return _Handle(self, name)

    def get_output_handle(self, name):
        if name not in self._out_names:
            raise KeyError(
                f"unknown output '{name}'; have {self._out_names}")
        return _OutHandle(self, self._out_names.index(name))

    def run(self, inputs=None):
        """Run on the inputs given, or those the input handles hold.
        Returns the outputs as numpy arrays (a bfloat16 one as its exact
        float32 copy)."""
        if inputs is not None:
            if len(inputs) != len(self._in_names):
                raise ValueError(
                    f"got {len(inputs)} inputs for {len(self._in_names)} "
                    f"input handles {self._in_names}; for an in-memory "
                    "layer declare the arity with "
                    "Predictor.from_layer(net, n_inputs=N)")
            self._inputs = dict(zip(self._in_names, inputs))
        ordered = [self._inputs[n] for n in self._in_names]
        if self._model is not None:
            outs = self._model(*ordered)
        else:
            place = core.place_of(self._device)
            args = [Tensor(x.value if isinstance(x, Tensor) else x,
                           place=place) for x in ordered]
            out = self._runner(*args)
            outs = out if isinstance(out, (list, tuple)) else [out]
            outs = [o.value if isinstance(o, Tensor) else o for o in outs]
        self._outputs = [_host(o) for o in outs]
        if len(self._outputs) != len(self._out_names):
            # a jit pair or a Layer records no output arity: one name a
            # real output, from the first run on
            self._out_names = [f"out{i}"
                               for i in range(len(self._outputs))]
        return self._outputs


def _host(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class _Handle:
    def __init__(self, predictor, name):
        self.predictor = predictor
        self.name = name
        self._shape = None

    def copy_from_cpu(self, arr):
        arr = np.asarray(arr)
        if self._shape is not None:
            arr = arr.reshape(self._shape)
        self.predictor._inputs[self.name] = arr

    def reshape(self, shape):
        self._shape = tuple(shape)


class _OutHandle:
    def __init__(self, predictor, index):
        self.predictor = predictor
        self.index = index

    def copy_to_cpu(self):
        return self.predictor._outputs[self.index]


def create_predictor(config):
    return Predictor(config)
