"""The port's inference stack (counterpart of
``paddle_tpu/inference/__init__.py``):

* :mod:`.export`: ``torch.export`` artifacts (``save_inference_model`` /
  :class:`StandaloneModel`), one CUDA graph a batch bucket on the card;
* :mod:`.predictor`: :class:`Predictor` / :class:`Config` /
  :func:`create_predictor`, the named-handle API over artifacts, ``jit``
  pairs or an in-memory Layer;
* :mod:`.serving`: the paged and slot-contiguous serving engines over the
  ``kv_pager`` page allocator; :mod:`.speculative`: speculative decoding.

The reference's ``fleet`` and ``autoscale`` come with ROADMAP Queue 1
item 11.
"""
from __future__ import annotations

from . import export as export_mod                       # noqa: F401
from .export import StandaloneModel, save_inference_model  # noqa: F401
from .predictor import (Config, Predictor, _Handle,  # noqa: F401
                        _OutHandle, create_predictor)

_SERVING_NAMES = ("ServingEngine", "PagedServingEngine",
                  "ServingQueueFull", "Request")
_SPEC_NAMES = ("SpeculativeServingEngine",)
_FLEET_NAMES = ("ServingFleet", "FleetOverloaded", "FleetRequest",
                "Autoscaler", "fleet", "autoscale")


def serving_stats():
    """The process's ``serving.*`` counters (``profiler.serving_stats``)."""
    from ..profiler import serving_stats as _serving_stats
    return _serving_stats()


def __getattr__(name):
    import importlib
    if name in _SERVING_NAMES or name == "serving":
        serving = importlib.import_module(__name__ + ".serving")
        return serving if name == "serving" else getattr(serving, name)
    if name in _SPEC_NAMES or name == "speculative":
        spec = importlib.import_module(__name__ + ".speculative")
        return spec if name == "speculative" else getattr(spec, name)
    if name in _FLEET_NAMES:
        raise NotImplementedError(
            f"inference.{name}: the serving fleet and its autoscaler are not "
            "ported (ROADMAP Queue 1 item 11)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
