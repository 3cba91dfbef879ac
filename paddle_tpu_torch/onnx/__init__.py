"""paddle.onnx (counterpart of ``paddle_tpu/onnx/__init__.py``).

The reference's interchange format is its standalone StableHLO artifact;
the port's is the ``torch.export`` artifact of
``inference.save_inference_model`` (``<path>.pt2`` + ``<path>.pdmeta``),
which ``inference.Predictor`` loads in a fresh process with no Python
model class.  ``opset_version`` is accepted and ignored, as there."""
from __future__ import annotations

from ..inference.export import save_inference_model


def export(layer, path, input_spec=None, opset_version=None, **configs):
    """Export ``layer`` to the artifact at ``path``; returns its
    manifest."""
    if input_spec is None:
        raise ValueError("input_spec is required to export a model")
    return save_inference_model(path, layer, input_spec, **configs)
