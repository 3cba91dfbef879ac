"""paddle_tpu_torch.nn.utils (counterpart of ``paddle_tpu/nn/utils``):
``weight_norm`` / ``remove_weight_norm``, ``spectral_norm`` and the
gradient clipping functions."""
from ..clip import clip_grad_norm_, clip_grad_value_  # noqa: F401
from .spectral_norm_hook import spectral_norm  # noqa: F401
from .weight_norm_hook import remove_weight_norm, weight_norm  # noqa: F401
