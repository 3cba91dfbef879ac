"""paddle_tpu_torch.nn: the paddle-style eager nn API (counterpart of
``paddle_tpu/nn``): the layers and their functionals, the initializers,
gradient clipping, ``decode`` (``BeamSearchDecoder``, ``dynamic_decode``)
and ``utils`` (``weight_norm``, ``spectral_norm``)."""
from . import clip, decode, functional, initializer, utils
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   GradientClipByGlobalNorm, GradientClipByNorm,
                   GradientClipByValue, clip_grad_norm_, clip_grad_value_)
from .decode import BeamSearchDecoder, dynamic_decode
from .layer import *  # noqa: F401,F403
from .layer import Layer
from .utils import remove_weight_norm, spectral_norm, weight_norm
from ..tensor.creation import diag_embed  # noqa: F401  (paddle.nn has it)
