"""paddle_tpu_torch.nn: the paddle-style eager nn API (counterpart of
``paddle_tpu/nn``).  The layers eager training and inference of a
``TransformerEncoder`` touch, convolutions, pooling and batch norm (the
vision models'), the activation and loss layers and gradient clipping;
the rest of the reference's layers are not here yet."""
from . import clip, functional, initializer
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .layer import *  # noqa: F401,F403
from .layer import Layer
