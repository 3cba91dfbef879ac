"""paddle_tpu_torch.nn: the paddle-style eager nn API (counterpart of
``paddle_tpu/nn``).  The layers eager training and inference of a
``TransformerEncoder`` touch, the loss layers and gradient clipping; the
rest of the reference's layers are not here yet."""
from . import clip, functional, initializer
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .layer import (CrossEntropyLoss, Dropout, Embedding, L1Loss, Layer,
                    LayerList, LayerNorm, Linear, MSELoss, MultiHeadAttention,
                    NLLLoss, ReLU, RMSNorm, Sequential, Tanh,
                    TransformerEncoder, TransformerEncoderLayer)
