"""paddle_tpu_torch.nn: the paddle-style eager nn API (counterpart of
``paddle_tpu/nn``).  This slice ports what eager inference of a
``TransformerEncoder`` touches; the rest of the reference's layers are not
here yet."""
from . import functional, initializer
from .layer import (Dropout, Embedding, Layer, LayerList, LayerNorm, Linear,
                    MultiHeadAttention, RMSNorm, Sequential,
                    TransformerEncoder, TransformerEncoderLayer)
