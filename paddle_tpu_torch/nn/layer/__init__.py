from .common import Dropout, Embedding, Linear
from .container import LayerList, Sequential
from .layers import Layer
from .norm import LayerNorm, RMSNorm
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)
