from .common import Dropout, Embedding, Linear
from .container import LayerList, Sequential
from .layers import Layer
from .loss import CrossEntropyLoss, L1Loss, MSELoss, NLLLoss
from .norm import LayerNorm, RMSNorm
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)
