from .activation import (ELU, GELU, GLU, SELU, Hardshrink, Hardsigmoid,
                         Hardswish, Hardtanh, LeakyReLU, LogSigmoid,
                         LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6, RReLU,
                         Sigmoid, Silu, Softmax, Softplus, Softshrink,
                         Softsign, Swish, Tanh, Tanhshrink, ThresholdedReLU)
from .common import Dropout, Embedding, Linear
from .container import LayerList, Sequential
from .conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                   Conv3DTranspose)
from .layers import Layer
from .loss import (BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss,
                   CrossEntropyLoss, CTCLoss, HingeEmbeddingLoss,
                   HSigmoidLoss, KLDivLoss, L1Loss, MarginRankingLoss,
                   MSELoss, NLLLoss, SmoothL1Loss, TripletMarginLoss)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   LayerNorm, RMSNorm, SyncBatchNorm)
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
                      AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D,
                      AvgPool1D, AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D,
                      MaxPool3D)
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)
