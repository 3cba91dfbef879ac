from .activation import ReLU, Tanh
from .common import Dropout, Embedding, Linear
from .container import LayerList, Sequential
from .conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                   Conv3DTranspose)
from .layers import Layer
from .loss import CrossEntropyLoss, L1Loss, MSELoss, NLLLoss
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   LayerNorm, RMSNorm, SyncBatchNorm)
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
                      AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D,
                      AvgPool1D, AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D,
                      MaxPool3D)
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)
