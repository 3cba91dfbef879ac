"""paddle_tpu_torch.nn: the paddle-style eager nn API (counterpart of
``paddle_tpu/nn``).  The layers eager training and inference of a
``TransformerEncoder`` touch, convolutions, pooling and batch norm (the
vision models'), the loss layers and gradient clipping; the rest of the
reference's layers are not here yet."""
from . import clip, functional, initializer
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .layer import (AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
                    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D,
                    AvgPool1D, AvgPool2D, AvgPool3D, BatchNorm, BatchNorm1D,
                    BatchNorm2D, BatchNorm3D, Conv1D, Conv1DTranspose, Conv2D,
                    Conv2DTranspose, Conv3D, Conv3DTranspose,
                    CrossEntropyLoss, Dropout, Embedding, L1Loss, Layer,
                    LayerList, LayerNorm, Linear, MaxPool1D, MaxPool2D,
                    MaxPool3D, MSELoss, MultiHeadAttention, NLLLoss, ReLU,
                    RMSNorm, Sequential, SyncBatchNorm, Tanh,
                    TransformerEncoder, TransformerEncoderLayer)
