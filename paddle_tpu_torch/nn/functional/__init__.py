"""paddle_tpu_torch.nn.functional (counterpart of
``paddle_tpu/nn/functional``; what eager training and inference of a
``TransformerEncoder`` and of the vision models call, and the ported
losses)."""
from .activation import gelu, relu, selu, softmax, tanh
from .attention import flash_attention, scaled_dot_product_attention
from .common import dropout, embedding, linear
from .conv import (conv1d, conv1d_transpose, conv2d, conv2d_transpose, conv3d,
                   conv3d_transpose)
from .loss import (cross_entropy, l1_loss, mse_loss, nll_loss,
                   softmax_with_cross_entropy)
from .norm import batch_norm, layer_norm, rms_norm
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,
                      adaptive_avg_pool3d, adaptive_max_pool1d,
                      adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                      avg_pool2d, avg_pool3d, max_pool1d, max_pool2d,
                      max_pool3d)
