"""paddle_tpu_torch.nn.functional (counterpart of
``paddle_tpu/nn/functional``; what eager training and inference of a
``TransformerEncoder`` call, and the ported losses)."""
from .activation import gelu, relu, selu, softmax
from .attention import flash_attention, scaled_dot_product_attention
from .common import dropout, embedding, linear
from .loss import (cross_entropy, l1_loss, mse_loss, nll_loss,
                   softmax_with_cross_entropy)
from .norm import layer_norm, rms_norm
