"""paddle_tpu_torch.nn.functional (counterpart of
``paddle_tpu/nn/functional``; only what eager inference of a
``TransformerEncoder`` calls)."""
from .activation import gelu, relu
from .attention import flash_attention, scaled_dot_product_attention
from .common import dropout, embedding, linear
from .norm import layer_norm, rms_norm
