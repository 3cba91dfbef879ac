"""paddle_tpu_torch.tensor: the Tensor over ``torch.Tensor`` and the ops
the nn API uses (counterpart of ``paddle_tpu/tensor``)."""
from .tensor import Parameter, Tensor
from .creation import arange, ones, to_tensor, zeros
from .manipulation import concat, flatten, reshape, split, transpose
from .math import add, matmul, mean, sum
