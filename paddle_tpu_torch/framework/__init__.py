"""paddle_tpu_torch.framework: dtypes, places, grad mode and RNG
(counterpart of ``paddle_tpu/framework``; only what the nn API uses)."""
from .core import (CPUPlace, CUDAPlace, Generator, Place, convert_dtype,
                   default_generator, get_default_dtype, get_device,
                   get_place, seed, set_default_dtype, set_device)
from .param_attr import ParamAttr
