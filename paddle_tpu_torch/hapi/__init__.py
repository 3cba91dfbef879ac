"""paddle_tpu_torch.hapi: ``Model``, its callbacks and ``summary``
(counterpart of ``paddle_tpu/hapi``)."""
from .model import Model
from . import callbacks
from .model_summary import summary
