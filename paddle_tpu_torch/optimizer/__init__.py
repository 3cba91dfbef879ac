"""paddle_tpu_torch.optimizer (counterpart of ``paddle_tpu/optimizer``):
the ``Optimizer`` classes over ``Layer.parameters()``, the LR schedulers
(``lr``) and the train steps' functional AdamW (``functional``)."""
from . import functional, lr
from .optimizer import Optimizer, reset_fused_stats
from .optimizers import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
                         DecayedAdagrad, Dpsgd, Ftrl, Lamb, LarsMomentum,
                         Momentum, RMSProp)
