"""paddle_tpu_torch.optimizer (counterpart of ``paddle_tpu/optimizer``):
the ``Optimizer`` classes over ``Layer.parameters()``, the LR schedulers
(``lr``), the train steps' functional AdamW (``functional``) and
``GradientMergeOptimizer``."""
from . import functional, lr
from .gradient_merge import GradientMergeOptimizer
from .optimizer import Optimizer, reset_fused_stats
from .optimizers import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
                         DecayedAdagrad, Dpsgd, Ftrl, Lamb, LarsMomentum,
                         Momentum, RMSProp)
