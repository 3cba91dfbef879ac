"""paddle_tpu_torch.autograd: grad-mode switches, the eager tape's
``backward`` and ``grad`` on torch autograd, and ``PyLayer``."""
from . import tape
from .py_layer import PyLayer, PyLayerContext
from .tape import (backward, enable_grad, grad, is_grad_enabled, no_grad,
                   set_grad_enabled)
