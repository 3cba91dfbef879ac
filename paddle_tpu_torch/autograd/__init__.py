"""paddle_tpu_torch.autograd: grad-mode switches (the eager tape's
backward comes with the eager-training slice)."""
from . import tape
from .tape import enable_grad, is_grad_enabled, no_grad, set_grad_enabled
