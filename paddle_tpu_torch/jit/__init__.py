"""paddle_tpu_torch.jit: ``InputSpec`` and the static-mode switches
(ROADMAP Queue 1 item 4 keeps ``to_static``, ``save`` and ``load``
queued)."""
from .api import InputSpec, disable_static, enable_static, in_static_mode
