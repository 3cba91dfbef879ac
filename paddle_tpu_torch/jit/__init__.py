"""paddle_tpu_torch.jit: ``InputSpec`` only (ROADMAP Queue 1 item 4 keeps
``to_static``, ``save`` and ``load`` queued)."""
from .api import InputSpec
