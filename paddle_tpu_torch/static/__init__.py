"""paddle_tpu_torch.static: ``InputSpec`` only (counterpart of
``paddle_tpu/static/__init__.py:13``); the static graph is not ported."""
from ..jit.api import InputSpec
