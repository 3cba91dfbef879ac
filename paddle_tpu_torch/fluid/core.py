"""fluid.core (counterpart of ``paddle_tpu/fluid/core.py``): the names of
the reader path and the places; the rest raises, naming ROADMAP Queue 1
item 4."""
from ..framework.core import CPUPlace, CUDAPlace, Place  # noqa: F401
from ..static.graph import Scope, global_scope  # noqa: F401
from ._facade import not_ported
from .reader_compat import EOFException  # noqa: F401

__getattr__ = not_ported(__name__)
