"""fluid.io (counterpart of ``paddle_tpu/fluid/io.py``): ``PyReader``, the
class spelling of ``py_reader``; the rest raises, naming ROADMAP Queue 1
item 4."""
from ._facade import not_ported
from .reader_compat import PyReader  # noqa: F401

__getattr__ = not_ported(__name__)
