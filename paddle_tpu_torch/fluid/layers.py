"""fluid.layers (counterpart of ``paddle_tpu/fluid/layers.py``): the
reader path's four names; the rest of the fluid op spelling raises,
naming ROADMAP Queue 1 item 4."""
from ._facade import not_ported
from .reader_compat import (create_py_reader_by_data,  # noqa: F401
                            double_buffer, py_reader, read_file)

__getattr__ = not_ported(__name__)
