"""paddle_tpu_torch.jit (counterpart of ``paddle_tpu/jit/__init__.py``):
``to_static`` (one CUDA graph per input signature on the card, the eager
functional call on the CPU), ``save`` / ``load``, ``TracedLayer`` and its
alias ``TranslatedLayer``, ``ProgramTranslator``, ``InputSpec``, the
static-mode switches and ``functional``.  With no source-translation pass
the verbosity switches only store their level, as in the reference."""
from . import functional
from .api import (InputSpec, ProgramTranslator, TracedLayer, disable_static,
                  enable_static, in_static_mode, load, not_to_static, save,
                  to_static)
from .api import TracedLayer as TranslatedLayer  # noqa: F401

_verbosity = [0]


def set_verbosity(level=0, also_to_stdout=False):
    _verbosity[0] = int(level)


def set_code_level(level=100, also_to_stdout=False):
    _verbosity[0] = int(level)
