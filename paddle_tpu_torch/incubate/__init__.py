"""paddle.incubate (counterpart of ``paddle_tpu/incubate/__init__.py``):
the fused ops over the port's kernels (``flash_attention``, ``rms_norm``,
``fused_feedforward``, ``fused_layer_norm``) and the weight-space
optimizer wrappers (``optimizer``).  ``ring_attention`` comes with
multi-GPU training (ROADMAP Queue 1 item 13) and ``moe`` with MoE (item
9); both raise."""
from ..nn.functional.attention import flash_attention  # noqa: F401
from ..nn.functional.norm import rms_norm  # noqa: F401
from . import optimizer  # noqa: F401
from .optimizer import (ExponentialMovingAverage, LookAhead,  # noqa: F401
                        ModelAverage)


def fused_feedforward(x, w1, b1, w2, b2):
    """``gelu(x @ w1 + b1) @ w2 + b2`` in one kernel on the card
    (``ops/cuda/fused_ffn.py``; its plain version on the CPU), eager and
    differentiable; the reference grows the same op as
    ``fused_feedforward``."""
    from ..ops import dispatch
    from ..ops.cuda.fused_ffn import fused_ffn
    return dispatch.call(fused_ffn, x, w1, b1, w2, b2,
                         _name="fused_feedforward")


def fused_layer_norm(x, weight, bias, epsilon=1e-5):
    """The last-axis LayerNorm kernel (``ops/cuda/norms.py``), eager and
    differentiable."""
    from ..ops import dispatch
    from ..ops.cuda import norms
    return dispatch.call(lambda a, w, b: norms.layer_norm(a, w, b, epsilon),
                         x, weight, bias, _name="fused_layer_norm")


def ring_attention(*args, **kwargs):
    raise NotImplementedError(
        "incubate.ring_attention needs sequence parallelism over several "
        "cards (ROADMAP Queue 1 item 13)")


def __getattr__(name):
    if name == "moe":
        raise NotImplementedError(
            "incubate.moe is not ported (ROADMAP Queue 1 item 9, MoE)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
