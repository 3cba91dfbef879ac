"""auto_cast (counterpart of ``paddle_tpu/amp/auto_cast.py``).

The reference's list semantics, not ``torch.autocast``'s: inside
``auto_cast`` an op of the white list casts its floating inputs of
another dtype to the AMP dtype (bf16 by default), an op of the black list
casts inputs of the AMP dtype to fp32, and every other op runs on what it
is given.  Ops are named by ``ops.dispatch.call``'s ``_name``, which the
nn functionals set to the reference's names.  The cast runs inside the op
(:func:`maybe_autocast_fn`), so it is on the tape and autograd casts the
gradients back: bf16 activation grads reach fp32 master weights as fp32.
"""
from __future__ import annotations

import contextlib

import torch

from ..framework import core

# ops cast to the AMP dtype (the reference's white list: matmul, conv)
white_list = {"matmul", "mm", "bmm", "linear", "conv1d", "conv2d", "conv3d",
              "flash_attention", "sdpa", "einsum"}
# ops kept in fp32 (softmax, norms, loss reductions)
black_list = {"softmax", "log_softmax", "layer_norm", "batch_norm",
              "cross_entropy", "mean", "sum", "norm"}


class _AmpState:
    def __init__(self, enable, dtype, level, white, black):
        self.enable = enable
        self.dtype = dtype
        self.level = level
        self.white_list = white
        self.black_list = black


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    prev = core._state.amp_state
    wl = set(white_list) | set(custom_white_list or ())
    bl = set(black_list) | set(custom_black_list or ())
    state = _AmpState(enable, core.convert_dtype(dtype), level, wl, bl)
    core._state.amp_state = state if enable else None
    try:
        yield
    finally:
        core._state.amp_state = prev


amp_guard = auto_cast


def amp_state():
    return core._state.amp_state


def _cast_tree(x, src, target):
    if isinstance(x, torch.Tensor):
        return x.to(target) if src(x.dtype) else x
    if isinstance(x, (list, tuple)):
        return type(x)(_cast_tree(v, src, target) for v in x)
    if isinstance(x, dict):
        return {k: _cast_tree(v, src, target) for k, v in x.items()}
    return x


def maybe_autocast_fn(fn, opname):
    """``fn`` with its floating inputs cast as the active ``auto_cast``'s
    lists say for ``opname`` (``fn`` itself for an op on neither list)."""
    st = core._state.amp_state
    if st is None or not st.enable:
        return fn
    if opname in st.white_list:
        target = st.dtype

        def src(d):
            return d.is_floating_point and d != target
    elif opname in st.black_list:
        # only undo the AMP downcast; leave fp64 pipelines alone
        target, low = torch.float32, st.dtype

        def src(d):
            return d == low
    else:
        return fn

    def wrapped(*a, **k):
        a, k = _cast_tree((a, k), src, target)
        return fn(*a, **k)

    wrapped.__name__ = getattr(fn, "__name__", opname)
    return wrapped


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast the models' parameters to ``dtype`` (O1 leaves them)."""
    dt = core.convert_dtype(dtype)
    single = not isinstance(models, (list, tuple))
    ms = [models] if single else list(models)
    if level == "O2":
        for m in ms:
            m.to(dtype=dt)
    if optimizers is None:
        return models if single else ms
    return (models if single else ms), optimizers
