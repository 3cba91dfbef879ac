"""paddle_tpu_torch: the PyTorch/CUDA port of ``paddle_tpu`` for one
NVIDIA H100.

The JAX package ``paddle_tpu`` stays the reference.  This package imports
``torch``, numpy and the standard library only, never ``jax`` or
``paddle_tpu``.  Its kernels are hand-written CUDA for ``sm_90a`` under
``ops/cuda/csrc/``, built at first use by ``ops/cuda/build.py``.

The first slice ports the paged GPT serving path:

* ``models.gpt`` -- config, params, forward, cached and paged decode,
  ``generate`` and the npz weight bridge;
* ``inference.serving.PagedServingEngine`` -- wave prefill, paged decode,
  shared-prefix pages with copy-on-write, preemption on page exhaustion;
* ``ops.cuda.paged_attn`` and ``ops.cuda.norms`` -- the paged
  decode-attention and LayerNorm kernels.

The second slice ports the single-device training step:

* ``models.gpt.loss_fn`` with flash attention and remat in ``forward``;
* ``models.gpt_hybrid`` -- ``make_train_step`` (the dp=tp=pp=sp=1 case of
  the reference's hybrid step), ``init_train_state``, ``loss_and_grads``;
* ``optimizer.functional.adamw_update``;
* ``ops.cuda.flash_attn`` -- the flash-attention forward and split
  backward kernels.
"""
from .device import DEFAULT_DEVICE, card_info, resolve_device

__all__ = ["DEFAULT_DEVICE", "card_info", "resolve_device"]
