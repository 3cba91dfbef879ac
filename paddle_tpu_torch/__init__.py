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

The third slice ports int8 quantized paged serving: ``quantization``,
the quantized routes of ``models.gpt`` and the engine's ``quant=`` and
``kv_dtype="int8"``, on ``ops.cuda.dequant_matmul`` and the int8 paged
attention kernel.  The fourth ports the GPT-3 1.3B training recipe:
``use_fused_ffn`` on ``ops.cuda.fused_ffn`` and the fused flash backward.

The fifth slice ports eager nn-API inference (a ``TransformerEncoder``
under ``no_grad``):

* ``framework`` (dtypes, places on ``torch.device``, grad mode, seeded
  generators, ``ParamAttr``), ``tensor`` (the ``Tensor`` over
  ``torch.Tensor`` and the ops the API calls), ``ops.dispatch.call`` and
  ``autograd`` (``no_grad`` and the other grad-mode switches);
* ``nn`` -- ``Layer``, ``LayerList``, ``Sequential``, ``Linear``,
  ``Embedding``, ``Dropout``, ``LayerNorm``, ``RMSNorm``,
  ``MultiHeadAttention``, ``TransformerEncoderLayer``,
  ``TransformerEncoder``, their functionals and initializers;
* ``ops.cuda.norms.rms_norm`` -- the RMSNorm kernel.

The twelfth slice ports ERNIE-3.0-Base pretraining: ``models.bert``
(configs and presets, params, the encoder, MLM and NSP heads,
``pretrain_loss``, ``make_train_step`` and the eager ``BertModel`` /
``BertForPretraining`` wrappers) and ``models.common`` (the tree walk and
AdamW step shared with ``gpt_hybrid``, ``PytreeLayer``), running the flash
forward and split backward non-causal.

The thirteenth slice ports eager dygraph training: ``loss.backward()`` on
torch autograd (``Tensor.grad`` / ``backward`` / ``register_hook``,
``autograd.grad`` and ``PyLayer``), the ``Optimizer`` classes
(``optimizer``, one multi-tensor update a step for SGD, Momentum, Adam
and AdamW) and their LR schedulers (``optimizer.lr``), ``regularizer``,
gradient clipping (``nn.ClipGrad*``), the losses (``nn.functional.loss``,
``nn.CrossEntropyLoss`` ...), ``amp`` (``auto_cast`` with the
reference's op lists, ``GradScaler``) and dropout masks drawn on the
tensor's device.

The fourteenth slice ports the high-level training API: ``io``
(datasets, samplers, ``DataLoader`` in its four modes with the native ring
and ``prefetch_to_device``, ``save`` / ``load`` in the reference's
format), ``runtime`` (the C++ staging pool and ring, built by g++ at
first use), ``metric``, ``hapi`` (``Model``, callbacks, ``summary``) and
``InputSpec`` (``jit``, ``static``).
"""
from . import amp, autograd, nn, optimizer, regularizer
from . import io, jit, metric, static
from .autograd import grad, no_grad
from .hapi import callbacks
from .hapi.model import Model
from .hapi.model_summary import summary
from .io.serialization import load, save
from .device import DEFAULT_DEVICE, card_info, resolve_device
from .framework import get_device, seed, set_device
from .tensor import (Tensor, concat, matmul, mean, reshape, split, sum,
                     to_tensor, transpose)

__all__ = ["DEFAULT_DEVICE", "Model", "Tensor", "amp", "autograd",
           "callbacks", "card_info", "concat", "get_device", "grad", "io",
           "jit", "load", "matmul", "mean", "metric", "nn", "no_grad",
           "optimizer", "regularizer", "reshape", "resolve_device", "save",
           "seed", "set_device", "split", "static", "sum", "summary",
           "to_tensor", "transpose"]
