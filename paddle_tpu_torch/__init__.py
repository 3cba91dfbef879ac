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

The seventeenth slice ports the static graph and the vision stack that
the reference bench's ResNet50 train step runs: ``static`` (``Program``,
``program_guard``, ``data``, the ``Executor`` and ``ParallelExecutor``
replaying the recorded ops, ``append_backward`` / ``gradients``, part of
``static.nn``), ``enable_static`` / ``disable_static``, the recording
hook in ``ops.dispatch.call``, ``Optimizer.minimize`` in static mode,
``nn`` convolutions, pooling and batch norm (functional and layers,
layer buffers), ``flatten`` and ``vision`` (``ResNet`` and ``LeNet``, the
synthetic ``MNIST``); and ``ops.cuda.row_matmul``, the row-invariant
product the paged decode and the fp verify take.

The twentieth slice ports the eager tensor API: the ``tensor`` modules
(``creation``, ``math``, ``manipulation``, ``logic``, ``search``,
``stat``, ``linalg``, ``random``, ``attribute``) exported here under the
reference's names, the Tensor's methods and operators (``x[m] = v``
included), the dtypes as attributes (``paddle.float32`` is
``torch.float32``, so ``x.dtype == paddle.float32``), the grad-mode
switches, the generator state and the tensor arrays; and ``nn``'s
activations and the rest of its losses, functional and layers.

The package also holds ``debug`` (the nan guard, ``check_numerics``),
``profiler`` (host events op by op, device traces), the dispatch's hooks
and ``cache_stats``, ``jit`` (``to_static`` as one CUDA graph per input
signature, ``save`` / ``load``, ``functional``) and the rest of
``static`` (control flow, ``misc``, the other ``static.nn`` builders,
``save`` / ``load`` and serialization); the eager tensor API keeps the
reference's dtypes on bool, small integer and 16-bit inputs.

The static-graph and deployment workflow: ``fluid``'s reader path
(``py_reader``, ``EOFException``, ``DatasetFactory``), ``distributed``'s
MultiSlot datasets and generators (``Executor.train_from_dataset``),
``inference`` (``torch.export`` artifacts with the kernels as
``torch.library`` ops, the ``Predictor``, one CUDA graph a batch bucket),
``onnx.export``, ``optimizer.GradientMergeOptimizer``, ``incubate``
(``LookAhead``, ``ModelAverage``, ``ExponentialMovingAverage``, the fused
ops) and ``utils.CheckpointManager``.
"""
import sys as _sys

import torch as _torch

from . import amp, autograd, nn, optimizer, regularizer
from . import debug, io, jit, metric, profiler, static, vision
from .autograd import (enable_grad, grad, is_grad_enabled, no_grad,
                       set_grad_enabled)
from .hapi import callbacks
from .hapi.model import Model
from .hapi.model_summary import summary
from .io.serialization import load, save
from .jit.api import disable_static, enable_static, in_static_mode
from .jit.api import disable_static as enable_dygraph  # noqa: E402
from .jit.api import enable_static as disable_dygraph  # noqa: E402
from .static.nn import create_parameter  # noqa: E402
from .device import DEFAULT_DEVICE, card_info, resolve_device
from .framework import (CPUPlace, CUDAPlace, Generator, ParamAttr,
                        get_default_dtype, get_device, seed,
                        set_default_dtype, set_device)
from .framework import core as _core
from .tensor import *  # noqa: F401,F403,E402
from .tensor import (Parameter, Tensor, array_length, array_read,
                     array_write, create_array)
from .tensor.attribute import rank, shape  # noqa: F401
from .tensor.linalg import inv as inverse  # noqa: F401
# the star import binds the op modules' names (math, random ...) here;
# paddle_tpu_torch.tensor stays the package, as in the reference
tensor = _sys.modules[__name__ + ".tensor"]
from . import (distributed, distribution, fluid, incubate,  # noqa
               inference, onnx, utils)

# dtypes as module attributes: the port's own dtype objects, so that
# ``x.dtype == paddle_tpu_torch.float32`` holds
float16 = _torch.float16
bfloat16 = _torch.bfloat16
float32 = _torch.float32
float64 = _torch.float64
int8 = _torch.int8
int16 = _torch.int16
int32 = _torch.int32
int64 = _torch.int64
uint8 = _torch.uint8
bool = _torch.bool
complex64 = _torch.complex64
complex128 = _torch.complex128
dtype = _torch.dtype


def get_rng_state():
    """The default generator's state (every device's stream)."""
    return _core.default_generator().get_state()


def set_rng_state(state):
    _core.default_generator().set_state(state)


tensor._bind_longtail()

__all__ = sorted(n for n in dir() if not n.startswith("_"))
