"""BERT / ERNIE masked-LM encoders in PyTorch: the counterpart of
``paddle_tpu/models/bert.py`` at ``mesh=None`` (one device).

Same functional core over the same parameter layout: a dict of tensors
whose block leaves are stacked on a leading ``[L]`` axis (``qkv_w``
``[L, H, 3, H]`` and so on), fp32 master weights, compute in ``cfg.dtype``
(bf16 by default).  Post-LN blocks (sublayer, residual add, LayerNorm);
``lax.scan`` over the layers becomes a Python loop over one ``unbind`` of
each stacked leaf, and ``jax.checkpoint`` of a block becomes
``torch.utils.checkpoint`` (non-reentrant) with ``cfg.remat`` and
gradients on.  The MLM head (transform, LayerNorm, the decoder tied to
``wte``) and the NSP head give :func:`pretrain_loss`;
:func:`make_train_step` is its gradient, the global-norm clip and AdamW
with bert's own decay rule (:func:`_decays`), ``params``, ``m`` and ``v``
updated in place (the reference's ``donate_argnums``).

Routes.  With ``cfg.use_flash`` and no ``pad_mask`` the attention goes
through the flash-attention wrapper (``ops/cuda/flash_attn.py``)
non-causal: on a CUDA tensor its forward and split backward kernels, on a
CPU tensor their plain version; the wrapper never falls back from one to
the other.  ``use_flash=False`` or a ``pad_mask`` takes the dense masked
attention below in plain PyTorch, where the reference takes XLA.  The
reference's ``flash_attention`` runs its Pallas kernel only for hd 64 or a
multiple of 128 and N >= 128 (``_use_pallas``) and its ``_ref_attention``
otherwise; the port's kernels take every width.  The function is the
same; only the route differs (ERNIE's hd 64 at N = 512 takes the kernel
on both).  Every LayerNorm is the plain composition, as the reference's
``_layer_norm`` is: no norm kernel runs here.

A ``mesh``, ``param_specs`` and ``sharding_rules`` (the reference's
GSPMD data and tensor parallelism) are refused by name: multi-GPU training
is ``ROADMAP.md`` Queue 1 item 13.  A sequence longer than
``max_seq_len`` is refused (the reference's ``jnp.take`` fills those
positions with NaN).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import DEFAULT_DEVICE, resolve_device
from ..framework import core
from ..ops import dispatch
from ..ops.cuda.flash_attn import flash_attention
from ..ops.cuda.norms import _ref_layer_norm as _layer_norm
from .common import PytreeLayer, adamw_step, value_and_grad
from .gpt import _c, params_from_numpy, torch_dtype  # noqa: F401
from .gpt_hybrid import init_train_state

# block leaves cast to the compute dtype (once a step, before the unbind)
_MATMUL_LEAVES = ("qkv_w", "qkv_b", "proj_w", "proj_b",
                  "fc1_w", "fc1_b", "fc2_w", "fc2_b")
_MULTI_GPU = "multi-GPU training is ROADMAP.md Queue 1 item 13"


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30592          # BERT vocab 30522 padded to 128 lanes
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_size: int = 0                # 0 -> 4*hidden
    max_seq_len: int = 512
    type_vocab_size: int = 2
    dtype: str = "bfloat16"          # compute dtype
    param_dtype: str = "float32"     # master weights
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    use_flash: bool = True
    remat: bool = True

    def __post_init__(self):
        if self.ffn_size == 0:
            self.ffn_size = 4 * self.hidden_size
        if self.hidden_size % self.num_heads:
            raise ValueError(f"hidden_size {self.hidden_size} must divide "
                             f"by num_heads {self.num_heads}")

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    def num_params(self):
        H, L, F_ = self.hidden_size, self.num_layers, self.ffn_size
        emb = (self.vocab_size + self.max_seq_len + self.type_vocab_size) * H
        per_block = 4 * H * H + 4 * H + 2 * H * F_ + H + F_ + 4 * H
        heads = H * H + H + H * H + H + H + H + 2 * H + 2 + self.vocab_size
        return emb + 2 * H + L * per_block + heads

    def flops_per_token(self):
        """Training FLOPs/token (fwd+bwd ~ 6*N + attention term)."""
        H, L, S = self.hidden_size, self.num_layers, self.max_seq_len
        return 6 * self.num_params() + 12 * L * H * S


def bert_tiny():
    return BertConfig(vocab_size=512, hidden_size=64, num_layers=2,
                      num_heads=4, max_seq_len=128, type_vocab_size=2,
                      dtype="float32", use_flash=False, remat=False)


def bert_base():
    return BertConfig()


def bert_large():
    return BertConfig(hidden_size=1024, num_layers=24, num_heads=16)


def ernie_3_base():
    """ERNIE-3.0-Base geometry (``BASELINE.json``'s pretrain benchmark):
    BERT-base size with the ERNIE vocab, padded to a multiple of 128."""
    return BertConfig(vocab_size=40064, hidden_size=768, num_layers=12,
                      num_heads=12, type_vocab_size=4)


def _refuse_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            f"mesh={mesh!r}: the port's BERT step is single-device; "
            f"{_MULTI_GPU}")


def param_specs(cfg: BertConfig = None):
    """The reference's Megatron tp layout: refused."""
    raise NotImplementedError(f"param_specs: {_MULTI_GPU}")


def sharding_rules(cfg: BertConfig = None):
    """The reference's rule-registry hook for the tp layout: refused."""
    raise NotImplementedError(f"sharding_rules: {_MULTI_GPU}")


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

def init_params(cfg: BertConfig, generator, device=DEFAULT_DEVICE):
    """Parameter dict with the reference's key names and stacked ``[L]``
    block layout, drawn from the ``torch.Generator`` ``generator`` (on its
    own device) and placed on ``device``.  The same seed gives the same
    weights; they differ from ``jax.random``'s draw, so cross-package
    tests carry weights over with :func:`params_from_numpy`."""
    dev = resolve_device(device)
    H, L, F_ = cfg.hidden_size, cfg.num_layers, cfg.ffn_size
    pd = torch_dtype(cfg.param_dtype)
    std = cfg.initializer_range

    def nrm(shape):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * std
        return x.to(device=dev, dtype=pd)

    def full(shape, v):
        return torch.full(shape, v, dtype=pd, device=dev)

    return {
        "wte": nrm((cfg.vocab_size, H)),
        "wpe": nrm((cfg.max_seq_len, H)),
        "wtt": nrm((cfg.type_vocab_size, H)),
        "emb_ln_g": full((H,), 1.0), "emb_ln_b": full((H,), 0.0),
        "blocks": {
            "qkv_w": nrm((L, H, 3, H)),
            "qkv_b": full((L, 3, H), 0.0),
            "proj_w": nrm((L, H, H)),
            "proj_b": full((L, H), 0.0),
            "ln1_g": full((L, H), 1.0), "ln1_b": full((L, H), 0.0),
            "fc1_w": nrm((L, H, F_)),
            "fc1_b": full((L, F_), 0.0),
            "fc2_w": nrm((L, F_, H)),
            "fc2_b": full((L, H), 0.0),
            "ln2_g": full((L, H), 1.0), "ln2_b": full((L, H), 0.0),
        },
        "pool_w": nrm((H, H)), "pool_b": full((H,), 0.0),
        # MLM transform + tied decoder bias, NSP classifier
        "mlm_w": nrm((H, H)), "mlm_b": full((H,), 0.0),
        "mlm_ln_g": full((H,), 1.0), "mlm_ln_b": full((H,), 0.0),
        "mlm_bias": full((cfg.vocab_size,), 0.0),
        "nsp_w": nrm((H, 2)), "nsp_b": full((2,), 0.0),
    }


def init_pretrain_state(cfg: BertConfig, generator, device=DEFAULT_DEVICE,
                        mesh=None):
    """``(params, m, v)``: :func:`init_params` and zero fp32 AdamW
    moments on the same device."""
    _refuse_mesh(mesh)
    params = init_params(cfg, generator, device)
    return (params, *init_train_state(params))


# --------------------------------------------------------------------------
# functional core
# --------------------------------------------------------------------------

def _attention(cfg, q, k, v, pad_mask):
    """q, k, v: [B, N, nh, hd]; pad_mask: [B, N] of valid tokens (nonzero)
    or None.  No mask: the non-causal flash wrapper; a mask: dense."""
    if pad_mask is None and cfg.use_flash:
        return flash_attention(q, k, v, False)
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    if pad_mask is not None:
        # in the logits' dtype, as the reference's weakly typed bias
        bias = torch.where(pad_mask.bool(), 0.0, -1e30).to(logits.dtype)
        logits = logits + bias[:, None, None, :]
    probs = torch.softmax(logits.float(), -1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def block_apply(cfg: BertConfig, x, pad_mask, blk):
    """One post-LN encoder block.  x: [B, N, H]; blk: per-layer params."""
    cd = torch_dtype(cfg.dtype)
    B, N, H = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    eps = cfg.layer_norm_eps

    def mm(a, name):     # a [..., K] @ blk[name] [K, *out] -> [..., *out]
        w = _c(blk[name], cd)
        y = a @ w.reshape(w.shape[0], -1)
        return y.reshape(*a.shape[:-1], *w.shape[1:])

    qkv = mm(x, "qkv_w") + _c(blk["qkv_b"], cd)             # [B, N, 3, H]
    # strided views of the projection: the flash kernels take them as
    # they are, no copy
    q, k, v = [qkv[:, :, i].reshape(B, N, nh, hd) for i in range(3)]
    a = _attention(cfg, q, k, v, pad_mask).reshape(B, N, H)
    a = mm(a, "proj_w") + _c(blk["proj_b"], cd)
    x = _layer_norm(x + a, blk["ln1_g"], blk["ln1_b"], eps)

    h = F.gelu(mm(x, "fc1_w") + _c(blk["fc1_b"], cd), approximate="tanh")
    h = mm(h, "fc2_w") + _c(blk["fc2_b"], cd)
    return _layer_norm(x + h, blk["ln2_g"], blk["ln2_b"], eps)


def _run_blocks(cfg: BertConfig, blocks, x, pad_mask):
    """Every block over x [B, N, H], each checkpointed with ``cfg.remat``
    when gradients are on.  One unbind per stacked leaf: its backward
    stacks the L gradients in one copy, where L selects would each add a
    full [L, ...] gradient; the matmul leaves are cast to the compute
    dtype here, once, not in every block and every recompute."""
    remat = cfg.remat and torch.is_grad_enabled()
    cd = torch_dtype(cfg.dtype)
    stacks = {k: (_c(v, cd) if k in _MATMUL_LEAVES else v).unbind(0)
              for k, v in blocks.items()}
    for i in range(len(stacks["qkv_w"])):
        blk = {k: s[i] for k, s in stacks.items()}
        if remat:
            x = checkpoint(block_apply, cfg, x, pad_mask, blk,
                           use_reentrant=False)
        else:
            x = block_apply(cfg, x, pad_mask, blk)
    return x


def encode(params, tokens, cfg: BertConfig, token_type_ids=None,
           pad_mask=None):
    """tokens [B, N] int -> sequence output [B, N, H] (compute dtype).
    The three embedding takes are summed in the param dtype, cast to the
    compute dtype, then LayerNormed; ``token_type_ids=None`` is type 0."""
    cd = torch_dtype(cfg.dtype)
    N = tokens.shape[-1]
    if N > cfg.max_seq_len:
        raise ValueError(f"sequence of {N} tokens: positions past "
                         f"max_seq_len {cfg.max_seq_len} have no embedding")
    tokens = tokens.long()
    tt = (torch.zeros_like(tokens) if token_type_ids is None
          else token_type_ids.long())
    # F.embedding, not indexing: its backward sums a repeated id's rows in
    # parallel segments, where indexing's sums them in one warp (a type id
    # repeats B * N times)
    x = (F.embedding(tokens, params["wte"]) + params["wpe"][:N]
         + F.embedding(tt, params["wtt"]))
    x = _layer_norm(x.to(cd), params["emb_ln_g"], params["emb_ln_b"],
                    cfg.layer_norm_eps)
    return _run_blocks(cfg, params["blocks"], x, pad_mask)


def pool(params, seq_out, cfg: BertConfig):
    """tanh projection of the [CLS] (position 0) hidden state."""
    cd = torch_dtype(cfg.dtype)
    return torch.tanh(seq_out[:, 0] @ _c(params["pool_w"], cd)
                      + _c(params["pool_b"], cd))


def forward(params, tokens, cfg: BertConfig, token_type_ids=None,
            pad_mask=None):
    """-> (sequence_output [B, N, H], pooled_output [B, H])."""
    seq = encode(params, tokens, cfg, token_type_ids, pad_mask)
    return seq, pool(params, seq, cfg)


def mlm_logits(params, seq_out, cfg: BertConfig):
    """MLM head: transform, LayerNorm, tied decoder.  fp32 logits
    [B, N, V]."""
    cd = torch_dtype(cfg.dtype)
    h = F.gelu(seq_out @ _c(params["mlm_w"], cd) + _c(params["mlm_b"], cd),
               approximate="tanh")
    h = _layer_norm(h, params["mlm_ln_g"], params["mlm_ln_b"],
                    cfg.layer_norm_eps)
    logits = h @ _c(params["wte"], cd).T
    return logits.float() + params["mlm_bias"].float()


def _xent(logits, labels, ignore=-100):
    """Mean cross entropy over the labels that are not ``ignore`` (the
    count clamped to at least 1)."""
    valid = labels != ignore
    safe = torch.where(valid, labels, 0).long()
    lse = torch.logsumexp(logits, -1)
    tgt = logits.gather(-1, safe[..., None])[..., 0]
    ce = torch.where(valid, lse - tgt, 0.0)
    return ce.sum() / valid.sum().clamp(min=1)


def pretrain_loss(params, tokens, mlm_labels, cfg: BertConfig,
                  token_type_ids=None, pad_mask=None, nsp_labels=None):
    """Joint MLM (+ NSP when labels are given) loss, a 0-d fp32 tensor.
    mlm_labels: [B, N] int, -100 at unmasked positions."""
    seq, pooled = forward(params, tokens, cfg, token_type_ids, pad_mask)
    loss = _xent(mlm_logits(params, seq, cfg), mlm_labels)
    if nsp_labels is not None:
        cd = pooled.dtype
        nsp = (pooled @ _c(params["nsp_w"], cd)
               + _c(params["nsp_b"], cd)).float()
        loss = loss + _xent(nsp, nsp_labels)
    return loss


# --------------------------------------------------------------------------
# pretrain step
# --------------------------------------------------------------------------

_NO_DECAY = ("_b", "_g", "ln_g", "ln_b", "mlm_bias", "wpe")


def _decays(path):
    """Weight decay for the leaf at ``path`` (a tuple of keys): not for a
    last key that ends with one of ``_NO_DECAY`` or equals one."""
    leaf = str(path[-1])
    return not any(leaf.endswith(s) or leaf == s for s in _NO_DECAY)


def make_train_step(cfg: BertConfig, mesh=None, beta1=0.9, beta2=0.999,
                    eps=1e-8, weight_decay=0.01, clip_norm=1.0):
    """Returns ``step(params, m, v, t, tokens, mlm_labels, nsp_labels, lr)
    -> (params, m, v, loss)``.  tokens / mlm_labels: [B, N] int and
    nsp_labels: [B] int (or None) on the params' device; t: the 1-based
    step count and lr: the learning rate, each a number or a tensor; loss:
    a 0-d tensor.  ``params``, ``m`` and ``v`` are updated in place and
    returned; the step makes no host sync."""
    _refuse_mesh(mesh)

    def step(params, m, v, t, tokens, mlm_labels, nsp_labels, lr):
        loss, grads = value_and_grad(
            lambda p: pretrain_loss(p, tokens, mlm_labels, cfg,
                                    nsp_labels=nsp_labels), params)
        adamw_step(params, grads, m, v, t, lr, beta1, beta2, eps,
                   weight_decay, clip_norm, _decays)
        return params, m, v, loss

    return step


# --------------------------------------------------------------------------
# eager Layer wrappers (dygraph API)
# --------------------------------------------------------------------------

class BertModel(PytreeLayer):
    """Eager encoder: forward(tokens, token_type_ids=None, pad_mask=None)
    -> (sequence_output, pooled_output).  Weights are drawn from the
    default generator on the default place.  The forward records on the
    tape (grad mode on), so ``loss.backward()`` fills each named
    Parameter's ``.grad`` and an ``optimizer`` steps them."""

    def __init__(self, cfg: BertConfig = None, **kwargs):
        super().__init__()
        self.cfg = cfg or BertConfig(**kwargs)
        self._adopt_tree(init_params(self.cfg,
                                     core.default_generator().torch,
                                     core.get_place().device))

    def forward(self, tokens, token_type_ids=None, pad_mask=None):
        fn = lambda p, t, tt, pm: forward(p, t, self.cfg, tt, pm)  # noqa: E731
        return dispatch.call(fn, self._tree(), tokens, token_type_ids,
                             pad_mask, _name="bert")


class BertForPretraining(BertModel):
    """forward(tokens, mlm_labels, nsp_labels=None, ...) -> scalar loss
    (or (sequence_output, pooled_output) when labels are omitted)."""

    def forward(self, tokens, mlm_labels=None, nsp_labels=None,
                token_type_ids=None, pad_mask=None):
        if mlm_labels is None:
            return super().forward(tokens, token_type_ids, pad_mask)
        fn = (lambda p, t, ml, nl, tt, pm:  # noqa: E731
              pretrain_loss(p, t, ml, self.cfg, tt, pm, nl))
        return dispatch.call(fn, self._tree(), tokens, mlm_labels,
                             nsp_labels, token_type_ids, pad_mask,
                             _name="bert_pretrain_loss")


ErnieModel = BertModel
ErnieForPretraining = BertForPretraining
