"""GPT decoder-only LM in PyTorch: the counterpart of
``paddle_tpu/models/gpt.py``, limited to what paged serving and the
single-device training step run.

Same functional core over the same parameter layout: a dict of tensors
whose block leaves are stacked on a leading ``[L]`` axis (``qkv_w``
``[L, H, 3, H]`` and so on), fp32 master weights, compute in
``cfg.dtype``.  ``lax.scan`` over layers becomes a Python loop.  KV caches
and page pools are written in place (the JAX functions return new
arrays); the functions still return them, so call sites read the same.

With ``cfg.use_pallas_norm`` every LayerNorm (ln1, ln2 and the final
lnf) goes through the CUDA LayerNorm wrapper (``ops/cuda/norms.py``);
with ``cfg.use_flash`` the attention of :func:`forward` goes through the
flash-attention wrapper (``ops/cuda/flash_attn.py``); paged decode
attention always goes through the paged-attention wrapper
(``ops/cuda/paged_attn.py``).  Each takes its plain PyTorch version for
tensors on the CPU.  With ``cfg.remat`` and gradients on, :func:`forward`
checkpoints each block (``torch.utils.checkpoint``, non-reentrant):
``remat_policy="full"`` recomputes the whole block in the backward,
``"dots"`` keeps the outputs of the weight matmuls (``aten.mm`` /
``aten.addmm``, no batch dims), as ``jax.checkpoint_policies.
dots_with_no_batch_dims_saveable`` does.

Not in this slice, each refused by name: MoE FFNs (``moe_experts``), the
fused FFN (``use_fused_ffn``), quantized weights, chunked prefill and
speculative verify.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import DEFAULT_DEVICE, resolve_device
from ..ops.cuda.flash_attn import flash_attention
from ..ops.cuda.norms import _ref_layer_norm
from ..ops.cuda.norms import layer_norm as _kernel_layer_norm
from ..ops.cuda.paged_attn import paged_attention

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

# block leaves that block_apply casts to the compute dtype
_MATMUL_LEAVES = ("qkv_w", "qkv_b", "proj_w", "proj_b",
                  "fc1_w", "fc1_b", "fc2_w", "fc2_b")


def torch_dtype(name):
    """``cfg.dtype`` / ``cfg.param_dtype`` string -> ``torch.dtype``."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; expected one of "
                         f"{sorted(_DTYPES)}") from None


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_size: int = 0                # 0 -> 4*hidden
    max_seq_len: int = 1024
    dtype: str = "bfloat16"          # compute dtype
    param_dtype: str = "float32"     # master weights
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-5
    use_flash: bool = True
    use_fused_ffn: bool = False
    use_pallas_norm: bool = False
    remat: bool = True
    remat_policy: str = "full"
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25

    def __post_init__(self):
        if self.ffn_size == 0:
            self.ffn_size = 4 * self.hidden_size
        if self.hidden_size % self.num_heads:
            raise ValueError(f"hidden_size {self.hidden_size} must divide "
                             f"by num_heads {self.num_heads}")
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(f"remat_policy {self.remat_policy!r}")
        if self.moe_experts < 0 or self.moe_capacity_factor <= 0:
            raise ValueError("moe_experts must be >= 0 and "
                             "moe_capacity_factor > 0")

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    def num_params(self):
        H, L, F_, V, S = (self.hidden_size, self.num_layers, self.ffn_size,
                          self.vocab_size, self.max_seq_len)
        per_block = (4 * H + 3 * H * H + 3 * H + H * H + H + H * F_ + F_
                     + F_ * H + H)
        return V * H + S * H + L * per_block + 2 * H

    def flops_per_token(self):
        """Training FLOPs/token (fwd+bwd ~ 6*N + attention term)."""
        H, L, S = self.hidden_size, self.num_layers, self.max_seq_len
        return 6 * self.num_params() + 12 * L * H * S


def gpt_tiny():
    return GPTConfig(vocab_size=512, hidden_size=64, num_layers=2,
                     num_heads=4, max_seq_len=128, dtype="float32",
                     use_flash=False, remat=False)


def gpt_345m():
    return GPTConfig(hidden_size=1024, num_layers=24, num_heads=16,
                     max_seq_len=1024)


def gpt3_1p3b():
    return GPTConfig(hidden_size=2048, num_layers=24, num_heads=32,
                     max_seq_len=2048)


def _check_slice(cfg):
    if cfg.moe_experts:
        raise NotImplementedError(
            "moe_experts > 0: the MoE FFN is not ported in this slice")
    if cfg.use_fused_ffn:
        raise NotImplementedError(
            "use_fused_ffn: the fused-FFN kernel is not ported in this slice")


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

def init_params(cfg: GPTConfig, generator, device=DEFAULT_DEVICE):
    """Parameter dict with the JAX package's key names and stacked ``[L]``
    block layout, drawn from the ``torch.Generator`` ``generator`` (on its
    own device) and placed on ``device``.  The same seed gives the same
    weights; they differ from ``jax.random``'s draw for any seed, so
    cross-package tests carry weights over with :func:`params_from_numpy`.
    """
    _check_slice(cfg)
    dev = resolve_device(device)
    H, L, F_ = cfg.hidden_size, cfg.num_layers, cfg.ffn_size
    pd = torch_dtype(cfg.param_dtype)
    std = cfg.initializer_range

    def nrm(shape, scale=std):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * scale
        return x.to(device=dev, dtype=pd)

    def full(shape, v):
        return torch.full(shape, v, dtype=pd, device=dev)

    res_std = std / math.sqrt(2.0 * L)
    wte = nrm((cfg.vocab_size, H))
    wpe = nrm((cfg.max_seq_len, H))
    blocks = {
        "ln1_g": full((L, H), 1.0), "ln1_b": full((L, H), 0.0),
        "qkv_w": nrm((L, H, 3, H)),
        "qkv_b": full((L, 3, H), 0.0),
        "proj_w": nrm((L, H, H), res_std),
        "proj_b": full((L, H), 0.0),
        "ln2_g": full((L, H), 1.0), "ln2_b": full((L, H), 0.0),
        "fc1_w": nrm((L, H, F_)),
        "fc1_b": full((L, F_), 0.0),
        "fc2_w": nrm((L, F_, H), res_std),
        "fc2_b": full((L, H), 0.0),
    }
    return {"wte": wte, "wpe": wpe, "blocks": blocks,
            "lnf_g": full((H,), 1.0), "lnf_b": full((H,), 0.0)}


def params_from_numpy(tree, device=DEFAULT_DEVICE, dtype=None):
    """Nested dict of numpy arrays (what ``paddle_tpu.models.gpt.
    save_params_npz`` writes, or ``np.asarray`` of a JAX param tree) ->
    the port's params on ``device``.  ``dtype`` (torch dtype or name) casts
    the floating leaves; default keeps each array's own dtype."""
    dev = resolve_device(device)
    td = None if dtype is None else torch_dtype(dtype)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        a = np.asarray(node)
        if not (a.flags.writeable and a.flags.c_contiguous):
            a = np.array(a, order="C")    # own, writable host memory
        t = torch.from_numpy(a)
        if td is not None and t.is_floating_point():
            t = t.to(td)
        return t.to(dev)
    return conv(tree)


def load_params_npz(path, device=DEFAULT_DEVICE):
    """Read an npz written by ``paddle_tpu.models.gpt.save_params_npz``
    ('/'-joined key paths) into the port's params on ``device``."""
    tree = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return params_from_numpy(tree, device)


def prepare_params(params, cfg: GPTConfig):
    """Serving view of ``params``: the block matmul weights and biases cast
    once to the compute dtype, plus ``wte_cd`` (the tied head in the
    compute dtype).  Eager PyTorch would otherwise cast the fp32 masters on
    every call; the cast is the same, so results are unchanged.  LayerNorm
    weights and the embedding tables stay in master precision, as the
    JAX forward reads them."""
    cd = torch_dtype(cfg.dtype)
    blocks = dict(params["blocks"])
    for k in _MATMUL_LEAVES:
        blocks[k] = _c(blocks[k], cd)
    out = dict(params)
    out["blocks"] = blocks
    out["wte_cd"] = _c(params["wte"], cd)
    return out


def layer(params, i):
    """Per-layer view (no leading ``[L]`` axis) of the stacked blocks."""
    return {k: v[i] for k, v in params["blocks"].items()}


def _c(w, dt):
    return w if w.dtype == dt else w.to(dt)


# --------------------------------------------------------------------------
# core math
# --------------------------------------------------------------------------

def _norm_fn(cfg):
    """The kernel wrapper with ``use_pallas_norm``, else the plain PyTorch
    LayerNorm (the same arithmetic as the reference's ``_layer_norm``)."""
    return _kernel_layer_norm if cfg.use_pallas_norm else _ref_layer_norm


def _attention(q, k, v, cfg):
    """Causal attention.  q, k, v: [B, N, nh, hd].  With ``cfg.use_flash``
    the flash-attention wrapper, else dense."""
    if cfg.use_flash:
        return flash_attention(q, k, v, True)
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    n = logits.shape[-1]
    mask = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits.float(), -1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def block_apply(cfg: GPTConfig, x, blk, attn_fn=None):
    """One transformer block.  x: [B, N, H]; blk: per-layer param dict.
    ``attn_fn(q, k, v) -> ([B, N, nh, hd], aux)`` swaps the attention inner
    loop (the cached and paged decoders pass one); default is dense causal
    attention with aux None."""
    _check_slice(cfg)
    cd = torch_dtype(cfg.dtype)
    B, N, H = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    ln = _norm_fn(cfg)
    eps = cfg.layer_norm_eps

    h = ln(x, blk["ln1_g"], blk["ln1_b"], eps)
    qkv = h @ _c(blk["qkv_w"], cd).reshape(H, 3 * H)
    qkv = qkv.reshape(B, N, 3, H) + _c(blk["qkv_b"], cd)
    q, k, v = [qkv[:, :, i].reshape(B, N, nh, hd) for i in range(3)]
    if attn_fn is None:
        a, aux = _attention(q, k, v, cfg), None
    else:
        a, aux = attn_fn(q, k, v)
    a = a.reshape(B, N, H)
    x = x + (a @ _c(blk["proj_w"], cd) + _c(blk["proj_b"], cd))

    h = ln(x, blk["ln2_g"], blk["ln2_b"], eps)
    h = F.gelu(h @ _c(blk["fc1_w"], cd) + _c(blk["fc1_b"], cd),
               approximate="tanh")
    h = h @ _c(blk["fc2_w"], cd) + _c(blk["fc2_b"], cd)
    x = x + h
    return x if attn_fn is None else (x, aux)


def embed(cfg: GPTConfig, params, tokens, pos_offset=0):
    cd = torch_dtype(cfg.dtype)
    N = tokens.shape[-1]
    pos = pos_offset + torch.arange(N, device=tokens.device)
    x = params["wte"][tokens.long()] + params["wpe"][pos]
    return x.to(cd)


def _head(cfg, params, x):
    """Final LayerNorm and the tied-embedding head: fp32 logits."""
    x = _norm_fn(cfg)(x, params["lnf_g"], params["lnf_b"],
                      cfg.layer_norm_eps)
    w = params.get("wte_cd")
    if w is None or w.dtype != x.dtype:
        w = _c(params["wte"], x.dtype)
    return (x @ w.T).float()


def _dots_policy(ctx, func, *args, **kwargs):
    """Save the weight matmuls' outputs (2-D products, no batch dims) and
    recompute the rest: ``dots_with_no_batch_dims_saveable``."""
    if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def run_blocks(cfg: GPTConfig, params, x):
    """Every block over x [B, N, H], each checkpointed per ``cfg.remat`` /
    ``cfg.remat_policy`` when gradients are on."""
    remat = cfg.remat and torch.is_grad_enabled()
    kw = {}
    if remat and cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    # one unbind per stacked leaf: its backward stacks the L gradients in
    # one copy, where L selects would each add a full [L, ...] gradient.
    # The matmul leaves are cast to the compute dtype here, once, not in
    # every block and again in every remat recompute.
    cd = torch_dtype(cfg.dtype)
    stacks = {k: (_c(v, cd) if k in _MATMUL_LEAVES else v).unbind(0)
              for k, v in params["blocks"].items()}
    for i in range(cfg.num_layers):
        blk = {k: s[i] for k, s in stacks.items()}
        if remat:
            x = checkpoint(block_apply, cfg, x, blk, use_reentrant=False,
                           **kw)
        else:
            x = block_apply(cfg, x, blk)
    return x


def forward(params, tokens, cfg: GPTConfig):
    """tokens [B, N] int -> logits [B, N, V] fp32."""
    x = run_blocks(cfg, params, embed(cfg, params, tokens))
    return _head(cfg, params, x)


def loss_fn(params, tokens, labels, cfg: GPTConfig):
    """Mean next-token cross entropy.  labels [B, N] int (-100 = ignore)."""
    logits = forward(params, tokens, cfg)
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).long()
    lse = torch.logsumexp(logits, -1)
    tgt = logits.gather(-1, safe[..., None])[..., 0]
    ce = torch.where(valid, lse - tgt, 0.0)
    return ce.sum() / valid.sum().clamp(min=1)


# --------------------------------------------------------------------------
# KV-cache decode
# --------------------------------------------------------------------------

def init_cache(cfg: GPTConfig, batch, max_len, dtype=None,
               device=DEFAULT_DEVICE):
    """Per-layer KV cache stacked on the layer axis:
    {'k','v': [L, B, max_len, nh, hd], 'len': int tokens filled}."""
    if max_len > cfg.max_seq_len:
        raise ValueError(
            f"cache max_len {max_len} exceeds cfg.max_seq_len "
            f"{cfg.max_seq_len}: positions past it have no positional "
            "embedding")
    dev = resolve_device(device)
    cd = torch_dtype(dtype or cfg.dtype)
    shape = (cfg.num_layers, batch, max_len, cfg.num_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cd, device=dev),
            "v": torch.zeros(shape, dtype=cd, device=dev), "len": 0}


def _cached_block(cfg, x, blk, k_cache, v_cache, cur_len):
    """block_apply with a cache-appending attention: this chunk's K/V are
    written (in place) at ``cur_len`` and queries attend the filled
    prefix.  x: [B, T, H]; k_cache/v_cache: [B, max_len, nh, hd]."""
    cd = torch_dtype(cfg.dtype)
    hd = cfg.head_dim
    max_len = k_cache.shape[1]

    def cached_attn(q, k, v):
        T = q.shape[1]
        k_cache[:, cur_len:cur_len + T] = k.to(k_cache.dtype)
        v_cache[:, cur_len:cur_len + T] = v.to(v_cache.dtype)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              k_cache.float()) / math.sqrt(hd)
        q_pos = cur_len + torch.arange(T, device=q.device)[:, None]
        k_pos = torch.arange(max_len, device=q.device)[None, :]
        mask = k_pos <= q_pos                   # causal + fill bound
        logits = logits.masked_fill(~mask[None, None], -1e30)
        probs = torch.softmax(logits, -1).to(cd)
        a = torch.einsum("bhqk,bkhd->bqhd", probs, v_cache.to(cd))
        return a, None

    x, _ = block_apply(cfg, x, blk, attn_fn=cached_attn)
    return x, k_cache, v_cache


def forward_cached(params, tokens, cfg: GPTConfig, cache):
    """Prefill/decode forward: consumes ``tokens`` [B, T] starting at
    ``cache['len']``, writes their K/V into ``cache`` in place, returns
    (logits [B, T, V] fp32, cache with the new ``len``)."""
    cur = int(cache["len"])
    max_len = cache["k"].shape[2]
    if cur + tokens.shape[1] > max_len:
        raise ValueError(
            f"cache overflow: len {cur} + {tokens.shape[1]} new tokens "
            f"> cache size {max_len}")
    x = embed(cfg, params, tokens, pos_offset=cur)
    for i in range(cfg.num_layers):
        x, _, _ = _cached_block(cfg, x, layer(params, i), cache["k"][i],
                                cache["v"][i], cur)
    logits = _head(cfg, params, x)
    return logits, {"k": cache["k"], "v": cache["v"],
                    "len": cur + tokens.shape[1]}


def generate(params, cfg: GPTConfig, prompt, max_new_tokens,
             temperature=0.0, top_k=0, generator=None):
    """Autoregressive decoding with a KV cache.  prompt: [B, T0] int tensor
    on the params' device.  Greedy when ``temperature == 0`` (the parity
    contract with the JAX ``generate``); otherwise temperature sampling,
    optionally top-k truncated, drawn from ``generator``.  Returns
    [B, T0 + max_new_tokens]; cut rows at eos with :func:`trim_eos`."""
    if max_new_tokens < 1:
        raise ValueError(
            f"max_new_tokens must be >= 1, got {max_new_tokens}")
    sampling = bool(temperature and temperature > 0)
    if sampling and generator is None:
        raise ValueError("sampling (temperature > 0) needs a torch.Generator")
    params = prepare_params(params, cfg)
    B, T0 = prompt.shape
    dev = params["wte"].device
    cache = init_cache(cfg, B, T0 + max_new_tokens, device=dev)
    logits, cache = forward_cached(params, prompt, cfg, cache)
    last = logits[:, -1]

    def sample(lg):
        if not sampling:
            return torch.argmax(lg, -1)
        lg = lg / temperature
        if top_k:
            kth = torch.sort(lg, -1).values[:, -top_k][:, None]
            lg = torch.where(lg >= kth, lg, torch.full_like(lg, -1e30))
        probs = torch.softmax(lg, -1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    toks = []
    for i in range(max_new_tokens):
        tok = sample(last).to(prompt.dtype)
        toks.append(tok)
        if i + 1 < max_new_tokens:
            lg, cache = forward_cached(params, tok[:, None], cfg, cache)
            last = lg[:, -1]
    return torch.cat([prompt, torch.stack(toks, 1)], 1)


def trim_eos(sequences, prompt_len, eos_token, include_eos=True):
    """Host-side early stop: cut each row of a :func:`generate` result at
    the first ``eos_token`` in the generated region.  Returns a list of
    1-D int numpy arrays."""
    if isinstance(sequences, torch.Tensor):
        sequences = sequences.cpu().numpy()
    out = []
    for row in np.asarray(sequences):
        gen = row[prompt_len:]
        hits = np.nonzero(gen == eos_token)[0]
        if hits.size:
            end = prompt_len + int(hits[0]) + (1 if include_eos else 0)
        else:
            end = row.shape[0]
        out.append(row[:end])
    return out


# --------------------------------------------------------------------------
# paged decode
# --------------------------------------------------------------------------

def init_paged_cache(cfg: GPTConfig, num_pages, page_size, dtype=None,
                     device=DEFAULT_DEVICE):
    """Paged KV pool: {'k','v': [L, num_pages, page_size, nh, hd]}.  Page 0
    is the scratch page (inactive lanes and padded prefill rows write
    there; nothing reads it as real content)."""
    dev = resolve_device(device)
    cd = torch_dtype(dtype or cfg.dtype)
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cd, device=dev),
            "v": torch.zeros(shape, dtype=cd, device=dev)}


def _paged_slot_block(cfg, x, blk, k_pages, v_pages, page_table,
                      write_pages, write_offs, lens):
    """block_apply for the page-table single-token decode: slot s's new K/V
    are written (in place) at (write_pages[s], write_offs[s]) and its query
    attends its pages through the paged-attention kernel.  x: [S, 1, H];
    k/v_pages: [P, ps, nh, hd]; page_table: int32 [S, maxP]."""
    def pattn(q, k, v):
        k_pages[write_pages, write_offs] = k[:, 0].to(k_pages.dtype)
        v_pages[write_pages, write_offs] = v[:, 0].to(v_pages.dtype)
        a = paged_attention(q.contiguous(), k_pages, v_pages, page_table,
                            lens)
        return a, None

    x, _ = block_apply(cfg, x, blk, attn_fn=pattn)
    return x, k_pages, v_pages


def decode_step_paged(params, tokens, cfg: GPTConfig, cache_k, cache_v,
                      page_table, write_pages, write_offs, lens):
    """One decode iteration for every slot through the paged pool: consume
    one token per slot (at its own ``lens[s]``), write its K/V into the
    pools in place, return (logits [S, V] fp32, cache_k, cache_v).
    page_table and lens are int32 (the kernel's operands); inactive slots
    point their writes and table rows at the scratch page."""
    wp, wo = write_pages.long(), write_offs.long()
    x = params["wte"][tokens.long()] + params["wpe"][lens.long()]
    x = x[:, None, :].to(torch_dtype(cfg.dtype))           # [S, 1, H]
    for i in range(cfg.num_layers):
        x, _, _ = _paged_slot_block(cfg, x, layer(params, i), cache_k[i],
                                    cache_v[i], page_table, wp, wo, lens)
    logits = _head(cfg, params, x)
    return logits[:, 0], cache_k, cache_v
