"""Single-device GPT train step: the dp = tp = pp = sp = 1 case of
``paddle_tpu/models/gpt_hybrid.py``.

The reference runs one SPMD program over a ('dp', 'pp', 'tp', 'sp') mesh.
On one card every collective of that program is the identity, so what is
left is the step itself: embed, the blocks (flash attention, its split or
fused backward per ``flash_attn.set_default_blocks``, the fused FFN and
LayerNorm through the port's kernels per ``cfg``, remat per
``cfg.remat``), the final LayerNorm, the tied-head cross entropy
(optionally chunked over the sequence, each chunk rematerialized), the
global-norm clip and a fused AdamW whose math runs in fp32 over params and
moments stored in their own dtypes (fp32 masters, or the reference bench's
bf16 params with bf16 moments).

The blocks are ``gpt.block_apply``'s, which honours ``use_fused_ffn`` and
``use_pallas_norm`` as the reference's ``gpt.forward`` does; the
reference's ``_sharded_block`` computes the FFN and the LayerNorms with
the plain composition whatever those flags say.  The function is the
same; only the route differs.

Mesh axes above 1 (``dp``/``tp``/``pp``/``sp``) and ``n_microbatch != 1``
(the pipeline's microbatches) are refused by name; each is a
``ROADMAP.md`` item.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

# the tree walk is shared with models/bert.py; tests and chip_smoke.py
# reach it through this module too
from .common import (_at, _build, _leaves, adamw_step,  # noqa: F401
                     value_and_grad)
from .gpt import GPTConfig, _check_slice, _norm_fn, embed, run_blocks

# AdamW decay exclusions for the gpt param tree (the reference's one
# definition, gpt_hybrid.py:51-54)
NO_DECAY = frozenset({"wpe", "lnf_g", "lnf_b"})
LN_NAMES = frozenset({"ln1_g", "ln1_b", "ln2_g", "ln2_b",
                      "proj_b", "qkv_b", "fc1_b", "fc2_b",
                      "moe_b1", "moe_b2"})


def _check_single_device(dp, tp, pp, sp, n_microbatch):
    sizes = {"dp": dp, "tp": tp, "pp": pp, "sp": sp}
    big = {k: n for k, n in sizes.items() if n != 1}
    if big:
        raise NotImplementedError(
            f"mesh axes {big}: the port's train step is single-device; "
            "multi-GPU training is ROADMAP.md Queue 1, multi-GPU training")
    if n_microbatch != 1:
        raise NotImplementedError(
            f"n_microbatch={n_microbatch}: pipeline microbatches need pp > 1,"
            " which is ROADMAP.md Queue 1, multi-GPU training")


def init_train_state(params, moment_dtype=torch.float32):
    """Zero AdamW moments ``(m, v)`` shaped like ``params``, on the params'
    device: the single-device counterpart of ``init_sharded``.  With
    ``moment_dtype=torch.bfloat16`` the moments are stored in bf16 and the
    update math still runs in fp32."""
    paths, vals = zip(*_leaves(params))

    def zeros():
        return _build(paths, [torch.zeros(p.shape, dtype=moment_dtype,
                                          device=p.device) for p in vals])
    return zeros(), zeros()


def _fwd_loss(cfg: GPTConfig, params, tokens, labels, xent_chunks=1):
    """Mean cross entropy of the tied head over labels >= 0, as the
    reference's ``_fwd_loss`` computes it at tp = 1: a max shift held
    constant for autodiff, fp32 logits."""
    _check_slice(cfg)
    x = run_blocks(cfg, params, embed(cfg, params, tokens))
    x = _norm_fn(cfg)(x, params["lnf_g"], params["lnf_b"],
                      cfg.layer_norm_eps)
    wte = params["wte"]
    V = wte.shape[0]

    def ce_of(xc, lc):
        logits = (xc @ wte.to(xc.dtype).T).float()
        m = logits.detach().amax(-1)
        z = torch.exp(logits - m[..., None]).sum(-1)
        ok = (lc >= 0) & (lc < V)
        tgt = logits.gather(-1, lc.clamp(0, V - 1).long()[..., None])[..., 0]
        ce = torch.log(z) + m - torch.where(ok, tgt, 0.0)
        valid = (lc >= 0).float()
        return (ce * valid).sum(), valid.sum()

    if xent_chunks > 1:
        # only one chunk's [B, C, V] fp32 logits live at a time, forward
        # and backward, for one more vocab matmul per chunk
        N = labels.shape[1]
        if N % xent_chunks:
            raise ValueError(f"sequence {N} must divide by xent_chunks "
                             f"{xent_chunks}")
        C = N // xent_chunks
        total = count = 0.0
        for i in range(xent_chunks):
            xc, lc = x[:, i * C:(i + 1) * C], labels[:, i * C:(i + 1) * C]
            if torch.is_grad_enabled():
                t, c = checkpoint(ce_of, xc, lc, use_reentrant=False)
            else:
                t, c = ce_of(xc, lc)
            total, count = total + t, count + c
    else:
        total, count = ce_of(x, labels)
    return total / torch.clamp(count, min=1.0)


def loss_and_grads(params, tokens, labels, cfg: GPTConfig, xent_chunks=1):
    """(loss, grads): the 0-d loss tensor of the train step's forward and
    the gradients of every param leaf, in a tree shaped like ``params``.
    ``params`` is left untouched."""
    return value_and_grad(
        lambda p: _fwd_loss(cfg, p, tokens, labels, xent_chunks), params)


def _decays(path):
    leaf = path[-1]
    return leaf not in NO_DECAY and leaf not in LN_NAMES


def make_train_step(cfg: GPTConfig, *, n_microbatch=1, beta1=0.9,
                    beta2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=1.0,
                    xent_chunks=1, dp=1, tp=1, pp=1, sp=1):
    """Returns ``step(params, m, v, t, tokens, labels, lr) -> (params, m, v,
    loss)``.  tokens/labels: [B, N] int on the params' device; t: 1-based
    step count and lr: the learning rate, each a number or a tensor; loss:
    a 0-d tensor.

    ``params``, ``m`` and ``v`` are updated in place and returned, which
    takes the place of the reference's ``donate_argnums=(0, 1, 2)``.  The
    step makes no host sync: the clip and AdamW are tensor ops.
    ``xent_chunks > 1`` chunks the vocab projection and cross entropy over
    the sequence (each chunk rematerialized) to cap logits memory."""
    _check_single_device(dp, tp, pp, sp, n_microbatch)
    _check_slice(cfg)

    def step(params, m, v, t, tokens, labels, lr):
        loss, grads = loss_and_grads(params, tokens, labels, cfg,
                                     xent_chunks)
        adamw_step(params, grads, m, v, t, lr, beta1, beta2, eps,
                   weight_decay, clip_norm, _decays)
        return params, m, v, loss

    return step

