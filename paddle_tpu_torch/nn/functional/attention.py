"""Attention functionals (counterpart of
``paddle_tpu/nn/functional/attention.py``).

``flash_attention`` goes to ``ops.cuda.flash_attn.flash_attention``: the
CUDA flash kernels for CUDA tensors, the plain ``_ref_attention`` for CPU
tensors.  Operands of different dtypes (a bf16 query against the float32
caches ``MultiHeadAttention.gen_cache`` makes) are promoted to one dtype
first, as jnp promotes them, so the kernels run in the promoted dtype and
the output has it, the reference's output dtype.  The reference rounds
the probabilities to the query's dtype before p.V; the promoted call
keeps them in the promoted dtype.  ``scaled_dot_product_attention`` is the plain :func:`_sdpa_ref`
(masks, dropout), as in the reference.  Layout [B, N, nh, hd].
"""
from __future__ import annotations

import math

import torch

from ...ops.cuda import flash_attn
from ...ops.dispatch import call
from .common import _mask


def _sdpa_ref(q, k, v, mask=None, scale=None, causal=False, dropout_p=0.0):
    """Dense attention over q, k, v [B, N, nh, hd], the reference's
    ``_sdpa_ref`` op for op: logits in q's dtype, an additive mask, fp32
    softmax cast to q's dtype, dropout on the probabilities."""
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    logits = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * s
    if causal:
        n, m = logits.shape[-2], logits.shape[-1]
        cmask = torch.ones((n, m), dtype=torch.bool,
                           device=q.device).tril(m - n)
        logits = torch.where(cmask, logits, -1e30)
    if mask is not None:
        logits = logits + mask
    probs = torch.softmax(logits.float(), -1).to(q.dtype)
    if dropout_p:
        keep = 1.0 - dropout_p
        probs = torch.where(_mask(probs.shape, keep, probs.device),
                            probs / keep, 0.0).to(probs.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vh)
    return out.transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    p = dropout_p if training else 0.0
    if attn_mask is not None:
        return call(lambda q, k, v, m: _sdpa_ref(q, k, v, m, causal=is_causal,
                                                 dropout_p=p),
                    query, key, value, attn_mask, _name="sdpa")
    return call(lambda q, k, v: _sdpa_ref(q, k, v, None, causal=is_causal,
                                          dropout_p=p),
                query, key, value, _name="sdpa")


def _promoted(q, k, v):
    dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    return q.to(dt), k.to(dt), v.to(dt)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, name=None):
    out = call(lambda q, k, v: flash_attn.flash_attention(
        *_promoted(q, k, v), causal), query, key, value,
        _name="flash_attention")
    if return_softmax:
        return out, None
    return out
