"""Transformer layers (counterpart of
``paddle_tpu/nn/layer/transformer.py``: ``MultiHeadAttention`` with its
caches, the encoder and decoder layers and stacks, ``Transformer``).

``MultiHeadAttention`` takes ``F.flash_attention`` (the CUDA flash
kernels on the card) when there is no mask, no weights output and no
attention dropout (eval, or dropout 0); otherwise the dense
``F.scaled_dot_product_attention``.  So a decoder's self-attention under
``tgt_mask`` and a source under ``src_mask`` are dense; the unmasked
encoder, the cross-attention without ``memory_mask`` and every cached
decode step (no mask) take the kernels.  Layout [B, N, nh, hd], as the
reference's.

``gen_cache`` makes the reference's caches: ``Cache`` (incremental
self-attention k and v, starting at length 0 in the default dtype, so a
bf16 decode's first ``concat`` promotes them to float32 as jnp does) and
``StaticCache`` (the cross-attention's projected memory).
"""
from __future__ import annotations

import collections
import copy

import torch

from ...framework import core
from ...ops.dispatch import call
from ...tensor import manipulation as manip
from ...tensor.creation import zeros
from ...tensor.tensor import Tensor
from .. import functional as F
from .common import Dropout, Linear
from .container import LayerList
from .layers import Layer
from .norm import LayerNorm


def _convert_attention_mask(attn_mask, dtype):
    """A bool mask (True = attend) -> an additive mask in ``dtype``."""
    if attn_mask is None:
        return None
    if attn_mask.dtype == torch.bool:
        return call(lambda m: torch.where(m, 0.0, -1e9).to(dtype), attn_mask)
    return attn_mask.astype(dtype)


class MultiHeadAttention(Layer):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _prepare_qkv(self, query, key, value, cache=None):
        q = self.q_proj(query)
        B = q.shape[0]
        q = manip.reshape(q, [B, -1, self.num_heads, self.head_dim])
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = manip.reshape(self.k_proj(key),
                              [B, -1, self.num_heads, self.head_dim])
            v = manip.reshape(self.v_proj(value),
                              [B, -1, self.num_heads, self.head_dim])
        if isinstance(cache, self.Cache):
            k = manip.concat([cache.k, k], axis=1)
            v = manip.concat([cache.v, v], axis=1)
            cache = self.Cache(k, v)
        return q, k, v, cache

    def gen_cache(self, key, value=None, type=None):
        """``StaticCache``: key and value (default: key) projected and
        split into heads; otherwise an empty ``Cache`` [B, 0, nh, hd] in
        the default dtype."""
        B = key.shape[0]
        if type == MultiHeadAttention.StaticCache:
            k = self.k_proj(key)
            v = self.v_proj(value if value is not None else key)
            return self.StaticCache(
                manip.reshape(k, [B, -1, self.num_heads, self.head_dim]),
                manip.reshape(v, [B, -1, self.num_heads, self.head_dim]))
        shape = [B, 0, self.num_heads, self.head_dim]
        return self.Cache(zeros(shape), zeros(shape))

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value
        q, k, v, cache = self._prepare_qkv(query, key, value, cache)
        mask = _convert_attention_mask(attn_mask, q.dtype)
        # the reference drops entries of the softmax weights; the flash
        # kernel has no dropout, so attention dropout takes the dense path
        attn_do = self.dropout if self.training else 0.0
        if self.need_weights or mask is not None or attn_do > 0:
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, dropout_p=attn_do,
                training=self.training)
        else:
            out = F.flash_attention(q, k, v)
        out = self.out_proj(manip.reshape(out, [out.shape[0], -1,
                                                self.embed_dim]))
        outs = [out]
        if self.need_weights:
            outs.append(None)
        if cache is not None:
            outs.append(cache)
        return out if len(outs) == 1 else tuple(outs)


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr, bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr, bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            out = self.self_attn(src, src, src, src_mask)
        else:
            out, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(out)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [encoder_layer if i == 0 else _clone_layer(encoder_layer)
             for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, c = mod(output, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr, bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr, bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        """``cache``: (incremental ``Cache``, ``StaticCache``), as
        :meth:`gen_cache` makes it; returns (out, (new Cache,
        StaticCache)) then."""
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt2 = self.self_attn(tgt, tgt, tgt, tgt_mask)
            static_cache = None
        else:
            tgt2, incr = self.self_attn(tgt, tgt, tgt, tgt_mask, cache[0])
            static_cache = cache[1]
        tgt = residual + self.dropout1(tgt2)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if static_cache is not None:
            tgt2 = self.cross_attn(tgt, memory, memory, memory_mask,
                                   static_cache)
            if isinstance(tgt2, tuple):
                tgt2 = tgt2[0]
        else:
            tgt2 = self.cross_attn(tgt, memory, memory, memory_mask)
        tgt = residual + self.dropout2(tgt2)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt2 = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt2)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incr, static_cache))

    def gen_cache(self, memory):
        incremental = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(
            memory, memory, MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [decoder_layer if i == 0 else _clone_layer(decoder_layer)
             for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, c = mod(output, memory, tgt_mask, memory_mask,
                                cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        """One (Cache, StaticCache) a layer; ``do_zip``: the reference's
        transposed form, (all Caches), (all StaticCaches)."""
        cache = [layer.gen_cache(memory) for layer in self.layers]
        return list(zip(*cache)) if do_zip else cache


def _clone_layer(layer):
    """A freshly initialised layer of the same architecture, as the
    reference builds it: an encoder or decoder layer's clone keeps
    d_model, nhead, dim_feedforward, dropout, activation and
    normalize_before, and drops ``weight_attr``, ``bias_attr``,
    ``attn_dropout`` and ``act_dropout`` (so its attention dropout is
    ``dropout``).  Weights therefore cross by ``set_state_dict``."""
    if isinstance(layer, (TransformerEncoderLayer, TransformerDecoderLayer)):
        return type(layer)(layer.linear1._in_features, layer.self_attn.num_heads,
                           layer.linear1._out_features,
                           dropout=layer.dropout1.p,
                           activation=layer.activation.__name__,
                           normalize_before=layer.normalize_before)
    return copy.deepcopy(layer)


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            self.encoder = TransformerEncoder(
                enc_layer, num_encoder_layers,
                LayerNorm(d_model) if normalize_before else None)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            self.decoder = TransformerDecoder(
                dec_layer, num_decoder_layers,
                LayerNorm(d_model) if normalize_before else None)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    def generate_square_subsequent_mask(self, length):
        """[length, length] float32: 0 on and below the diagonal, -inf
        above it."""
        keep = torch.ones((length, length), dtype=torch.bool).tril()
        return Tensor(torch.where(keep, 0.0, float("-inf")).to(
            core.get_place().device))
