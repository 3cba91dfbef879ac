"""The port's sequence-to-sequence path against the JAX package's, on the
CPU: ``nn.Transformer`` (forward and every gradient, with and without
each mask, pre- and post-LN), its incremental decode through
``gen_cache`` (also in bf16, where the float32 caches promote k and v),
``BeamSearchDecoder`` + ``dynamic_decode`` token-exact with parents and
lengths (a GRU cell, a Transformer cell, beams that tie) and the RNN
layers with ragged ``sequence_length``.

Weights cross from the reference's ``state_dict()`` as numpy arrays;
inputs are drawn from numpy seeds.  Tolerances: fp32 1e-5 of max|ref|
(gradients of the RNNs' 12-step recurrences 1e-4); bf16 two rounding
steps of max|ref| (the reference rounds the first self-attention's
probabilities to the query's bf16, the port's promoted call keeps them
in float32).  Beams: tokens, parents and lengths exact.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as pt
from paddle_tpu_torch.framework import core
from tools import seq2seq

TOL = 1e-5
RNN_GRAD_TOL = 1e-4
BF16_TOL = 2.0 ** -6


@pytest.fixture(autouse=True)
def _cpu():
    prev = core._state.expected_place
    pt.set_device("cpu")
    yield
    core._state.expected_place = prev


def _np(t):
    return np.asarray(t.astype("float32").numpy())


def _close(got, ref, tol=TOL, what=""):
    g, r = _np(got), _np(ref)
    assert g.shape == r.shape, (what, g.shape, r.shape)
    np.testing.assert_allclose(g, r, rtol=0,
                               atol=tol * max(float(np.abs(r).max()), 1e-30),
                               err_msg=what)


def carry(ref, port):
    """The reference layer's weights into the port's; the key sets must
    be equal."""
    sd = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    assert set(sd) == set(port.state_dict())
    port.set_state_dict(sd)
    return sd


def _grads(mod, loss, named):
    gs = mod.grad([loss], [t for _, t in named], allow_unused=True)
    return {n: g for (n, _), g in zip(named, gs)}


def _close_grads(got, ref, tol=TOL):
    """Every gradient within ``tol`` of the largest |ref gradient| (some
    are zero up to rounding, as a key projection's bias)."""
    assert set(got) == set(ref)
    scale = max(float(np.abs(_np(g)).max()) for g in ref.values())
    for n in ref:
        g, r = _np(got[n]), _np(ref[n])
        assert g.shape == r.shape, n
        np.testing.assert_allclose(g, r, rtol=0, atol=tol * scale,
                                   err_msg=n)


# --------------------------------------------------------------------------
# nn.Transformer
# --------------------------------------------------------------------------

D, NH, FF, NS, NT, B = 32, 4, 64, 7, 5, 3


def transformer(mod, normalize_before, dropout=0.0):
    return mod.nn.Transformer(D, NH, 2, 2, FF, dropout=dropout,
                              normalize_before=normalize_before)


def _masks(mod, kind, model):
    if kind == "none":
        return None, None, None
    rng = np.random.RandomState(3)
    src = np.where(rng.rand(B, 1, 1, NS) > 0.2, 0.0, -1e9).astype(np.float32)
    mem = np.where(rng.rand(B, 1, NT, NS) > 0.2, 0.0, -1e9).astype(
        np.float32)
    tgt = model.generate_square_subsequent_mask(NT)
    if kind == "tgt":
        return None, tgt, None
    return mod.to_tensor(src), tgt, mod.to_tensor(mem)


@pytest.mark.parametrize("normalize_before", [False, True],
                         ids=["post_ln", "pre_ln"])
@pytest.mark.parametrize("masks", ["none", "tgt", "all"])
def test_transformer_forward_and_gradients_match_reference(normalize_before,
                                                           masks):
    rng = np.random.RandomState(1)
    src = rng.standard_normal((B, NS, D)).astype(np.float32)
    tgt = rng.standard_normal((B, NT, D)).astype(np.float32)
    w = rng.standard_normal((B, NT, D)).astype(np.float32)
    res = {}
    for mod in (P, pt):
        P.seed(0)
        model = transformer(mod, normalize_before)
        if mod is P:
            ref_model = model
        else:
            carry(ref_model, model)
        s = mod.to_tensor(src, stop_gradient=False)
        t = mod.to_tensor(tgt, stop_gradient=False)
        out = model(s, t, *_masks(mod, masks, model))
        loss = (out * mod.to_tensor(w)).sum()
        named = [("src", s), ("tgt", t)] + list(model.named_parameters())
        res[mod] = (out, loss, _grads(mod, loss, named))
    (ro, rl, rg), (go, gl, gg) = res[P], res[pt]
    _close(go, ro, what="out")
    _close(gl, rl, what="loss")
    _close_grads(gg, rg)


def _decode_models(normalize_before=False):
    P.seed(0)
    ref = transformer(P, normalize_before)
    port = transformer(pt, normalize_before)
    carry(ref, port)
    ref.eval()
    port.eval()
    return ref, port


def _incremental(mod, model, src, tgt):
    """The decoder one step at a time over gen_cache: the step outputs."""
    with mod.no_grad():
        memory = model.encoder(mod.to_tensor(src))
        cache = model.decoder.gen_cache(memory)
        outs = []
        for t in range(tgt.shape[1]):
            o, cache = model.decoder(mod.to_tensor(tgt[:, t:t + 1]), memory,
                                     None, None, cache)
            outs.append(o)
    return outs, cache


@pytest.mark.parametrize("normalize_before", [False, True],
                         ids=["post_ln", "pre_ln"])
def test_incremental_decode_matches_reference_and_full_forward(
        normalize_before):
    ref, port = _decode_models(normalize_before)
    rng = np.random.RandomState(2)
    src = rng.standard_normal((B, NS, D)).astype(np.float32)
    tgt = rng.standard_normal((B, NT, D)).astype(np.float32)
    r_outs, r_cache = _incremental(P, ref, src, tgt)
    g_outs, g_cache = _incremental(pt, port, src, tgt)
    for t, (g, r) in enumerate(zip(g_outs, r_outs)):
        _close(g, r, what=f"step {t}")
    # the caches: (Cache(k, v), StaticCache(k, v)) a layer
    for (gi, gs), (ri, rs) in zip(g_cache, r_cache):
        assert type(gi).__name__ == "Cache"
        assert type(gs).__name__ == "StaticCache"
        assert list(gi.k.shape) == [B, NT, NH, D // NH]
        for a, b in ((gi.k, ri.k), (gi.v, ri.v), (gs.k, rs.k)):
            _close(a, b)
    with pt.no_grad():
        full = port(pt.to_tensor(src), pt.to_tensor(tgt), None,
                    port.generate_square_subsequent_mask(NT))
    for t in range(NT):
        _close(g_outs[t], full[:, t:t + 1], what=f"row {t}")
    zipped = port.decoder.gen_cache(port.encoder(pt.to_tensor(src)), True)
    assert len(zipped) == 2 and len(zipped[0]) == 2


def test_bf16_decode_promotes_like_reference():
    """bf16 weights and input against float32 caches: the first concat
    promotes k and v; the flash call promotes q to match, so the output
    is float32 as in the reference."""
    ref, port = _decode_models()
    ref.to(dtype="bfloat16")
    port.to(dtype="bfloat16")
    rng = np.random.RandomState(4)
    src = rng.standard_normal((B, NS, D)).astype(np.float32)
    tgt = rng.standard_normal((B, 3, D)).astype(np.float32)
    outs = {}
    for mod, model in ((P, ref), (pt, port)):
        with mod.no_grad():
            memory = model.encoder(mod.to_tensor(src).astype("bfloat16"))
            cache = model.decoder.gen_cache(memory)
            assert core.dtype_name(cache[0][0].k.dtype) == "float32"
            steps = []
            for t in range(3):
                o, cache = model.decoder(
                    mod.to_tensor(tgt[:, t:t + 1]).astype("bfloat16"),
                    memory, None, None, cache)
                steps.append(o)
        outs[mod] = (memory, steps)
    (rm, rs), (gm, gs) = outs[P], outs[pt]
    assert str(gm.dtype).replace("torch.", "") == str(rm.dtype)
    _close(gm, rm, BF16_TOL)
    for g, r in zip(gs, rs):
        assert str(g.dtype).replace("torch.", "") == str(r.dtype) == \
            "float32"
        _close(g, r, BF16_TOL)


@pytest.mark.parametrize("nq,nk", [(3, 6), (1, 33), (24, 40)])
def test_flash_functional_promotes_mixed_dtypes(nq, nk):
    """A bf16 query against float32 k and v: float32 out, as the
    reference's.  The reference rounds the probabilities to the query's
    bf16 before p . v and the port's fp32 kernel does not, so the two
    differ by one rounding of each p_j: within bf16's unit roundoff 2^-8
    of sum_j p_j |v_j| (ROADMAP Queue 3)."""
    from paddle_tpu_torch.ops.cuda import flash_attn
    rng = np.random.RandomState(5 + nk)
    q = rng.standard_normal((2, nq, 2, 8)).astype(np.float32)
    k = rng.standard_normal((2, nk, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, nk, 2, 8)).astype(np.float32)
    got = pt.nn.functional.flash_attention(
        pt.to_tensor(q).astype("bfloat16"), pt.to_tensor(k),
        pt.to_tensor(v))
    ref = P.nn.functional.flash_attention(
        P.to_tensor(q).astype("bfloat16"), P.to_tensor(k), P.to_tensor(v))
    assert core.dtype_name(got.dtype) == str(ref.dtype) == "float32"
    qb = torch.tensor(q).bfloat16().float()
    pv = flash_attn._ref_flash_fwd(qb, torch.tensor(k),
                                   torch.tensor(np.abs(v)), False)[0]
    np.testing.assert_array_less(np.abs(_np(got) - _np(ref)),
                                 2.0 ** -8 * pv.numpy() + 1e-7)


def test_clone_layer_keeps_the_reference_quirk_for_the_decoder():
    layer = pt.nn.TransformerDecoderLayer(D, NH, FF, dropout=0.3,
                                          attn_dropout=0.0, act_dropout=0.0)
    dec = pt.nn.TransformerDecoder(layer, 3)
    assert dec.layers[0].self_attn.dropout == 0.0
    for lay in list(dec.layers)[1:]:
        assert lay.self_attn.dropout == lay.cross_attn.dropout == 0.3
        assert lay.dropout.p == 0.3
        assert lay is not layer
    ref = P.nn.TransformerDecoder(P.nn.TransformerDecoderLayer(
        D, NH, FF, dropout=0.3, attn_dropout=0.0, act_dropout=0.0), 3)
    assert set(ref.state_dict()) == set(dec.state_dict())


# --------------------------------------------------------------------------
# BeamSearchDecoder + dynamic_decode
# --------------------------------------------------------------------------

V, H, BEAM = 11, 16, 4


def _beam_run(mod, cell, inits, embedding_fn, steps, beam=BEAM, end=2,
              **kw):
    dec = mod.nn.BeamSearchDecoder(cell, start_token=1, end_token=end,
                                   beam_size=beam, embedding_fn=embedding_fn)
    with mod.no_grad():
        out, states, lengths = mod.nn.dynamic_decode(
            dec, inits=inits, max_step_num=steps, return_length=True, **kw)
    parents = mod.stack(dec._parents, 0)
    return out, states, lengths, parents


def _beam_equal(got, ref):
    (go, gst, gl, gp), (ro, rst, rl, rp) = got, ref
    for g, r, what in ((go, ro, "tokens"), (gp, rp, "parents"),
                       (gl, rl, "lengths")):
        assert core.dtype_name(g.dtype) == str(r.dtype), (what, g.dtype,
                                                          r.dtype)
        np.testing.assert_array_equal(g.numpy(), r.numpy(), err_msg=what)
    _close(gst[1], rst[1], what="log_probs")
    np.testing.assert_array_equal(gst[2].numpy(), rst[2].numpy())


def _gru_cell(mod):
    class DecCell(mod.nn.Layer):
        def __init__(self):
            super().__init__()
            self.cell = mod.nn.GRUCell(H, H)
            self.proj = mod.nn.Linear(H, V)

        def forward(self, x, state):
            o, s = self.cell(x, state)
            return self.proj(o), s
    return DecCell()


@pytest.mark.parametrize("time_major", [False, True])
def test_beam_search_gru_cell_token_exact(time_major):
    nets = {}
    for mod in (P, pt):
        P.seed(1)
        nets[mod] = (_gru_cell(mod), mod.nn.Embedding(V, H))
    carry(nets[P][0], nets[pt][0])
    carry(nets[P][1], nets[pt][1])
    h0 = np.random.RandomState(6).standard_normal((3, H)).astype(np.float32)
    res = {mod: _beam_run(mod, cell, mod.to_tensor(h0), emb, 9,
                          output_time_major=time_major)
           for mod, (cell, emb) in nets.items()}
    _beam_equal(res[pt], res[P])
    shape = [9, 3, BEAM] if time_major else [3, 9, BEAM]
    assert list(res[pt][0].shape) == shape


def test_beam_search_transformer_cell_token_exact():
    """``tools/seq2seq.py``'s NMT Transformer (shared embeddings scaled
    by sqrt(d) plus sinusoidal positions, tied output) decoded through
    its flat-state cell; every step's cache length is a new shape for
    the reference's eager ops, so the decode is kept short."""
    src = np.random.RandomState(7).randint(0, V, (2, NS))
    res, models = {}, {}
    for mod in (P, pt):
        P.seed(2)
        models[mod] = seq2seq.nmt_transformer(mod, V, D, NH, 2, FF, 0.0, 64)
    carry(models[P], models[pt])
    for mod, model in models.items():
        model.eval()
        cell = seq2seq.TransformerCell(mod, model.transformer.decoder,
                                       model.embed, model.project)
        with mod.no_grad():
            init = cell.initial(model.encode(mod.to_tensor(src)))
        res[mod] = _beam_run(mod, cell, init, None, 5)
    _beam_equal(res[pt], res[P])


def test_rnn_seq2seq_loss_and_beam_match_reference():
    """``tools/seq2seq.py``'s LSTM encoder-decoder: the masked loss over
    ragged targets, every gradient, and a beam decode token-exact."""
    rng = np.random.RandomState(13)
    src = rng.randint(0, 13, (3, 7))
    src_len = np.array([7, 3, 5], np.int64)
    tgt = rng.randint(0, V, (3, 6))
    tgt_len = np.array([5, 2, 4], np.int64)
    models, res = {}, {}
    for mod in (P, pt):
        P.seed(4)
        models[mod] = seq2seq.rnn_seq2seq(mod, 13, V, H, 2, 0.0)
    carry(models[P], models[pt])
    for mod, model in models.items():
        logits = model(mod.to_tensor(src), mod.to_tensor(src_len),
                       mod.to_tensor(tgt[:, :-1]))
        loss = seq2seq.masked_ce(mod, logits, mod.to_tensor(tgt[:, 1:]),
                                 mod.to_tensor(tgt_len))
        grads = _grads(mod, loss, list(model.named_parameters()))
        model.eval()
        with mod.no_grad():
            init = model.encode(mod.to_tensor(src), mod.to_tensor(src_len))
        res[mod] = (loss, grads, _beam_run(mod, seq2seq.RNNCell(model), init,
                                           None, 5, beam=5))
    _close(res[pt][0], res[P][0])
    _close_grads(res[pt][1], res[P][1], RNN_GRAD_TOL)
    _beam_equal(res[pt][2], res[P][2])


def _rigged_cell(mod, table):
    """Logits that depend on the input token only (``table[token]``)."""
    class Rigged(mod.nn.Layer):
        def forward(self, tok, state):
            t = mod.to_tensor(table)
            return mod.gather(t, mod.reshape(tok, [-1])), state
    return Rigged()


def test_beam_search_ties_break_lowest_index_first():
    """Tokens 3 and 4 have equal logits and equal continuations, so their
    beams score equally and finish together; with 6 beams over 5 tokens
    the first step also fills slots with the start beams' tied -1e9
    candidates.  The stable order keeps the reference's choices."""
    table = np.full((5, 5), -3.0, np.float32)
    table[1] = [-4.0, -1.0, -5.0, -0.5, -0.5]     # from start
    table[3] = table[4] = [-3.0, -2.0, -0.2, -3.0, -3.0]
    table[0] = [-0.1, -2.0, -2.5, -2.0, -2.0]
    table[2] = [-3.0, -3.0, 0.0, -3.0, -3.0]      # end stays end
    res = {}
    for mod in (P, pt):
        h0 = mod.to_tensor(np.zeros((2, 1), np.float32))
        res[mod] = _beam_run(mod, _rigged_cell(mod, table), h0, None, 6,
                             beam=6)
    _beam_equal(res[pt], res[P])
    lp = res[pt][1][1].numpy()
    assert (lp[:, :-1] >= lp[:, 1:]).all()
    assert (lp == lp[:, :1]).sum() >= 2 or (np.diff(lp, axis=1) == 0).any()


def test_gather_tree_matches_reference():
    rng = np.random.RandomState(8)
    ids = rng.randint(0, 9, (6, 3, 4)).astype(np.int32)
    parents = rng.randint(0, 4, (6, 3, 4)).astype(np.int32)
    got = pt.nn.functional.gather_tree(pt.to_tensor(ids),
                                       pt.to_tensor(parents))
    ref = P.nn.functional.gather_tree(P.to_tensor(ids), P.to_tensor(parents))
    assert core.dtype_name(got.dtype) == str(ref.dtype)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


# --------------------------------------------------------------------------
# RNN layers
# --------------------------------------------------------------------------

RB, RT, RI, RH = 4, 12, 6, 8
LENS = np.array([12, 5, 9, 1], np.int64)


def _rnn_case(mode, direction, time_major=False):
    rng = np.random.RandomState(9)
    d = 2 if direction == "bidirect" else 1
    x = rng.standard_normal((RT, RB, RI) if time_major else (RB, RT, RI))
    h0 = rng.standard_normal((2 * d, RB, RH)).astype(np.float32)
    c0 = rng.standard_normal((2 * d, RB, RH)).astype(np.float32)
    w = rng.standard_normal(x.shape[:2] + (RH * d,)).astype(np.float32)
    res = {}
    for mod in (P, pt):
        P.seed(3)
        net = getattr(mod.nn, mode)(RI, RH, num_layers=2,
                                    direction=direction,
                                    time_major=time_major)
        if mod is P:
            ref_net = net
        else:
            carry(ref_net, net)
        xs = mod.to_tensor(x.astype(np.float32), stop_gradient=False)
        hs = mod.to_tensor(h0, stop_gradient=False)
        init = hs
        named = [("x", xs), ("h0", hs)]
        if mode == "LSTM":
            cs = mod.to_tensor(c0, stop_gradient=False)
            init = (hs, cs)
            named.append(("c0", cs))
        out, final = net(xs, init, mod.to_tensor(LENS))
        finals = list(final) if mode == "LSTM" else [final]
        loss = (out * mod.to_tensor(w)).sum()
        for k, f in enumerate(finals):
            loss = loss + f.sum() * (k + 2)
        named += list(net.named_parameters())
        res[mod] = (out, finals, _grads(mod, loss, named))
    return res


@pytest.mark.parametrize("direction", ["forward", "bidirect", "backward"])
@pytest.mark.parametrize("mode", ["SimpleRNN", "LSTM", "GRU"])
def test_rnn_layers_ragged_match_reference(mode, direction):
    res = _rnn_case(mode, direction)
    (ro, rf, rg), (go, gf, gg) = res[P], res[pt]
    _close(go, ro, what="out")
    for g, r in zip(gf, rf):
        assert list(g.shape) == list(r.shape)
        _close(g, r, what="final")
    _close_grads(gg, rg, RNN_GRAD_TOL)


def test_rnn_time_major_and_scan_is_one_op():
    res = _rnn_case("GRU", "forward", time_major=True)
    _close(res[pt][0], res[P][0])
    cell = pt.nn.LSTMCell(RI, RH)
    ref_cell = P.nn.LSTMCell(RI, RH)
    carry(ref_cell, cell)
    x = np.random.RandomState(10).standard_normal((RB, RI)).astype(
        np.float32)
    g_h, (g_h2, g_c) = cell(pt.to_tensor(x))
    r_h, (r_h2, r_c) = ref_cell(P.to_tensor(x))
    _close(g_h, r_h)
    _close(g_c, r_c)
    # the scan over time records one op: a static program holds one
    pt.enable_static()
    try:
        main = pt.static.Program()
        with pt.static.program_guard(main):
            xs = pt.static.data("x", [RB, RT, RI], "float32")
            pt.nn.GRU(RI, RH)(xs)
        names = [op.name for op in main.global_block().ops]
    finally:
        pt.disable_static()
    assert names.count("rnn_scan") == 1, names
