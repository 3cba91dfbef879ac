"""The port's BERT / ERNIE pretraining path against the JAX package, on the
CPU.

``paddle_tpu_torch.models.bert`` against ``paddle_tpu.models.bert`` at
``mesh=None``: ``encode``, ``pool``, ``mlm_logits`` and ``pretrain_loss``
(with and without token types and NSP labels, with a pad mask, and with
``use_flash`` at hd 64 and N = 128, where the reference's ``_use_pallas``
would take its kernel on a TPU), the loss and every leaf's gradient
against ``jax.value_and_grad``, three steps of ``make_train_step``, the
decay rule leaf by leaf over ERNIE-3.0-Base's tree, the presets, and the
eager Layer wrappers.  Weights are numpy-drawn in the JAX layout
(:func:`numpy_params`) and carried over with ``params_from_numpy``.
Tolerances: 1e-5 absolute in fp32 (sums in another order); 2**-6
relative on a bf16 loss.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.models import bert as J
from paddle_tpu_torch.framework import core
from paddle_tpu_torch.models import bert as T
from paddle_tpu_torch.models import common as TC
from paddle_tpu_torch.ops.cuda import flash_attn

TOL = 1e-5
BF16_RTOL = 2.0 ** -6
CPU = "cpu"


def numpy_params(cfg, seed):
    """A BERT param tree in the JAX layout (the reference ``init_params``'s
    keys and shapes), drawn with numpy: gains 1 + N(0, 0.1), every other
    leaf N(0, 0.02), so the affine terms and biases are exercised."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: J.init_params(cfg, jax.random.PRNGKey(0)))

    def draw(path, s):
        name = str(path[-1].key)
        a = rng.standard_normal(s.shape).astype(np.float32)
        return 1 + 0.1 * a if name.endswith("_g") else 0.02 * a
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _cfgs(base=J.bert_tiny, **kw):
    """(reference config, port config) of the same fields."""
    jcfg = dataclasses.replace(base(), **kw)
    return jcfg, T.BertConfig(**dataclasses.asdict(jcfg))


def _flash_cfgs(**kw):
    """hd 64 at N = 128 (two heads of H = 128), ``use_flash`` on."""
    return _cfgs(hidden_size=128, num_heads=2, use_flash=True, **kw)


def _batch(cfg, seed, B=2, N=32):
    """tokens, 15% MLM labels (-100 elsewhere), NSP labels, token types
    and a pad mask whose second row ends in padding, as int32 numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, N)).astype(np.int32)
    mask = rng.random((B, N)) < 0.15
    mask[:, 1] = True                                 # at least one label
    mlm = np.where(mask, toks, -100).astype(np.int32)
    nsp = rng.integers(0, 2, (B,)).astype(np.int32)
    tt = rng.integers(0, cfg.type_vocab_size, (B, N)).astype(np.int32)
    pad = np.ones((B, N), np.int32)
    pad[-1, N // 2:] = 0
    return dict(tokens=toks, mlm=mlm, nsp=nsp, tt=tt, pad=pad)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


CASES = {
    "plain": dict(),
    "token_types": dict(tt=True),
    "nsp": dict(nsp=True),
    "pad_mask": dict(tt=True, pad=True, nsp=True),
    "flash": dict(flash=True, nsp=True),
}


def _case(name, seed):
    c = CASES[name]
    jcfg, tcfg = _flash_cfgs() if c.get("flash") else _cfgs()
    b = _batch(jcfg, seed, N=128 if c.get("flash") else 32)
    kw = dict(tt=b["tt"] if c.get("tt") else None,
              pad=b["pad"] if c.get("pad") else None,
              nsp=b["nsp"] if c.get("nsp") else None)
    return jcfg, tcfg, b, kw


@pytest.mark.parametrize("case", sorted(CASES))
def test_heads_and_loss_match_reference(case):
    jcfg, tcfg, b, kw = _case(case, 1)
    tree = numpy_params(jcfg, 0)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = T.params_from_numpy(tree, CPU)

    @jax.jit
    def ref(p, toks, mlm, tt, pad, nsp):
        seq = J.encode(p, toks, jcfg, tt, pad)
        return (seq, J.pool(p, seq, jcfg), J.mlm_logits(p, seq, jcfg),
                J.pretrain_loss(p, toks, mlm, jcfg, tt, pad, nsp))
    want = ref(jp, *(_j(a) for a in (b["tokens"], b["mlm"], kw["tt"],
                                     kw["pad"], kw["nsp"])))
    with torch.no_grad():
        tseq = T.encode(tp, _t(b["tokens"]), tcfg, _t(kw["tt"]),
                        _t(kw["pad"]))
        got = (tseq, T.pool(tp, tseq, tcfg), T.mlm_logits(tp, tseq, tcfg),
               T.pretrain_loss(tp, _t(b["tokens"]), _t(b["mlm"]), tcfg,
                               _t(kw["tt"]), _t(kw["pad"]), _t(kw["nsp"])))
    pairs = dict(zip(("encode", "pool", "mlm_logits", "pretrain_loss"),
                     zip(got, want)))
    for name, (got, want) in pairs.items():
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=0, err_msg=name)


def test_flash_route_takes_the_wrapper_and_a_mask_does_not(monkeypatch):
    """``use_flash`` with no mask calls the flash wrapper non-causal once a
    block; a pad mask or ``use_flash=False`` takes the dense route."""
    calls = []
    real = T.flash_attention

    def spy(q, k, v, causal):
        calls.append((tuple(q.shape), causal, q.stride()))
        return real(q, k, v, causal)
    monkeypatch.setattr(T, "flash_attention", spy)
    jcfg, tcfg = _flash_cfgs()
    b = _batch(jcfg, 2, N=128)
    tp = T.params_from_numpy(numpy_params(jcfg, 0), CPU)
    with torch.no_grad():
        T.encode(tp, _t(b["tokens"]), tcfg)
        assert len(calls) == tcfg.num_layers
        B, N, H = 2, 128, tcfg.hidden_size
        # q is a strided view of the [B, N, 3, H] projection
        assert calls[0] == ((B, N, 2, 64), False, (3 * N * H, 3 * H, 64, 1))
        T.encode(tp, _t(b["tokens"]), tcfg, pad_mask=_t(b["pad"]))
        T.encode(tp, _t(b["tokens"]),
                 dataclasses.replace(tcfg, use_flash=False))
    assert len(calls) == tcfg.num_layers


GRAD_CASES = {"dense_pad_mask": dict(), "flash_remat": dict(flash=True)}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_loss_and_every_grad_match_reference(case):
    """The loss and the gradient of every leaf against
    ``jax.value_and_grad(bert.pretrain_loss)``: token types, a pad mask
    and NSP labels on the dense route; NSP labels with flash and remat."""
    if GRAD_CASES[case].get("flash"):
        jcfg, tcfg = _flash_cfgs(remat=True)
        b = _batch(jcfg, 3, N=128)
        kw = dict(tt=None, pad=None, nsp=b["nsp"])
    else:
        jcfg, tcfg = _cfgs()
        b = _batch(jcfg, 3)
        kw = dict(tt=b["tt"], pad=b["pad"], nsp=b["nsp"])
    tree = numpy_params(jcfg, 4)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: J.pretrain_loss(p, _j(b["tokens"]), _j(b["mlm"]), jcfg,
                                  _j(kw["tt"]), _j(kw["pad"]),
                                  _j(kw["nsp"]))))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    loss, grads = TC.value_and_grad(
        lambda p: T.pretrain_loss(p, _t(b["tokens"]), _t(b["mlm"]), tcfg,
                                  _t(kw["tt"]), _t(kw["pad"]),
                                  _t(kw["nsp"])),
        T.params_from_numpy(tree, CPU))
    assert abs(float(loss) - float(jloss)) <= TOL
    paths = [p for p, _ in TC._leaves(grads)]
    assert len(paths) == len(jax.tree_util.tree_leaves(jgrads)) == 26
    for path in paths:
        np.testing.assert_allclose(TC._at(grads, path).numpy(),
                                   np.asarray(TC._at(jgrads, path)),
                                   atol=TOL, rtol=0, err_msg=str(path))


@pytest.mark.parametrize("nsp", [True, False], ids=["nsp", "mlm_only"])
def test_three_train_steps_match_reference(nsp):
    """Per-step loss and params, m and v after 3 steps of
    ``make_train_step`` (bert's hyperparameters: beta2 0.999, weight decay
    0.01, clip 1.0) against the reference's at ``mesh=None``.  Adam's eps
    is 1e-6 on both sides: with 1e-8 the update of a weight whose gradient
    is near 1e-8 is a ratio of rounding noise, which the two frameworks'
    fp32 sums do not share.  Without NSP labels the pooler and NSP leaves
    get zero gradients (decay alone moves them)."""
    jcfg, tcfg = _flash_cfgs(remat=True)
    b = _batch(jcfg, 5, N=128)
    nl = b["nsp"] if nsp else None
    tree = numpy_params(jcfg, 6)
    jstep = J.make_train_step(jcfg, eps=1e-6)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jm = jax.tree_util.tree_map(jnp.zeros_like, jp)
    jv = jax.tree_util.tree_map(jnp.zeros_like, jp)
    tp = T.params_from_numpy(copy.deepcopy(tree), CPU)
    tm, tv = T.init_train_state(tp)
    tstep = T.make_train_step(tcfg, eps=1e-6)
    for t in (1, 2, 3):
        jp, jm, jv, jl = jstep(jp, jm, jv, jnp.int32(t), _j(b["tokens"]),
                               _j(b["mlm"]), _j(nl), jnp.float32(1e-3))
        _, _, _, tl = tstep(tp, tm, tv, torch.tensor(t), _t(b["tokens"]),
                            _t(b["mlm"]), _t(nl), torch.tensor(1e-3))
        assert abs(float(tl) - float(jl)) <= TOL, t
    for name, got, want in (("params", tp, jp), ("m", tm, jm),
                            ("v", tv, jv)):
        for path, g in TC._leaves(got):
            np.testing.assert_allclose(g.numpy(),
                                       np.asarray(TC._at(want, path)),
                                       atol=TOL, rtol=0,
                                       err_msg=f"{name} {path}")


def test_train_step_updates_in_place_and_takes_numbers():
    """``params``, ``m`` and ``v`` come back as the same tensors, updated;
    ``t`` and ``lr`` may be Python numbers."""
    jcfg, tcfg = _cfgs()
    b = _batch(jcfg, 7)
    params = T.params_from_numpy(numpy_params(jcfg, 8), CPU)
    m, v = T.init_train_state(params)
    before = params["blocks"]["qkv_w"].clone()
    out = T.make_train_step(tcfg)(params, m, v, 1, _t(b["tokens"]),
                                  _t(b["mlm"]), _t(b["nsp"]), 1e-3)
    assert out[0] is params and out[1] is m and out[2] is v
    assert not torch.equal(params["blocks"]["qkv_w"], before)
    assert out[3].dim() == 0 and torch.isfinite(out[3])


def test_bf16_loss_matches_reference():
    jcfg, tcfg = _flash_cfgs(dtype="bfloat16")
    b = _batch(jcfg, 9, N=128)
    tree = numpy_params(jcfg, 10)
    want = float(jax.jit(
        lambda p: J.pretrain_loss(p, _j(b["tokens"]), _j(b["mlm"]), jcfg,
                                  nsp_labels=_j(b["nsp"])))(
        jax.tree_util.tree_map(jnp.asarray, tree)))
    with torch.no_grad():
        got = float(T.pretrain_loss(T.params_from_numpy(tree, CPU),
                                    _t(b["tokens"]), _t(b["mlm"]), tcfg,
                                    nsp_labels=_t(b["nsp"])))
    assert abs(got - want) <= BF16_RTOL * abs(want), (got, want)


def test_decays_match_reference_for_every_ernie_leaf():
    """bert's own rule (not GPT's sets): ``wte``, ``wtt``, ``pool_w``,
    ``mlm_w``, ``nsp_w`` and every block ``*_w`` decay; gains, biases,
    ``mlm_bias`` and ``wpe`` do not."""
    shapes = jax.eval_shape(
        lambda: J.init_params(J.ernie_3_base(), jax.random.PRNGKey(0)))
    paths = jax.tree_util.tree_flatten_with_path(shapes)[0]
    got = {tuple(k.key for k in p): T._decays(tuple(k.key for k in p))
           for p, _ in paths}
    want = {tuple(k.key for k in p): J._decays(p) for p, _ in paths}
    assert got == want and len(got) == 26
    assert {p[-1] for p, d in got.items() if d} == {
        "wte", "wtt", "pool_w", "mlm_w", "nsp_w", "qkv_w", "proj_w",
        "fc1_w", "fc2_w"}


def test_init_params_layout_matches_reference():
    """Key paths, shapes and dtypes of ``init_params`` equal the
    reference's (ERNIE-3.0-Base's tree, 12 layers); biases zero, gains
    one, weights N(0, 0.02)."""
    cfg = T.ernie_3_base()
    params = T.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    ref = jax.eval_shape(
        lambda: J.init_params(J.ernie_3_base(), jax.random.PRNGKey(0)))
    got = {p: (tuple(x.shape), str(x.dtype).split(".")[-1])
           for p, x in TC._leaves(params)}
    want = {tuple(k.key for k in p): (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(ref)[0]}
    assert got == want
    assert sum(int(x.numel()) for _, x in TC._leaves(params)) == \
        cfg.num_params()
    assert float(params["blocks"]["ln1_g"].min()) == 1.0
    assert float(params["mlm_bias"].abs().max()) == 0.0
    assert abs(float(params["wte"].std()) - 0.02) < 1e-3
    again = T.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    assert torch.equal(again["blocks"]["fc1_w"], params["blocks"]["fc1_w"])


@pytest.mark.parametrize("preset", ["bert_tiny", "bert_base", "bert_large",
                                    "ernie_3_base"])
def test_presets_match_reference(preset):
    got, want = getattr(T, preset)(), getattr(J, preset)()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.head_dim == want.head_dim
    assert got.num_params() == want.num_params()
    assert got.flops_per_token() == want.flops_per_token()


def test_ernie_flops_per_token():
    cfg = T.ernie_3_base()
    assert cfg.layer_norm_eps == 1e-12 and cfg.use_flash and cfg.remat
    assert (cfg.vocab_size, cfg.type_vocab_size) == (40064, 4)
    assert round(cfg.num_params() / 1e6, 1) == 117.4
    assert round(cfg.flops_per_token() / 1e8, 2) == 7.61
    assert T.ErnieModel is T.BertModel
    assert T.ErnieForPretraining is T.BertForPretraining


@pytest.fixture
def on_cpu():
    prev = core._state.expected_place
    pt.set_device("cpu")
    yield
    core._state.expected_place = prev


def test_eager_wrappers_take_reference_state_dict(on_cpu):
    """The reference Layer's ``state_dict`` (numpy) into the port's
    ``set_state_dict``: same keys, and the same sequence output, pooled
    output and loss, in grad mode and under ``no_grad``."""
    cfg = J.bert_tiny()
    ref = J.BertForPretraining(cfg)
    state = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    model = T.BertForPretraining(T.bert_tiny())
    assert list(model.state_dict()) == list(state)
    model.set_state_dict(state)
    b = _batch(cfg, 11)
    toks, mlm, nsp, tt, pad = (b[k] for k in ("tokens", "mlm", "nsp", "tt",
                                             "pad"))
    rs, rp = ref(paddle.to_tensor(toks), token_type_ids=paddle.to_tensor(tt),
                 pad_mask=paddle.to_tensor(pad))
    rl = ref(paddle.to_tensor(toks), paddle.to_tensor(mlm),
             paddle.to_tensor(nsp))
    for grad in (True, False):
        with torch.set_grad_enabled(grad):
            s, p = model(pt.to_tensor(toks),
                         token_type_ids=pt.to_tensor(tt),
                         pad_mask=pt.to_tensor(pad))
            loss = model(pt.to_tensor(toks), pt.to_tensor(mlm),
                         pt.to_tensor(nsp))
        assert s.stop_gradient is not grad and loss.stop_gradient is not grad
        for got, want in ((s, rs), (p, rp), (loss, rl)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                                       atol=TOL, rtol=0)


def test_eager_state_dict_round_trip_and_backward_refused(on_cpu):
    """The eager wrappers' ``state_dict`` round trip; then (the backward
    is no longer refused) ``loss.backward()`` fills every named
    parameter's ``.grad`` with the reference's grads."""
    cfg = T.bert_tiny()
    pt.seed(0)
    m1 = T.ErnieModel(cfg)
    pt.seed(1)
    m2 = T.ErnieModel(cfg)
    toks = pt.to_tensor(_batch(cfg, 12)["tokens"])
    assert not np.array_equal(m1(toks)[0].numpy(), m2(toks)[0].numpy())
    m2.set_state_dict(m1.state_dict())
    for a, b in zip(m1(toks), m2(toks)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert len(m1.parameters()) == 26
    assert m1.state_dict()["blocks_qkv_w"].shape == [2, 64, 3, 64]
    m3 = T.ErnieModel(cfg)
    m3.set_state_dict({k: v.numpy() for k, v in m1.state_dict().items()})
    np.testing.assert_array_equal(m3(toks)[1].numpy(), m1(toks)[1].numpy())
    # backward reaches every named parameter with the reference's grads
    ref = J.ErnieForPretraining(J.bert_tiny())
    m4 = T.ErnieForPretraining(cfg)
    m4.set_state_dict({k: np.asarray(v.numpy())
                       for k, v in ref.state_dict().items()})
    mlm = _batch(cfg, 12)["mlm"]
    loss = m4(toks, pt.to_tensor(mlm))
    assert not loss.stop_gradient
    loss.backward()
    rloss = ref(paddle.to_tensor(_batch(cfg, 12)["tokens"]),
                paddle.to_tensor(mlm))
    rloss.backward()
    rgrads = {k: v.grad for k, v in ref.state_dict().items()}
    for k, p in m4.state_dict().items():
        want = (np.zeros(p.shape, np.float32) if rgrads[k] is None
                else np.asarray(rgrads[k].numpy()))
        got = (np.zeros(p.shape, np.float32) if p.grad is None
               else p.grad.numpy())
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("route", ["dense", "flash"])
def test_eager_training_matches_reference(on_cpu, route):
    """The reference's eager loop (``ErnieForPretraining``,
    ``loss.backward()``, ``AdamW`` with ``ClipGradByGlobalNorm(1.0)`` on a
    ``LinearWarmup`` schedule, ``step``, ``clear_grad``) at 2 layers in
    fp32 against the port's, weights carried from numpy: 3 steps, the
    losses within 1e-5 relative and the params after them within 1e-5.
    Adam's eps is 1e-6 on both sides, as in
    ``test_three_train_steps_match_reference``."""
    jcfg, tcfg = _flash_cfgs() if route == "flash" else _cfgs()
    b = _batch(jcfg, 13, N=128 if route == "flash" else 32)
    tree = numpy_params(jcfg, 14)
    losses, states = {}, {}
    for mod, cfgs, model_mod in ((paddle, jcfg, J), (pt, tcfg, T)):
        model = model_mod.ErnieForPretraining(cfgs)
        model.set_state_dict({
            "_".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]})
        sched = mod.optimizer.lr.LinearWarmup(1e-3, 2, 1e-4, 1e-3)
        opt = mod.optimizer.AdamW(
            learning_rate=sched, weight_decay=0.01, epsilon=1e-6,
            grad_clip=mod.nn.ClipGradByGlobalNorm(1.0),
            parameters=model.parameters())
        args = [mod.to_tensor(b[k]) for k in ("tokens", "mlm", "nsp")]
        out = []
        for _ in range(3):
            loss = model(*args)
            loss.backward()
            opt.step()
            opt.clear_grad()
            sched.step()
            out.append(float(loss.numpy()))
        losses[mod] = out
        states[mod] = {k: np.asarray(v.numpy())
                       for k, v in model.state_dict().items()}
    np.testing.assert_allclose(losses[pt], losses[paddle], rtol=1e-5)
    assert losses[pt][-1] < losses[pt][0]
    for k, want in states[paddle].items():
        np.testing.assert_allclose(states[pt][k], want, atol=TOL, rtol=0,
                                   err_msg=k)


def test_mesh_and_specs_refused_by_name():
    cfg = T.bert_tiny()
    with pytest.raises(NotImplementedError, match="mesh.*Queue 1 item 13"):
        T.make_train_step(cfg, mesh=object())
    with pytest.raises(NotImplementedError, match="mesh"):
        T.init_pretrain_state(cfg, torch.Generator(), CPU, mesh=object())
    with pytest.raises(NotImplementedError, match="param_specs"):
        T.param_specs(cfg)
    with pytest.raises(NotImplementedError, match="sharding_rules"):
        T.sharding_rules(cfg)


def test_default_device_and_long_sequences_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = T.bert_tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_pretrain_state(cfg, torch.Generator())
    params, m, v = T.init_pretrain_state(cfg, torch.Generator(), CPU)
    assert m["blocks"]["fc1_w"].dtype == torch.float32
    with pytest.raises(ValueError, match="max_seq_len"):
        T.encode(params, torch.zeros(1, cfg.max_seq_len + 1, dtype=torch.int32),
                 cfg)


def test_flash_on_cpu_counts_no_launch():
    """On CPU tensors the flash wrapper is its plain version: a train step
    with ``use_flash`` launches nothing."""
    jcfg, tcfg = _flash_cfgs(remat=True)
    b = _batch(jcfg, 13, N=128)
    params, m, v = T.init_pretrain_state(tcfg, torch.Generator(), CPU)
    before = (flash_attn.fwd_launches, flash_attn.dq_launches,
              flash_attn.dkv_launches)
    T.make_train_step(tcfg)(params, m, v, 1, _t(b["tokens"]), _t(b["mlm"]),
                            _t(b["nsp"]), 1e-4)
    assert (flash_attn.fwd_launches, flash_attn.dq_launches,
            flash_attn.dkv_launches) == before
