"""paddle_tpu_torch.models.gpt against paddle_tpu.models.gpt.

Weights are drawn with numpy in the JAX layout and reach the port through
its numpy bridge; token inputs and pool contents are drawn from numpy
seeds.  Everything runs on the CPU in float32, where the port's kernels
take their plain versions.  Tolerance: 1e-5 absolute on fp32 logits and
pools (the two frameworks order fp32 sums differently); greedy tokens
must match exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import gpt as J
from paddle_tpu_torch.models import gpt as T
from paddle_tpu_torch.ops.cuda import norms, paged_attn

TOL = 1e-5
CPU = "cpu"


def numpy_params(cfg, seed):
    """A GPT param tree in the JAX package's layout (stacked ``[L]`` block
    leaves, the ``init_params`` key names), drawn with numpy so that both
    packages load identical weights without running ``jax.random``.
    LayerNorm gains and all biases are random too, so the parity tests
    exercise the affine terms."""
    rng = np.random.default_rng(seed)
    H, L, F, V = (cfg.hidden_size, cfg.num_layers, cfg.ffn_size,
                  cfg.vocab_size)

    def nrm(*shape, scale=0.02):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    blocks = {
        "ln1_g": 1 + nrm(L, H, scale=0.1), "ln1_b": nrm(L, H),
        "qkv_w": nrm(L, H, 3, H), "qkv_b": nrm(L, 3, H),
        "proj_w": nrm(L, H, H), "proj_b": nrm(L, H),
        "ln2_g": 1 + nrm(L, H, scale=0.1), "ln2_b": nrm(L, H),
        "fc1_w": nrm(L, H, F), "fc1_b": nrm(L, F),
        "fc2_w": nrm(L, F, H), "fc2_b": nrm(L, H),
    }
    return {"wte": nrm(V, H), "wpe": nrm(cfg.max_seq_len, H),
            "blocks": blocks, "lnf_g": 1 + nrm(H, scale=0.1),
            "lnf_b": nrm(H)}


def _wide_cfg(mod):
    """H=128, nh=2 (hd=64, the serving head width), LayerNorm through the
    kernel wrapper."""
    return mod.GPTConfig(vocab_size=256, hidden_size=128, num_layers=2,
                         num_heads=2, max_seq_len=64, dtype="float32",
                         use_flash=False, remat=False, use_pallas_norm=True)


CONFIGS = {"tiny": (J.gpt_tiny, T.gpt_tiny),
           "wide_pallas_norm": (lambda: _wide_cfg(J), lambda: _wide_cfg(T))}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    jcfg, tcfg = (f() for f in CONFIGS[request.param])
    tree = numpy_params(jcfg, 0)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, jparams, tcfg, T.params_from_numpy(tree, CPU)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def test_configs_match_the_reference():
    for jf, tf in [(J.gpt_tiny, T.gpt_tiny), (J.gpt_345m, T.gpt_345m),
                   (J.gpt3_1p3b, T.gpt3_1p3b)]:
        assert dataclasses.asdict(jf()) == dataclasses.asdict(tf())
        assert jf().num_params() == tf().num_params()
        assert jf().flops_per_token() == tf().flops_per_token()


def test_forward_logits(pair):
    jcfg, jp, tcfg, tp = pair
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 9)).astype(np.int32)
    want = np.asarray(J.forward(jp, jnp.asarray(toks), jcfg))
    got = _np(T.forward(tp, torch.from_numpy(toks), tcfg))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_forward_cached_prefill_then_decode(pair):
    jcfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, jcfg.vocab_size, (2, 7)).astype(np.int32)
    steps = rng.integers(0, jcfg.vocab_size, (2, 2, 1)).astype(np.int32)
    jc = J.init_cache(jcfg, 2, 12)
    tc = T.init_cache(tcfg, 2, 12, device=CPU)
    for toks in [prompt, *steps]:
        jl, jc = J.forward_cached(jp, jnp.asarray(toks), jcfg, jc)
        tl, tc = T.forward_cached(tp, torch.from_numpy(toks), tcfg, tc)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=TOL,
                                   rtol=0)
    assert tc["len"] == int(jc["len"]) == 9
    np.testing.assert_allclose(_np(tc["k"]), np.asarray(jc["k"]), atol=TOL,
                               rtol=0)


def test_decode_step_paged_logits_and_pools(pair):
    jcfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(2)
    L, nh, hd = jcfg.num_layers, jcfg.num_heads, jcfg.head_dim
    S, P, ps, maxP = 3, 10, 8, 3
    k = rng.standard_normal((L, P, ps, nh, hd)).astype(np.float32)
    v = rng.standard_normal((L, P, ps, nh, hd)).astype(np.float32)
    # lane 0: 5 filled, lane 1: a new page at position 8, lane 2 inactive
    table = np.array([[3, 0, 0], [4, 7, 0], [0, 0, 0]], np.int32)
    lens = np.array([5, 8, 0], np.int32)
    wpages = np.array([3, 7, 0], np.int32)
    woffs = np.array([5, 0, 0], np.int32)
    toks = rng.integers(0, jcfg.vocab_size, (S,)).astype(np.int32)
    jl, jk, jv = J.decode_step_paged(
        jp, jnp.asarray(toks), jcfg, jnp.asarray(k), jnp.asarray(v),
        *(jnp.asarray(a) for a in (table, wpages, woffs, lens)))
    before = paged_attn.launches
    tl, tk, tv = T.decode_step_paged(
        tp, torch.from_numpy(toks), tcfg, torch.from_numpy(k.copy()),
        torch.from_numpy(v.copy()),
        *(torch.from_numpy(a) for a in (table, wpages, woffs, lens)))
    assert paged_attn.launches == before      # CPU tensors: plain path
    # the scratch page (0) takes the inactive lane's garbage in both; it
    # is never read as content, and duplicate writes may land either way
    np.testing.assert_allclose(_np(tl)[:2], np.asarray(jl)[:2], atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(_np(tk)[:, 1:], np.asarray(jk)[:, 1:],
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(_np(tv)[:, 1:], np.asarray(jv)[:, 1:],
                               atol=TOL, rtol=0)
    assert np.isfinite(_np(tl)).all()


def test_generate_greedy_token_exact(pair):
    jcfg, jp, tcfg, tp = pair
    prompt = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 5)).astype(np.int32)
    want = np.asarray(J.generate(jp, jcfg, jnp.asarray(prompt), 8))
    got = _np(T.generate(tp, tcfg, torch.from_numpy(prompt), 8))
    np.testing.assert_array_equal(got, want)


def test_sampling_uses_the_generator():
    cfg = T.gpt_tiny()
    p = T.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    prompt = torch.tensor([[1, 2, 3]])
    with pytest.raises(ValueError, match="Generator"):
        T.generate(p, cfg, prompt, 4, temperature=0.8)
    outs = [T.generate(p, cfg, prompt, 6, temperature=0.8, top_k=5,
                       generator=torch.Generator().manual_seed(7))
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])


def test_trim_eos_matches_reference():
    seqs = np.array([[1, 2, 9, 4, 9], [1, 2, 3, 4, 5]], np.int32)
    for inc in (True, False):
        want = J.trim_eos(seqs, 2, 9, include_eos=inc)
        got = T.trim_eos(torch.from_numpy(seqs), 2, 9, include_eos=inc)
        assert [w.tolist() for w in want] == [g.tolist() for g in got]


def test_init_params_layout_and_seed():
    cfg = T.gpt_tiny()
    shapes = jax.tree_util.tree_map(
        lambda x: tuple(x.shape),
        jax.eval_shape(lambda k: J.init_params(J.gpt_tiny(), k),
                       jax.random.PRNGKey(0)))
    a = T.init_params(cfg, torch.Generator().manual_seed(5), device=CPU)
    b = T.init_params(cfg, torch.Generator().manual_seed(5), device=CPU)
    c = T.init_params(cfg, torch.Generator().manual_seed(6), device=CPU)
    assert {k: (tuple(v.shape) if k != "blocks" else
                {kk: tuple(vv.shape) for kk, vv in v.items()})
            for k, v in a.items()} == shapes
    assert torch.equal(a["blocks"]["qkv_w"], b["blocks"]["qkv_w"])
    assert not torch.equal(a["wte"], c["wte"])
    assert a["wte"].dtype == torch.float32
    # std of the draws follows the reference's init (0.02, residual-scaled)
    assert abs(float(a["wte"].std()) - 0.02) < 2e-3
    assert float(a["blocks"]["proj_w"].std()) < 0.015


def test_npz_bridge_round_trip(tmp_path):
    jp = numpy_params(J.gpt_tiny(), 1)
    path = J.save_params_npz(str(tmp_path / "w.npz"), jp)
    tp = T.load_params_npz(path, CPU)
    np.testing.assert_array_equal(_np(tp["blocks"]["fc1_w"]),
                                  np.asarray(jp["blocks"]["fc1_w"]))
    bf = T.params_from_numpy(jp, CPU, dtype="bfloat16")
    assert bf["wte"].dtype == torch.bfloat16


def test_pallas_norm_routes_through_the_wrapper(monkeypatch):
    calls = []
    real = T._kernel_layer_norm

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)
    monkeypatch.setattr(T, "_kernel_layer_norm", spy)
    cfg = _wide_cfg(T)
    p = T.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    before = norms.launches
    T.forward(p, torch.tensor([[1, 2, 3]]), cfg)
    # ln1 + ln2 per layer, plus the final lnf
    assert len(calls) == 2 * cfg.num_layers + 1
    assert norms.launches == before


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = T.gpt_tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.params_from_numpy({"w": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_paged_cache(cfg, 4, 8)


def test_out_of_slice_configs_are_named():
    with pytest.raises(NotImplementedError, match="MoE"):
        T.init_params(T.GPTConfig(vocab_size=64, hidden_size=32,
                                  num_layers=1, num_heads=2, moe_experts=2),
                      torch.Generator(), device=CPU)
    # the fused FFN is in the slice: its config initialises as the plain
    # FFN's does, to the same weights from the same seed
    kw = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2)
    fused = T.init_params(T.GPTConfig(use_fused_ffn=True, **kw),
                          torch.Generator().manual_seed(0), device=CPU)
    plain = T.init_params(T.GPTConfig(**kw),
                          torch.Generator().manual_seed(0), device=CPU)
    assert fused["blocks"].keys() == plain["blocks"].keys()
    for k, w in fused["blocks"].items():
        assert torch.equal(w, plain["blocks"][k]), k
