"""paddle_tpu_torch's speculative decoding against the JAX package on the
CPU, the counterpart of ``tests/test_speculative.py``.

The n-gram matcher and the commit math run on the inputs of the
reference's tests through both packages' functions; the verify forward
(fp and int8 pools) against ``paddle_tpu.models.gpt.
decode_step_paged_verify(_quant)`` on the same numpy-drawn weights, pool
and window; the engine in both drafting modes against the JAX
``generate`` (and the non-speculative engines) under churn, eos inside a
window, chunked prefill, int8, preemption and an aborted step.

Tolerances:

* ``ngram_draft``, ``accept_commit``, ``ensure_append_window``: exact;
* the verify forward, fp32: logits and window K/V within 1e-5 of the
  reference's; int8 window codes equal but for rounding midpoints (at
  most 0.1% of them, by one), scales within 1e-5 relative;
* engines: greedy tokens exact against ``generate`` (fp32) or the
  non-speculative engine of the same numeric contract (int8);
* pool bytes: after an all-reject verify and after an accepting run, the
  speculative engine's pool (scratch page 0 excluded) equals the
  non-speculative engine's byte for byte, fp and int8.
"""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import speculative as JSP
from paddle_tpu.inference.kv_pager import KVPager as JKVPager
from paddle_tpu.models import gpt as J
from paddle_tpu_torch.inference import serving as S
from paddle_tpu_torch.inference import speculative as SP
from paddle_tpu_torch.inference.kv_pager import KVPager, PagesExhausted
from paddle_tpu_torch.models import gpt as T
from spec_probe import commit_write_probe
from test_torch_gpt import numpy_params

FP32_TOL = 1e-5
CODE_FLIP_SHARE = 1e-3


def _cfg(mod):
    return mod.GPTConfig(vocab_size=256, hidden_size=32, num_layers=2,
                         num_heads=2, max_seq_len=64, dtype="float32",
                         use_flash=False, remat=False,
                         **({"use_pallas_norm": True} if mod is T else {}))


@pytest.fixture(scope="module")
def model():
    """(jax cfg, jax params, port cfg, port params): numpy weights."""
    jcfg = _cfg(J)
    tree = numpy_params(jcfg, 0)
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, tree), _cfg(T),
            T.params_from_numpy(tree, "cpu"))


@pytest.fixture(scope="module")
def drafted():
    """The same four for weights drawn by the port's ``init_params`` from
    seed 0: a self-draft engine (draft config and seed the target's)
    draws its draft model the same way."""
    tcfg = _cfg(T)
    tp = T.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")

    def to_np(t):
        return ({k: to_np(v) for k, v in t.items()} if isinstance(t, dict)
                else t.numpy())
    return (_cfg(J), jax.tree_util.tree_map(jnp.asarray, to_np(tp)), tcfg,
            tp)


def _generate_ref(m, prompts_and_n):
    """JAX greedy continuations, one ``generate`` per (length, n)."""
    jcfg, jp = m[0], m[1]
    groups = collections.defaultdict(list)
    for i, (p, n) in enumerate(prompts_and_n):
        groups[(len(p), n)].append(i)
    out = [None] * len(prompts_and_n)
    for (ln, n), idx in groups.items():
        res = np.asarray(J.generate(jp, jcfg, jnp.asarray(
            np.stack([prompts_and_n[i][0] for i in idx])), n))
        for r, i in enumerate(idx):
            out[i] = res[r, ln:].tolist()
    return out


def _make_engine(m, **kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("spec_mode", "ngram")
    kw.setdefault("spec_k", 3)
    kw.setdefault("slots", 3)
    kw.setdefault("max_len", 32)
    kw.setdefault("page_size", 8)
    kw.setdefault("seq_buckets", (8, 16))
    kw.setdefault("batch_buckets", (1, 2))
    return SP.SpeculativeServingEngine((m[3], m[2]), **kw)


def _self_draft(m):
    return {"spec_mode": "draft",
            "spec_draft_cfg": dataclasses.asdict(m[2]),
            "spec_draft_seed": 0}


def _check_ref(m, reqs):
    want = _generate_ref(m, [(r.prompt, r.max_new_tokens) for r in reqs])
    for r, w in zip(reqs, want):
        assert r.tokens == w, r.id


# --------------------------------------------------------------------------
# n-gram matcher and commit math: the reference's cases, both packages
# --------------------------------------------------------------------------

NGRAM_CASES = [
    (([1, 2, 3, 9, 9, 1, 2, 3], 2), {}, [9, 9]),
    (([1, 2, 3, 7, 5, 2, 3, 8, 1, 2, 3], 1), {"max_ngram": 3}, [7]),
    (([1, 2, 3, 7, 5, 2, 3, 8, 1, 2, 3], 1), {"max_ngram": 2}, [8]),
    (([5, 6, 7, 5, 6], 4), {}, [7, 5, 6, 6]),
    (([1, 2, 3], 3), {"max_ngram": 2}, [3, 3, 3]),
    (([9, 1, 2], 2), {}, [2, 2]),
    (([4], 2), {}, [4, 4]),
    (([1, 2, 3, 4, 1, 2, 3, 4, 1, 2], 4), {}, [3, 4, 1, 2]),
    (([], 3), {}, [0, 0, 0]),
]


@pytest.mark.parametrize("args,kw,want", NGRAM_CASES)
def test_ngram_draft_matches_reference(args, kw, want):
    got = SP.ngram_draft(*args, **kw)
    assert got.dtype == np.int32
    assert list(got) == list(JSP.ngram_draft(*args, **kw)) == want


ACCEPT_CASES = [
    # drafts, greedy, caps, eos, force, (n_commit)
    ([[7, 8, 9]], [[7, 8, 9, 4]], [4], None, 0, [4]),
    ([[7, 8, 5]], [[7, 8, 9, 4]], [4], None, 0, [3]),
    ([[5, 5, 5]], [[7, 8, 9, 4]], [4], None, 0, [1]),
    ([[7, 5, 9]], [[7, 8, 9, 4]], [4], None, 0, [2]),
    ([[7, 8, 9]], [[7, 8, 9, 4]], [2], None, 0, [2]),
    ([[7, 8, 9]], [[7, 8, 9, 4]], [0], None, 0, [0]),
    ([[7, 8, 9]], [[7, 8, 9, 4]], [4], [8], 0, [2]),
    ([[7, 5, 9]], [[7, 8, 9, 4]], [4], [9], 0, [2]),
    ([[7, 8, 9]], [[7, 8, 9, 4]], [4], None, 1, [1]),
    ([[7, 8], [1, 1]], [[7, 8, 3], [9, 9, 9]], [3, 3], None, 0, [3, 1]),
    (np.zeros((2, 0), np.int32), [[5], [6]], [1, 1], [6, -1], 0, [1, 1]),
]


@pytest.mark.parametrize("drafts,greedy,caps,eos,force,want", ACCEPT_CASES)
def test_accept_commit_matches_reference(drafts, greedy, caps, eos, force,
                                         want):
    S_ = len(greedy)
    eos_ids = np.full((S_,), -1, np.int32) if eos is None \
        else np.asarray(eos, np.int32)
    args = [np.asarray(drafts, np.int32), np.asarray(greedy, np.int32),
            np.asarray(caps, np.int32), eos_ids]
    jo, jn = JSP.accept_commit(*map(jnp.asarray, args), jnp.int32(force))
    to, tn = SP.accept_commit(*map(torch.from_numpy, args),
                              torch.tensor(force, dtype=torch.int32))
    assert to.dtype == tn.dtype == torch.int32
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert list(tn.numpy()) == want


# --------------------------------------------------------------------------
# the pager's window append (the port's copy against the reference's)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pager", [KVPager, JKVPager], ids=["port", "ref"])
def test_ensure_append_window(pager):
    pg = pager(9, 4, slots=1, prefix_cache=False)
    pg.admit(0, np.arange(5))                 # 2 pages, tail holds 1
    pids, offs, cows = pg.ensure_append_window(0, 5, 5)   # 5..9
    assert offs == [1, 2, 3, 0, 1] and cows == []
    assert pids[0] == pids[1] == pids[2] == pg.tables[0][1]
    assert pids[3] == pids[4] == pg.tables[0][2]
    assert pg.ensure_append_window(0, 5, 5) == (pids, offs, [])
    # a shared tail is copied once, the peer keeps its page
    pg = pager(17, 4, slots=2)
    prompt = np.arange(1, 7)
    pg.admit(0, prompt)
    pg.admit(1, prompt)
    old_tail = pg.tables[0][1]
    pids, _, cows = pg.ensure_append_window(0, 6, 4)
    assert cows == [(old_tail, pids[0])] and pg.tables[1][1] == old_tail
    # a window past the pool raises
    pg = pager(4, 4, slots=1, prefix_cache=False)
    pg.admit(0, np.arange(10))
    with pytest.raises(Exception) as e:
        pg.ensure_append_window(0, 10, 4)
    assert type(e.value).__name__ == PagesExhausted.__name__


# --------------------------------------------------------------------------
# the verify forward
# --------------------------------------------------------------------------

def _verify_inputs(seed):
    rng = np.random.default_rng(seed)
    pool = [rng.standard_normal((2, 12, 8, 2, 16)).astype(np.float32)
            for _ in range(2)]
    table = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 9]], np.int32)
    # the last slot's window runs past its 32-position view: those lanes
    # drop, as the reference's scatter drops them
    lens = np.array([20, 9, 30], np.int32)
    toks = rng.integers(0, 256, (3, 4)).astype(np.int32)
    return pool, table, lens, toks


def test_verify_matches_reference_fp(model):
    jcfg, jp, tcfg, tp = model
    (ck, cv), table, lens, toks = _verify_inputs(0)
    lj, kj, vj = J.decode_step_paged_verify(
        jp, jnp.asarray(toks), jcfg, jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(table), jnp.asarray(lens))
    pool = [torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())]
    with torch.inference_mode():
        lt, kt, vt = T.decode_step_paged_verify(
            T.prepare_params(tp, tcfg), torch.from_numpy(toks), tcfg, *pool,
            torch.from_numpy(table), torch.from_numpy(lens))
    for got, want in ((lt, lj), (kt, kj), (vt, vj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=FP32_TOL)
    # read only
    assert np.array_equal(pool[0].numpy(), ck)
    assert np.array_equal(pool[1].numpy(), cv)


def test_verify_matches_reference_int8(model):
    jcfg, jp, tcfg, tp = model
    (ck, cv), table, lens, toks = _verify_inputs(1)
    kq, ks = J.quantize_kv(jnp.asarray(ck))
    vq, vs = J.quantize_kv(jnp.asarray(cv))
    pool = [np.array(a) for a in (kq, ks, vq, vs)]
    want = J.decode_step_paged_verify_quant(
        jp, jnp.asarray(toks), jcfg, *map(jnp.asarray, pool),
        jnp.asarray(table), jnp.asarray(lens))
    tpool = [torch.from_numpy(a.copy()) for a in pool]
    with torch.inference_mode():
        got = T.decode_step_paged_verify_quant(
            T.prepare_params(tp, tcfg), torch.from_numpy(toks), tcfg, *tpool,
            torch.from_numpy(table), torch.from_numpy(lens))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=FP32_TOL)
    for i in (1, 3):
        assert got[i].dtype == torch.int8
        d = np.abs(got[i].numpy().astype(np.int32)
                   - np.asarray(want[i]).astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= CODE_FLIP_SHARE
    for i in (2, 4):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=FP32_TOL, atol=0)
    for t, a in zip(tpool, pool):
        assert np.array_equal(t.numpy(), a)


def test_verify_lanes_are_the_sequential_decode(model):
    """Each accepted lane is what the one-token decode computes at its
    position: the verify's logits for lane j equal a sequential decode's
    after it consumed lanes 0..j-1 (fp32, within 1e-5)."""
    _, _, tcfg, tp = model
    params = T.prepare_params(tp, tcfg)
    (ck, cv), table, lens, toks = _verify_inputs(2)
    lens = np.array([20, 9, 12], np.int32)
    with torch.inference_mode():
        lv, _, _ = T.decode_step_paged_verify(
            params, torch.from_numpy(toks), tcfg, torch.from_numpy(ck),
            torch.from_numpy(cv), torch.from_numpy(table),
            torch.from_numpy(lens))
        k, v = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
        tab = torch.from_numpy(table)
        for j in range(toks.shape[1]):
            pos = lens + j
            wp = torch.from_numpy(table[np.arange(3), pos // 8])
            wo = torch.from_numpy(pos % 8)
            lj, _, _ = T.decode_step_paged(
                params, torch.from_numpy(toks[:, j]), tcfg, k, v, tab, wp,
                wo, torch.from_numpy(pos.astype(np.int32)))
            np.testing.assert_allclose(lv[:, j].numpy(), lj.numpy(),
                                       rtol=0, atol=FP32_TOL)


# --------------------------------------------------------------------------
# the draft model's slot cache
# --------------------------------------------------------------------------

def _slot_cache(seed, L=2, S=3, D=40, nh=2, hd=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((L, S, D, nh, hd)).astype(np.float32)
            for _ in range(2)]


def test_decode_step_slots_matches_reference(model):
    jcfg, jp, tcfg, tp = model
    ck, cv = _slot_cache(3)
    lens = np.array([5, 0, 39], np.int32)
    toks = np.array([7, 200, 31], np.int32)
    active = np.array([True, False, True])
    lj, cj = J.decode_step_slots(
        jp, jnp.asarray(toks), jcfg, {"k": jnp.asarray(ck),
                                      "v": jnp.asarray(cv),
                                      "len": jnp.asarray(lens)},
        jnp.asarray(active))
    cache = {"k": torch.from_numpy(ck.copy()),
             "v": torch.from_numpy(cv.copy()), "len": torch.from_numpy(lens)}
    with torch.inference_mode():
        lt, ct = T.decode_step_slots(T.prepare_params(tp, tcfg),
                                     torch.from_numpy(toks), tcfg, cache,
                                     torch.from_numpy(active))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=FP32_TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(ct[k].numpy(), np.asarray(cj[k]), rtol=0,
                                   atol=FP32_TOL)
    np.testing.assert_array_equal(ct["len"].numpy(), np.asarray(cj["len"]))
    # the fill lengths reset as the reference's, on the host mirror in
    # place and on a tensor in a copy
    h = lens.copy()
    assert T.reset_slots(h, [0, 2]) is h and list(h) == [0, 0, 0]
    t = torch.from_numpy(lens)
    np.testing.assert_array_equal(T.reset_slots(t, 2).numpy(), np.asarray(
        J.reset_slots(jnp.asarray(lens), 2)))
    assert t[2] == 39
    with pytest.raises(ValueError, match="max_seq_len"):
        T.init_slot_cache(tcfg, 2, 65, device="cpu")


@pytest.mark.parametrize("slot,offset", [(0, 0), (2, 16)])
def test_draft_prefill_slot_matches_reference(model, slot, offset):
    jcfg, jp, tcfg, tp = model
    ck, cv = _slot_cache(4)
    toks = np.random.default_rng(5).integers(0, 256, (1, 16)).astype(
        np.int32)
    kj, vj = J.draft_prefill_slot(jp, jnp.asarray(toks), jcfg,
                                  jnp.asarray(ck), jnp.asarray(cv),
                                  jnp.int32(slot), jnp.int32(offset))
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    with torch.inference_mode():
        T.draft_prefill_slot(T.prepare_params(tp, tcfg),
                             torch.from_numpy(toks), tcfg, tk, tv,
                             torch.tensor([slot]), torch.tensor([offset]))
    np.testing.assert_allclose(tk.numpy(), np.asarray(kj), rtol=0,
                               atol=FP32_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(vj), rtol=0,
                               atol=FP32_TOL)
    other = [s for s in range(3) if s != slot]
    assert np.array_equal(tk.numpy()[:, other], ck[:, other])


def test_draft_catchup_and_draft_matches_reference(model):
    jcfg, jp, tcfg, tp = model
    ck, cv = _slot_cache(6)
    ctx = np.array([[5, 9, 0, 0], [1, 2, 3, 4], [0, 0, 0, 0]], np.int32)
    n_ctx = np.array([2, 4, 0], np.int32)
    lens = np.array([10, 3, 20], np.int32)
    kj, vj, dj = J.draft_catchup_and_draft(
        jp, jcfg, jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(ctx),
        jnp.asarray(n_ctx), jnp.asarray(lens), 3)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    with torch.inference_mode():
        _, _, dt = T.draft_catchup_and_draft(
            T.prepare_params(tp, tcfg), tcfg, tk, tv, torch.from_numpy(ctx),
            torch.from_numpy(n_ctx), torch.from_numpy(lens), 3)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_allclose(tk.numpy(), np.asarray(kj), rtol=0,
                               atol=FP32_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(vj), rtol=0,
                               atol=FP32_TOL)


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

def test_ngram_parity_across_churned_slots(model):
    eng = _make_engine(model, capture_logits=True)
    assert eng.warmup() >= 1
    rng = np.random.RandomState(3)
    reqs = [eng.submit(
        rng.randint(1, 256, rng.randint(3, 15)).astype(np.int32),
        int(rng.randint(3, 8))) for _ in range(10)]
    done = eng.run(max_steps=500)
    st = eng.stats()
    assert len(done) == 10
    assert st["decode_compiles"] == 1
    assert st["spec_draft_compiles"] == 0
    assert st["spec_steps"] > 0 and st["drafted_tokens"] > 0
    assert (st["accepted_tokens"] + st["rejected_tokens"]
            == st["drafted_tokens"])
    _check_ref(model, reqs)
    assert st["pages_in_use"] == 0
    for r in reqs:
        assert len(r.logits) == len(r.tokens)


def test_self_draft_full_acceptance(drafted):
    eng = _make_engine(drafted, **_self_draft(drafted))
    eng.warmup()
    rng = np.random.RandomState(5)
    reqs = [eng.submit(
        rng.randint(1, 256, rng.randint(3, 12)).astype(np.int32), 12)
        for _ in range(4)]
    eng.run(max_steps=300)
    st = eng.stats()
    assert st["accepted_tokens_per_step"] > 1.5, st
    assert st["spec_draft_compiles"] == 2     # the prefill and the step
    assert st["decode_compiles"] == 1
    _check_ref(drafted, reqs)


def test_small_draft_parity_despite_rejections(model):
    eng = _make_engine(model, spec_mode="draft", spec_draft_seed=7)
    eng.warmup()
    assert eng._draft_cfg.hidden_size == 16 and eng._draft_cfg.num_layers == 1
    rng = np.random.RandomState(9)
    reqs = [eng.submit(
        rng.randint(1, 256, rng.randint(3, 12)).astype(np.int32),
        int(rng.randint(4, 9))) for _ in range(5)]
    eng.run(max_steps=400)
    assert eng.stats()["rejected_tokens"] > 0
    assert eng.stats()["spec_draft_compiles"] <= 2
    _check_ref(model, reqs)


def test_eos_inside_accepted_window(model):
    eng = _make_engine(model, spec_k=4)
    eng.warmup()
    prompt = np.arange(1, 7, dtype=np.int32)
    want = np.asarray(_generate_ref(model, [(prompt, 12)])[0])
    eos = int(want[5])
    r = eng.submit(prompt, 12, eos_token=eos)
    eng.run(max_steps=200)
    first = int(np.nonzero(want == eos)[0][0])
    assert r.done and r.finish_reason == "eos"
    assert r.tokens == want[:first + 1].tolist()
    assert eng.stats()["pages_in_use"] == 0


@pytest.mark.parametrize("mode", ["ngram", "self_draft"])
def test_chunked_prefill_composes(drafted, mode):
    kw = _self_draft(drafted) if mode == "self_draft" else {}
    eng = _make_engine(drafted, prefill_chunk=8, **kw)
    eng.warmup()
    short = eng.submit(np.arange(1, 6, dtype=np.int32), 10)
    long_req = eng.submit(np.arange(40, 62, dtype=np.int32), 4)
    eng.run(max_steps=300)
    assert eng.stats()["prefill_chunks"] >= 3
    assert eng.stats()["decode_compiles"] == 1
    _check_ref(drafted, [short, long_req])


@pytest.mark.parametrize("mode", ["ngram", "self_draft"])
def test_int8_parity_with_the_int8_engine(drafted, mode):
    kw = _self_draft(drafted) if mode == "self_draft" else {}
    base = S.PagedServingEngine(
        (drafted[3], drafted[2]), device="cpu", slots=2, max_len=32,
        page_size=8, seq_buckets=(8, 16), batch_buckets=(1,),
        quant="int8", kv_dtype="int8")
    eng = _make_engine(drafted, slots=2, quant="int8", kv_dtype="int8",
                       batch_buckets=(1,), **kw)
    base.warmup()
    eng.warmup()
    rng = np.random.RandomState(11)
    pairs = [(rng.randint(1, 256, rng.randint(3, 12)).astype(np.int32),
              int(rng.randint(4, 9))) for _ in range(4)]
    b = [base.submit(p, m) for p, m in pairs]
    base.run()
    s = [eng.submit(p, m) for p, m in pairs]
    eng.run(max_steps=300)
    for x, y in zip(b, s):
        assert x.tokens == y.tokens, y.id
    assert eng.stats()["quant_matmuls"] > 0


def test_int8_ngram_matches_the_jax_speculative_engine(model):
    """The same int8 traffic through both packages' speculative engines:
    the same tokens and the same accept counts."""
    kw = dict(spec_mode="ngram", spec_k=3, slots=2, max_len=32,
              page_size=8, seq_buckets=(8, 16), batch_buckets=(1,),
              quant="int8", kv_dtype="int8", prefill_chunk=8)
    jeng = JSP.SpeculativeServingEngine((model[1], model[0]), **kw)
    eng = SP.SpeculativeServingEngine((model[3], model[2]), device="cpu",
                                      **kw)
    rng = np.random.RandomState(12)
    pairs = [(rng.randint(1, 256, rng.randint(3, 20)).astype(np.int32),
              int(rng.randint(4, 9))) for _ in range(4)]
    rj = [jeng.submit(p, m) for p, m in pairs]
    rt = [eng.submit(p, m) for p, m in pairs]
    jeng.run(max_steps=300)
    eng.run(max_steps=300)
    assert [r.tokens for r in rt] == [r.tokens for r in rj]
    sj, st = jeng.stats(), eng.stats()
    for key in ("spec_steps", "accepted_tokens", "prefill_chunks"):
        assert st[key] == sj[key], key


def test_steady_state_builds_nothing(model):
    eng = _make_engine(model)
    eng.warmup()
    step = eng._step
    rng = np.random.RandomState(13)
    for _ in range(6):
        eng.submit(rng.randint(1, 256, rng.randint(3, 15)).astype(np.int32),
                   int(rng.randint(3, 8)))
    eng.run(max_steps=400)
    assert eng._step is step and step.captures == 0    # CPU: no graph
    assert eng.stats()["decode_compiles"] == 1


def test_spec_mode_env_default_and_validation(model, monkeypatch):
    with pytest.raises(ValueError, match="spec_mode"):
        _make_engine(model, spec_mode="turbo")
    with pytest.raises(ValueError, match="spec_k"):
        _make_engine(model, spec_k=0)
    eng = _make_engine(model)
    st = eng.stats()
    assert st["spec_mode"] == "ngram" and st["spec_k"] == 3
    assert S.PagedServingEngine(
        (model[3], model[2]), device="cpu", max_len=32,
        page_size=8).stats()["spec_mode"] is None
    for k in ("PADDLE_SPEC_MODE", "PADDLE_SPEC_K", "PADDLE_SPEC_NGRAM",
              "PADDLE_SPEC_DRAFT_SEED"):
        monkeypatch.delenv(k, raising=False)
    eng = SP.SpeculativeServingEngine((model[3], model[2]), device="cpu",
                                      max_len=32, page_size=8)
    assert (eng.spec_mode, eng.spec_k, eng._ngram_max, eng._draft_seed) == (
        "ngram", 4, 3, 0)
    monkeypatch.setenv("PADDLE_SPEC_MODE", "draft")
    monkeypatch.setenv("PADDLE_SPEC_K", "2")
    monkeypatch.setenv("PADDLE_SPEC_NGRAM", "5")
    monkeypatch.setenv("PADDLE_SPEC_DRAFT_SEED", "9")
    eng = SP.SpeculativeServingEngine((model[3], model[2]), device="cpu",
                                      max_len=32, page_size=8)
    assert (eng.spec_mode, eng.spec_k, eng._ngram_max, eng._draft_seed) == (
        "draft", 2, 5, 9)
    monkeypatch.setenv("PADDLE_SPEC_K", "lots")       # unparsable: default
    assert SP.SpeculativeServingEngine(
        (model[3], model[2]), device="cpu", max_len=32,
        page_size=8).spec_k == 4


def test_draft_vocab_mismatch_rejected(model):
    with pytest.raises(ValueError, match="vocab"):
        _make_engine(model, spec_mode="draft",
                     spec_draft_cfg={"vocab_size": 128, "hidden_size": 32,
                                     "num_layers": 1, "num_heads": 2,
                                     "dtype": "float32"})


def test_default_device_needs_a_card(model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SP.SpeculativeServingEngine((model[3], model[2]), max_len=32,
                                    page_size=8)


# --------------------------------------------------------------------------
# pool bytes against a run that never speculated
# --------------------------------------------------------------------------

def _run_pair(m, reject=None, **ekw):
    """One request through the non-speculative engine and the speculative
    one (no warmup: its synthetic pages would differ between them)."""
    kw = dict(device="cpu", slots=2, max_len=32, page_size=8,
              seq_buckets=(8, 16), batch_buckets=(1,), **ekw)
    prompt = np.arange(1, 12, dtype=np.int32)
    base = S.PagedServingEngine((m[3], m[2]), **kw)
    rb = base.submit(prompt, 8)
    base.run()
    spec = _make_engine(m, **kw)
    spec._spec_reject = reject
    rs = spec.submit(prompt, 8)
    spec.run(max_steps=200)
    assert rb.tokens == rs.tokens
    return base, spec


def _same_pools(base, spec):
    for a, b in zip(base._cache_operands(), spec._cache_operands()):
        assert torch.equal(a[:, 1:], b[:, 1:])


def test_all_reject_verify_leaves_fp_pool_bytes(model):
    base, spec = _run_pair(model, reject=lambda step: step == 2)
    assert spec.stats()["accepted_tokens"] > 0
    _same_pools(base, spec)


def test_all_reject_verifies_leave_int8_pool_and_scales(model):
    base, spec = _run_pair(model, reject=lambda step: True, quant="int8",
                           kv_dtype="int8")
    assert spec.stats()["accepted_tokens"] == 0
    _same_pools(base, spec)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_accepting_run_pool_bytes_identical(model, quant):
    """An accepting run commits the bytes the sequential decode writes
    (and on the int8 pool the same scales)."""
    kw = dict(quant="int8", kv_dtype="int8") if quant else {}
    base, spec = _run_pair(model, **kw)
    assert spec.stats()["accepted_tokens"] > 0
    _same_pools(base, spec)


# --------------------------------------------------------------------------
# preemption and aborts with speculation on
# --------------------------------------------------------------------------

def test_reset_for_retry_clears_pending_draft():
    r = S.Request(np.arange(1, 5), 4)
    assert r.pending_draft is None
    r.pending_draft = [7, 8]
    r.reset_for_retry()
    assert r.pending_draft is None


@pytest.mark.parametrize("mode", ["ngram", "self_draft"])
def test_preemption_replays_token_exact(drafted, mode):
    """Page exhaustion preempts the newest request mid-speculation; its
    retry (the draft cache re-ingested from the prompt) is token-exact."""
    kw = _self_draft(drafted) if mode == "self_draft" else {}
    eng = _make_engine(drafted, slots=2, page_size=4, num_pages=9,
                       seq_buckets=(16,), batch_buckets=(1,),
                       prefix_cache=False, **kw)
    eng.warmup()
    a = eng.submit(np.arange(1, 13, dtype=np.int32), 16)
    b = eng.submit(np.arange(3, 15, dtype=np.int32), 16)
    done = eng.run(max_steps=400)
    st = eng.stats()
    assert len(done) == 2 and a.done and b.done
    assert st["preemptions"] >= 1 and a.preemptions + b.preemptions >= 1
    _check_ref(drafted, [a, b])
    assert st["pages_in_use"] == 0 and st["decode_compiles"] == 1


def test_engine_error_abort_and_retry(drafted, monkeypatch):
    """A failed verify frees slots, pages and the draft state; retries
    are token-exact and the steps stay built."""
    eng = _make_engine(drafted, slots=2, batch_buckets=(1,),
                       **_self_draft(drafted))
    eng.warmup()
    a = eng.submit(np.arange(1, 8, dtype=np.int32), 12)
    b = eng.submit(np.arange(2, 9, dtype=np.int32), 12)
    real = SP._VerifyStep.__call__
    calls = {"n": 0}

    def flaky(step, before=None):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected verify failure")
        return real(step, before)
    monkeypatch.setattr(SP._VerifyStep, "__call__", flaky)
    draft_k = eng._draft_k
    with pytest.raises(RuntimeError, match="injected"):
        eng.run(max_steps=300)
    victims = eng.take_aborted()
    assert victims
    assert eng.stats()["pages_in_use"] == 0
    assert eng._draft_k is draft_k and not draft_k.any()   # zeroed in place
    assert not eng._draft_lens.any()
    for v in victims:
        eng.submit(v.reset_for_retry())
    eng.run(max_steps=300)
    _check_ref(drafted, [a, b])
    st = eng.stats()
    assert st["decode_compiles"] == 1 and st["spec_draft_compiles"] == 2


@pytest.mark.parametrize("reject", [False, True], ids=["accepting",
                                                        "all_reject"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_each_verify_writes_only_its_committed_positions(model, quant,
                                                         reject):
    """Per verify: the pool changes only at the positions it committed
    (``lens[s] .. lens[s] + n_commit[s] - 1`` of each active row) and on
    scratch page 0.  The end-state byte tests cannot see a rejected lane
    written past the commit, since a later verify overwrites it."""
    kw = dict(quant="int8", kv_dtype="int8") if quant else {}
    eng = _make_engine(model, **kw)
    if reject:
        eng._spec_reject = lambda step: True
    seen = []
    rng = np.random.RandomState(21)
    reqs = [eng.submit(rng.randint(1, 256, rng.randint(3, 15)).astype(
        np.int32), int(rng.randint(4, 9))) for _ in range(5)]
    with commit_write_probe(eng, seen):
        eng.run(max_steps=300)
    assert len(seen) == eng.stats()["spec_steps"] > 0
    assert not any(bad for bad, _ in seen), seen
    assert (eng.stats()["accepted_tokens"] == 0) == reject
    if not quant:
        _check_ref(model, reqs)
