"""paddle_tpu_torch's chunked prefill against the JAX package on the CPU.

The same numpy-drawn weights and inputs go through ``paddle_tpu.models.gpt.
forward_paged_chunk`` (and its int8 twin) and the port's, and through the
two packages' ``PagedServingEngine(prefill_chunk=...)``.

Tolerances:

* one chunk, fp32: logits and the pool within 1e-5 of the reference's;
  pages the chunk does not reach, and the prefix-hit pages it is told
  to leave, keep their bytes exactly;
* one chunk, int8 pool: scales within 1e-5 relative; codes equal but for
  rounding midpoints that a 1e-7 difference moves (at most 0.1% of them,
  by one), as in ``test_torch_quant.py``;
* engines, fp32: greedy tokens exact against the JAX engine and
  ``generate``, captured logits within 1e-3 of the JAX engine's (the
  tolerance of ``test_torch_quant.py``'s engine parity); the int8 engine
  against the port's fp32 engine: tokens exact, logits within 0.05 (the
  JAX suite's ``LOGIT_BUDGET``).
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import serving as JS
from paddle_tpu.models import gpt as J
from paddle_tpu_torch.inference import serving as S
from paddle_tpu_torch.models import gpt as T
from test_torch_gpt import numpy_params

FP32_TOL = 1e-5
ENGINE_LOGIT_TOL = 1e-3
LOGIT_BUDGET = 0.05
CODE_FLIP_SHARE = 1e-3


def _cfg(mod):
    return mod.GPTConfig(vocab_size=256, hidden_size=32, num_layers=2,
                         num_heads=2, max_seq_len=64, dtype="float32",
                         use_flash=False, remat=False,
                         **({"use_pallas_norm": True} if mod is T else {}))


@pytest.fixture(scope="module")
def model():
    jcfg = _cfg(J)
    tree = numpy_params(jcfg, 0)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, jp, _cfg(T), T.params_from_numpy(tree, "cpu")


def _reference(model, prompts, n):
    """JAX greedy continuations, one batched ``generate`` per length."""
    jcfg, jp, _, _ = model
    by_len = collections.defaultdict(list)
    for i, p in enumerate(prompts):
        by_len[len(p)].append(i)
    out = [None] * len(prompts)
    for ln, idx in by_len.items():
        res = np.asarray(J.generate(
            jp, jcfg, jnp.asarray(np.stack([prompts[i] for i in idx])), n))
        for r, i in enumerate(idx):
            out[i] = res[r, ln:].tolist()
    return out


def _engine(model, **kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("slots", 3)
    kw.setdefault("max_len", 32)
    kw.setdefault("page_size", 8)
    kw.setdefault("seq_buckets", (8, 16))
    kw.setdefault("batch_buckets", (1, 2))
    kw.setdefault("prefill_chunk", 8)
    return S.PagedServingEngine((model[3], model[2]), **kw)


def _jax_engine(model, **kw):
    for k, v in (("slots", 3), ("max_len", 32), ("page_size", 8),
                 ("seq_buckets", (8, 16)), ("batch_buckets", (1, 2)),
                 ("prefill_chunk", 8)):
        kw.setdefault(k, v)
    return JS.PagedServingEngine((model[1], model[0]), **kw)


def _trace(n=8, seed=3, vocab=256):
    """The JAX quant suite's mixed traffic (3-14 token prompts, 3-7 new
    tokens): wave and chunked admissions at prefill_chunk 8."""
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, vocab, rng.randint(3, 15)).astype(np.int32),
             int(rng.randint(3, 8))) for _ in range(n)]


# --------------------------------------------------------------------------
# one chunk
# --------------------------------------------------------------------------

def _pool(seed, L=2, P=14, ps=8, nh=2, hd=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((L, P, ps, nh, hd)).astype(np.float32)
            for _ in range(2)]


# slot 0's row shares pages 2 and 3 with another slot's row [2, 3, 11, 0]
ROW = np.array([2, 3, 5, 9], np.int32)


@pytest.mark.parametrize("offset", [0, 8, 16])
def test_forward_paged_chunk_matches_reference(model, offset):
    jcfg, jp, tcfg, tp = model
    ck, cv = _pool(offset)
    toks = np.random.default_rng(7).integers(0, 256, (1, 8)).astype(
        np.int32)
    lj, kj, vj = J.forward_paged_chunk(
        jp, jnp.asarray(toks), jcfg, jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(ROW), jnp.int32(offset))
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    with torch.inference_mode():
        lt, kt, vt = T.forward_paged_chunk(
            T.prepare_params(tp, tcfg), torch.from_numpy(toks), tcfg, tk, tv,
            torch.from_numpy(ROW), offset)
    assert kt is tk and vt is tv                    # written in place
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=FP32_TOL)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), rtol=0,
                               atol=FP32_TOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0,
                               atol=FP32_TOL)
    # every page the chunk does not reach (the shared prefix pages before
    # the offset, pages after it, pages of no row) keeps its bytes
    reached = {int(ROW[j]) for j in range(offset // 8, offset // 8 + 1)}
    for pid in range(ck.shape[1]):
        if pid not in reached:
            assert np.array_equal(kt[:, pid].numpy(), ck[:, pid]), pid
            assert np.array_equal(vt[:, pid].numpy(), cv[:, pid]), pid


@pytest.mark.parametrize("offset", [0, 8, 16])
def test_forward_paged_chunk_quant_matches_reference(model, offset):
    jcfg, jp, tcfg, tp = model
    ck, cv = _pool(offset + 1)
    kq, ks = J.quantize_kv(jnp.asarray(ck))
    vq, vs = J.quantize_kv(jnp.asarray(cv))
    pool = [np.array(a) for a in (kq, ks, vq, vs)]
    toks = np.random.default_rng(8).integers(0, 256, (1, 8)).astype(
        np.int32)
    want = J.forward_paged_chunk_quant(
        jp, jnp.asarray(toks), jcfg, *map(jnp.asarray, pool),
        jnp.asarray(ROW), jnp.int32(offset))
    tpool = [torch.from_numpy(a.copy()) for a in pool]
    with torch.inference_mode():
        got = T.forward_paged_chunk_quant(
            T.prepare_params(tp, tcfg), torch.from_numpy(toks), tcfg,
            *tpool, torch.from_numpy(ROW), offset)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=FP32_TOL)
    for g, w in ((got[1], want[1]), (got[3], want[3])):     # codes
        d = np.abs(g.numpy().astype(np.int32)
                   - np.asarray(w).astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= CODE_FLIP_SHARE
    for g, w in ((got[2], want[2]), (got[4], want[4])):     # scales
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=FP32_TOL,
                                   atol=0)
    # only the chunk's own page is written: earlier positions never
    # round-trip through the quantizer
    page = int(ROW[offset // 8])
    for t, a in zip(tpool, pool):
        keep = [p for p in range(a.shape[1]) if p != page]
        assert np.array_equal(t.numpy()[:, keep], a[:, keep])


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_forward_paged_chunk_leaves_held_pages(model, quant):
    """A chunk over two pages, the first held (a prefix hit): the held
    page keeps its bytes, the other page and the logits are as without
    ``held``."""
    _, _, tcfg, tp = model
    ck, cv = _pool(5, ps=4)
    pool = [torch.from_numpy(a) for a in (ck, cv)]
    if quant:
        pool = [t for a in pool for t in T.quantize_kv(a)]
        fn = T.forward_paged_chunk_quant
    else:
        fn = T.forward_paged_chunk
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, 256, (1, 8)).astype(np.int32))
    row = torch.from_numpy(np.array([6, 2, 3, 5, 9, 0, 0, 0], np.int32))
    prep = T.prepare_params(tp, tcfg)
    with torch.inference_mode():
        free = [t.clone() for t in pool]
        lf, *_ = fn(prep, toks, tcfg, *free, row, 8)
        held = [t.clone() for t in pool]
        lh, *_ = fn(prep, toks, tcfg, *held, row, 8,
                    held=[True, True, True, False])
    assert torch.equal(lf, lh)
    for f, h, a in zip(free, held, pool):
        assert torch.equal(h[:, 3], a[:, 3])             # held: untouched
        assert not torch.equal(f[:, 3], a[:, 3])
        assert torch.equal(h[:, 5], f[:, 5])             # written alike
        keep = [p for p in range(a.shape[1]) if p not in (3, 5)]
        assert torch.equal(h[:, keep], a[:, keep])


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_chunked_engine_matches_jax_engine(model, quant):
    """Mixed traffic, wave and chunked admissions, churn: the port's
    chunked engine against the JAX one (and the fp one against
    ``generate``)."""
    kw = dict(quant="int8", kv_dtype="int8") if quant else {}
    eng = _engine(model, capture_logits=True, **kw)
    jeng = _jax_engine(model, capture_logits=True, **kw)
    assert eng.warmup() >= 1
    jeng.warmup()
    trace = _trace(10)
    rt = [eng.submit(p, m) for p, m in trace]
    rj = [jeng.submit(p, m) for p, m in trace]
    eng.run()
    jeng.run()
    st, sj = eng.stats(), jeng.stats()
    assert st["prefill_chunks"] == sj["prefill_chunks"] > 0
    assert st["decode_steps"] == sj["decode_steps"]
    assert st["decode_compiles"] == 1
    assert st["pages_in_use"] == 0 and st["kv_tokens_held"] == 0
    err = 0.0
    for a, b in zip(rt, rj):
        assert a.tokens == b.tokens, a.id
        for la, lb in zip(a.logits, b.logits):
            err = max(err, float(np.abs(la - lb).max()))
    assert err <= ENGINE_LOGIT_TOL, err
    if not quant:
        by_n = collections.defaultdict(list)
        for i, (p, m) in enumerate(trace):
            by_n[m].append(i)
        for m, idx in by_n.items():
            want = _reference(model, [trace[i][0] for i in idx], m)
            assert [rt[i].tokens for i in idx] == want


def test_chunked_prefill_interleaves_decode(model):
    """While a long prompt comes in chunk by chunk, the in-flight decode
    advances between every two chunks (``test_paged_serving.py``'s
    interleaving test)."""
    eng = _engine(model, capture_logits=True)
    eng.warmup()
    short = eng.submit(np.arange(1, 6, dtype=np.int32), 12)
    eng.step()
    long_prompt = np.arange(40, 62, dtype=np.int32)      # 22 tokens: 3 chunks
    long_req = eng.submit(long_prompt, 4)
    trace = []
    while not (short.done and long_req.done):
        eng.step()
        st = eng.stats()
        trace.append((st["prefill_chunks"], st["decode_steps"]))
    assert max(c for c, _ in trace) == 3
    for (c0, d0), (c1, d1) in zip(trace, trace[1:]):
        if c1 > c0 and c0 > 0:
            assert d1 > d0, trace
    assert long_req.tokens == _reference(model, [long_prompt], 4)[0]
    assert short.tokens == _reference(model, [short.prompt], 12)[0]
    assert len(long_req.logits) == 4


def test_chunked_and_wave_admission_agree(model):
    """The same long prompts through chunks and through one wave: the
    same tokens (prefix cache off, so each engine computes every page)."""
    prompts = [np.arange(3, 25, dtype=np.int32),
               np.arange(50, 64, dtype=np.int32)]
    a = _engine(model, prefix_cache=False, seq_buckets=(8, 16, 32))
    b = _engine(model, prefix_cache=False, seq_buckets=(8, 16, 32),
                prefill_chunk=None)
    assert a.generate(prompts, 6) == b.generate(prompts, 6)
    assert a.stats()["prefill_chunks"] == 5 and b.stats()[
        "prefill_chunks"] == 0


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_shared_prefix_pages_keep_their_bytes(model, quant):
    """A second identical long prompt shares the first's registered pages
    and its chunks rewrite them: the bytes must not change (the pager's
    content-hash contract), and both requests decode alike."""
    kw = dict(quant="int8", kv_dtype="int8") if quant else {}
    eng = _engine(model, page_size=4, prefill_chunk=8, seq_buckets=(8,),
                  **kw)
    prompt = np.arange(7, 29, dtype=np.int32)            # 22: 3 chunks
    r1 = eng.submit(prompt, 3)
    eng.run()
    table = list(eng._pager._cache.values())
    snap = [p[:, table].clone() for p in eng._cache_operands()]
    r2 = eng.submit(prompt, 3)
    hits = eng.stats()["prefix_page_hits"]
    eng.run()
    # 5 full pages and the tail, registered once the whole prompt is in
    assert eng.stats()["prefix_page_hits"] - hits == 6
    for p, s in zip(eng._cache_operands(), snap):
        assert torch.equal(p[:, table], s)
    assert r1.tokens == r2.tokens == _reference(model, [prompt], 3)[0]


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_wave_written_prefix_page_keeps_its_bytes(model, quant):
    """Two prompts of ``prefill_chunk`` tokens come in by one wave; a
    longer prompt that shares the first one's page comes in by chunks
    while both still decode.  Its chunks recompute that page at another
    row count, so they must leave it as the wave wrote it; every
    request's tokens are the reference's."""
    kw = dict(quant="int8", kv_dtype="int8") if quant else {}
    eng = _engine(model, **kw)
    rng = np.random.default_rng(12)
    a, c = (rng.integers(1, 256, 8).astype(np.int32) for _ in range(2))
    b = np.concatenate([a, rng.integers(1, 256, 13).astype(np.int32)])
    ra, rc = eng.submit(a, 10), eng.submit(c, 10)
    eng.step()
    assert eng.stats()["prefill_calls"] == 1 and ra.slot is not None
    page = int(eng._tables_np[ra.slot, 0])
    assert eng._page_registered(page)
    snap = [p[:, page].clone() for p in eng._cache_operands()]
    hits = eng.stats()["prefix_page_hits"]
    rb = eng.submit(b, 4)
    while eng.stats()["prefill_chunks"] < 3:
        eng.step()
    assert eng.stats()["prefix_page_hits"] - hits == 1
    assert not (ra.done or rc.done)
    assert int(eng._tables_np[rb.slot, 0]) == page
    for p, s in zip(eng._cache_operands(), snap):
        assert torch.equal(p[:, page], s)
    eng.run()
    assert ra.tokens == _reference(model, [a], 10)[0]
    assert rc.tokens == _reference(model, [c], 10)[0]
    assert rb.tokens == _reference(model, [b], 4)[0]


def test_quantized_chunked_engine_within_budget(model):
    """int8 weights and pool against the port's fp32 engine over churned
    mixed traffic, chunked (``test_quant_serving.py``'s budget test)."""
    fp = _engine(model, capture_logits=True)
    q = _engine(model, capture_logits=True, quant="int8", kv_dtype="int8")
    fp.warmup()
    assert q.warmup() >= 1
    trace = _trace(10)
    rf = [fp.submit(p, m) for p, m in trace]
    rq = [q.submit(p, m) for p, m in trace]
    fp.run()
    q.run()
    st = q.stats()
    assert st["decode_compiles"] == 1
    assert st["slot_occupancy_peak"] >= 2
    err = 0.0
    for a, b in zip(rf, rq):
        assert a.tokens == b.tokens, a.id
        for la, lb in zip(a.logits, b.logits):
            err = max(err, float(np.abs(la - lb).max()))
    assert 0 < err <= LOGIT_BUDGET, err
    assert st["pages_in_use"] == 0
    assert st["quant_matmuls"] > 0 and st["kv_quant_bytes_saved"] > 0
    assert st["prefill_chunks"] > 0


def test_quantized_chunked_steady_state_builds_nothing(model):
    """After warmup the decode step is built and traffic with chunked
    admissions builds nothing more (``test_quant_serving.py``'s zero
    steady-state compiles)."""
    q = _engine(model, quant="int8", kv_dtype="int8")
    q.warmup()
    step = q._step
    assert q.stats()["decode_compiles"] == 1 and step is not None
    for p, m in _trace(8, seed=11):
        q.submit(p, m)
    q.run()
    assert q._step is step and q.stats()["decode_compiles"] == 1
    assert step.captures == 0                      # CPU: no graph


def test_prefill_chunk_validation(model):
    eng = _engine(model, prefill_chunk=5)          # rounded up to a page
    assert eng._prefill_chunk == 8
    with pytest.raises(ValueError, match="largest prefill bucket"):
        _engine(model, prefill_chunk=24)
    with pytest.raises(ValueError, match="must divide max_len"):
        _engine(model, max_len=40, seq_buckets=(8, 24), prefill_chunk=24)
    # a chunk-eligible prompt skips the bucket ladder's limit
    eng = _engine(model, seq_buckets=(8,))
    r = eng.submit(np.arange(1, 21, dtype=np.int32), 4)
    eng.run()
    assert r.tokens == _reference(model, [r.prompt], 4)[0]
    with pytest.raises(ValueError, match="largest prefill bucket"):
        _engine(model, seq_buckets=(8,), prefill_chunk=None).submit(
            np.arange(1, 21, dtype=np.int32), 4)


def test_preempted_chunk_job_retries_exactly(model):
    """A mid-chunk admission preempted on page exhaustion goes back to
    the queue head and replays token-exact."""
    eng = _engine(model, slots=2, page_size=4, num_pages=11,
                  seq_buckets=(8,), batch_buckets=(1,), prefix_cache=False)
    prompts = [np.arange(1, 7, dtype=np.int32),
               np.arange(30, 50, dtype=np.int32)]
    a, b = eng.submit(prompts[0], 20), eng.submit(prompts[1], 8)
    eng.run(max_steps=400)
    st = eng.stats()
    assert a.done and b.done and st["preemptions"] >= 1
    assert a.tokens == _reference(model, [prompts[0]], 20)[0]
    assert b.tokens == _reference(model, [prompts[1]], 8)[0]
    assert st["pages_in_use"] == 0 and not eng._chunk_jobs


def test_abort_mid_chunk_frees_the_job(model, monkeypatch):
    eng = _engine(model)
    eng.warmup()
    req = eng.submit(np.arange(2, 26, dtype=np.int32), 4)
    real = eng._chunk
    calls = {"n": 0}

    def flaky(*a):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected chunk failure")
        return real(*a)
    monkeypatch.setattr(eng, "_chunk", flaky)
    with pytest.raises(RuntimeError, match="injected"):
        eng.run()
    assert eng.take_aborted() == [req]
    assert not eng._chunk_jobs and not eng._chunk_slots
    assert eng.stats()["pages_in_use"] == 0
    eng.submit(req.reset_for_retry())
    eng.run()
    assert req.tokens == _reference(model, [req.prompt], 4)[0]
    assert eng.stats()["decode_compiles"] == 1
