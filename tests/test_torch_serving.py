"""paddle_tpu_torch PagedServingEngine against paddle_tpu's greedy
``generate``.

One small fp32 model (weights drawn with numpy in the JAX layout, carried
into the port by its numpy bridge) is served by the port's engine on the CPU,
where the kernels take their plain versions.  Every request's tokens must
equal the JAX ``models.gpt.generate`` continuation exactly: under churn
(more requests than slots), on a shared-prefix hit that allocates no new
pages, with two in-flight requests on one prefix (copy-on-write), and
after a preemption on page exhaustion.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import gpt as J
from paddle_tpu_torch.inference import serving as S
from paddle_tpu_torch.models import gpt as T
from paddle_tpu_torch.ops.cuda import norms, paged_attn
from test_torch_gpt import numpy_params


def _cfg(mod):
    return mod.GPTConfig(vocab_size=256, hidden_size=32, num_layers=2,
                         num_heads=2, max_seq_len=64, dtype="float32",
                         use_flash=False, remat=False, use_pallas_norm=True)


@pytest.fixture(scope="module")
def model():
    jcfg = _cfg(J)
    tree = numpy_params(jcfg, 0)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = T.params_from_numpy(tree, "cpu")
    return jcfg, jp, _cfg(T), tp


def _reference(model, prompts, n):
    """JAX greedy continuations, one batched ``generate`` per prompt
    length."""
    jcfg, jp, _, _ = model
    by_len = collections.defaultdict(list)
    for i, p in enumerate(prompts):
        by_len[len(p)].append(i)
    out = [None] * len(prompts)
    for ln, idx in by_len.items():
        batch = jnp.asarray(np.stack([prompts[i] for i in idx]))
        res = np.asarray(J.generate(jp, jcfg, batch, n))
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
    return S.PagedServingEngine((model[3], model[2]), **kw)


def test_churn_token_exact_and_pool_drained(model):
    eng = _engine(model, slots=2, capture_logits=True)
    assert eng.stats()["decode_compiles"] == 0
    assert eng.warmup() >= 1
    assert eng.stats()["decode_compiles"] == 1       # built in warmup
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 256, (5 if i % 2 else 11,)).astype(np.int32)
               for i in range(6)]
    before = (paged_attn.launches, norms.launches)
    reqs = [eng.submit(p, 6) for p in prompts]
    done = eng.run()
    st = eng.stats()
    assert len(done) == 6 and all(r.done for r in reqs)
    assert st["slot_occupancy_peak"] == 2          # churn really batched
    assert st["requests_completed"] == 6 and st["tokens_generated"] == 36
    assert [r.tokens for r in reqs] == _reference(model, prompts, 6)
    assert all(len(r.logits) == 6 for r in reqs)
    assert st["pages_in_use"] == 0 and st["kv_tokens_held"] == 0
    assert st["decode_compiles"] == 1               # through churn
    # CPU tensors: the wrappers took their plain versions, uncaptured
    assert (paged_attn.launches, norms.launches) == before
    assert eng._step.captures == 0


def test_prefix_hit_allocates_no_new_pages(model):
    eng = _engine(model, page_size=4)
    eng.warmup()
    prompt = np.arange(1, 11, dtype=np.int32)      # 10 tokens: 3 pages
    r1 = eng.submit(prompt, 4)
    eng.run()
    s1 = eng.stats()
    r2 = eng.submit(prompt, 4)
    eng.run()
    s2 = eng.stats()
    assert s2["prefix_page_hits"] - s1["prefix_page_hits"] == 3
    assert s2["prefix_page_misses"] - s1["prefix_page_misses"] == 0
    assert r1.tokens == r2.tokens == _reference(model, [prompt], 4)[0]
    assert s2["decode_compiles"] == 1


def test_concurrent_shared_prefix_copy_on_write(model):
    eng = _engine(model, page_size=4)
    eng.warmup()
    prompt = np.arange(20, 30, dtype=np.int32)
    ra, rb = eng.submit(prompt, 6), eng.submit(prompt, 6)
    eng.run()
    assert eng.stats()["cow_copies"] >= 1
    want = _reference(model, [prompt], 6)[0]
    assert ra.tokens == want and rb.tokens == want


def test_page_exhaustion_preempts_newest_and_retries_exactly(model):
    eng = _engine(model, slots=2, page_size=4, num_pages=9,  # 32 positions
                  seq_buckets=(16,), batch_buckets=(1,), prefix_cache=False)
    eng.warmup()
    prompts = [np.arange(1, 13, dtype=np.int32),
               np.arange(3, 15, dtype=np.int32)]
    a, b = (eng.submit(p, 16) for p in prompts)
    done = eng.run(max_steps=400)
    st = eng.stats()
    assert len(done) == 2 and a.done and b.done
    assert st["preemptions"] >= 1
    assert a.preemptions + b.preemptions >= 1
    assert [a.tokens, b.tokens] == _reference(model, prompts, 16)
    assert st["pages_in_use"] == 0
    assert st["decode_compiles"] == 1               # through preemption


def test_failed_step_aborts_and_rebuilds_pool(model, monkeypatch):
    eng = _engine(model)
    eng.warmup()
    prompt = np.arange(5, 12, dtype=np.int32)
    req = eng.submit(prompt, 5)
    real = eng._decode
    calls = {"n": 0}

    def flaky(*a):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected decode failure")
        return real(*a)
    monkeypatch.setattr(eng, "_decode", flaky)
    pools = (eng._cache_k, eng._cache_v)
    ptrs = [t.data_ptr() for t in pools]
    with pytest.raises(RuntimeError, match="injected"):
        eng.run()
    assert eng.take_aborted() == [req] and req.failed
    st = eng.stats()
    assert st["step_aborts"] == 1 and st["slot_occupancy"] == 0
    assert st["pages_in_use"] == 0
    # the pool is zeroed in place, not reallocated: the decode step (a
    # CUDA graph on the card) keeps its storage
    assert eng._cache_k is pools[0] and eng._cache_v is pools[1]
    assert [t.data_ptr() for t in pools] == ptrs
    assert not eng._cache_k.any() and not eng._cache_v.any()
    eng.submit(req.reset_for_retry())
    eng.run()
    assert req.tokens == _reference(model, [prompt], 5)[0]
    assert eng.stats()["decode_compiles"] == 1       # through the abort


def test_decode_step_is_built_once_over_static_buffers(model):
    """The decode step is one object per engine: its device inputs are
    slices of one buffer that keeps its storage from step to step, fed by
    one staging array whose views hold this step's page table, write
    coordinates, lens and tokens; its eager step on the CPU gives the
    port's ``decode_step_paged`` result on the same inputs."""
    eng = _engine(model, slots=2)
    prompts = [np.arange(3, 12, dtype=np.int32),
               np.arange(40, 45, dtype=np.int32)]
    for p in prompts:
        eng.submit(p, 6)
    eng.step()
    st = eng._step
    ptrs = [a.data_ptr() for a in st._args]
    base = st._in.data_ptr()
    assert ptrs == [base + 4 * o for o in (0, 2 * 4, 2 * 4 + 2, 2 * 4 + 4,
                                           2 * 4 + 6)]
    for _ in range(3):
        eng.step()
        assert eng._step is st and [a.data_ptr() for a in st._args] == ptrs
        host = (st.tables, st.wpages, st.woffs, st.lens, st.toks)
        for dev, h in zip(st._args, host):
            np.testing.assert_array_equal(dev.numpy(), h)
        # the staged lens and tokens were this step's inputs
        np.testing.assert_array_equal(st.lens, eng._lens - 1)
    # a call from outside the engine (no inference mode around it) repeats
    # the staged step
    again, _ = st()
    np.testing.assert_array_equal(again, eng._last_tok)
    cfg, params = eng.cfg, eng.params
    pool = [t.clone() for t in (eng._cache_k, eng._cache_v)]
    with torch.inference_mode():
        want, *_ = T.decode_step_paged(params, st._args[4], cfg, *pool,
                                       *st._args[:4])
        got = st._run()[1]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    eng.run()
    assert eng.stats()["decode_compiles"] == 1


def test_eos_and_queue_bounds(model):
    eng = _engine(model, max_queue=2)
    eng.warmup()
    prompt = np.arange(1, 7, dtype=np.int32)
    want = _reference(model, [prompt], 8)[0]
    r = eng.submit(prompt, 8, eos_token=want[2])
    eng.submit(prompt, 2)
    with pytest.raises(S.ServingQueueFull):
        eng.submit(prompt, 2)
    eng.run()
    first = want.index(want[2])
    assert r.finish_reason == "eos" and r.tokens == want[:first + 1]
    assert eng.stats()["queue_rejects"] == 1


def test_generate_drains_a_batch_past_the_queue_bound(model):
    eng = _engine(model, slots=2, max_queue=2)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 256, (n,)).astype(np.int32)
               for n in (4, 9, 4, 6, 13)]
    assert eng.generate(prompts, 5) == _reference(model, prompts, 5)
    assert eng.stats()["queue_rejects"] == 0


@pytest.mark.parametrize("kw", [
    {"host_tier_mb": 4}, {"kv_handoff": True}, {"tp": 2}, {"pp": 2}])
def test_out_of_slice_knobs_are_refused_by_name(model, kw):
    name = next(iter(kw))
    with pytest.raises(NotImplementedError, match=name):
        _engine(model, **kw)


def test_refusals_and_device_default(model, monkeypatch):
    # the slot-contiguous engine serves; sharding stays refused on both
    slot = S.ServingEngine((model[3], model[2]), device="cpu", slots=2,
                           max_len=32)
    prompt = np.arange(1, 7, dtype=np.int32)
    assert slot.generate([prompt], 3) == _reference(model, [prompt], 3)
    for kw in ({"tp": 2}, {"pp": 2}):
        with pytest.raises(NotImplementedError, match=next(iter(kw))):
            S.ServingEngine((model[3], model[2]), device="cpu", **kw)
    eng = _engine(model)
    with pytest.raises(NotImplementedError, match="submit_prefilled"):
        eng.submit_prefilled(None, 0, None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.PagedServingEngine((model[3], model[2]), slots=2, max_len=32,
                             page_size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.ServingEngine((model[3], model[2]), slots=2, max_len=32)
