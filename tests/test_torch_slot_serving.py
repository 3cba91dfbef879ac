"""paddle_tpu_torch's slot-contiguous ``ServingEngine`` against the JAX
package's on the CPU, the counterpart of the engine cases of
``tests/test_inference_predictor.py``.

One small fp32 model (weights drawn with numpy in the JAX layout, carried
into the port by its numpy bridge) is served by both packages' engines
with the same knobs, and by the JAX ``models.gpt.generate``.

Tolerances:

* tokens: exact against the JAX engine and ``generate``;
* ``capture_logits`` rows: within 1e-5 of the JAX engine's in fp32, and
  within 1e-3 with quantized weights (``tests/test_torch_quant.py``'s
  engine tolerance: two forwards that differ by about 1e-7 can move a
  value across a quantization midpoint);
* counters: ``prefill_compiles``, ``decode_compiles``, ``prefill_calls``,
  ``decode_steps``, ``requests_admitted``, ``tokens_generated`` and the
  KV accounting equal the JAX engine's;
* the pool after a wave whose pad rows scatter over a real row's slot:
  within 1e-5 of the JAX engine's pool.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.inference import serving as JS
from paddle_tpu.models import gpt as J
from paddle_tpu_torch.inference import serving as S
from paddle_tpu_torch.models import gpt as T
from test_torch_gpt import numpy_params

FP32_TOL = 1e-5
QUANT_LOGIT_TOL = 1e-3
V = 128

COUNTERS = ("prefill_compiles", "decode_compiles", "prefill_calls",
            "decode_steps", "requests_admitted", "tokens_generated",
            "requests_completed", "queue_rejects", "quant_matmuls",
            "kv_bytes_reserved", "kv_tokens_held", "slot_occupancy",
            "slot_occupancy_peak", "queue_depth")


def _cfg(mod):
    return mod.GPTConfig(vocab_size=V, hidden_size=32, num_layers=2,
                         num_heads=2, max_seq_len=64, dtype="float32",
                         use_flash=False, remat=False,
                         **({"use_pallas_norm": True} if mod is T else {}))


@pytest.fixture(scope="module")
def model():
    """(jax cfg, jax params, port cfg, numpy tree): numpy weights."""
    jcfg = _cfg(J)
    tree = numpy_params(jcfg, 7)
    return jcfg, jax.tree_util.tree_map(jnp.asarray, tree), _cfg(T), tree


def _kw(kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 48)
    kw.setdefault("seq_buckets", (8, 16))
    kw.setdefault("batch_buckets", (1, 2))
    return kw


def _port(model, **kw):
    return S.ServingEngine((T.params_from_numpy(model[3], "cpu"), model[2]),
                           device="cpu", **_kw(kw))


def _pair(model, **kw):
    """The JAX engine and the port's on the same weights and knobs."""
    return (JS.ServingEngine((model[1], model[0]), **_kw(dict(kw))),
            _port(model, **kw))


def _prompts(n, lo=3, hi=14, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, V, rng.randint(lo, hi)).astype(np.int32)
            for _ in range(n)]


def _generate(model, prompt, n):
    out = np.asarray(J.generate(model[1], model[0],
                                jnp.asarray(prompt)[None], n))
    return out[0, len(prompt):].tolist()


def _both(je, te, prompts, mnts, **kw):
    jr = [je.submit(p, m, **kw) for p, m in zip(prompts, mnts)]
    tr = [te.submit(p, m, **kw) for p, m in zip(prompts, mnts)]
    je.run()
    te.run()
    return jr, tr


def _assert_agree(je, te, jr, tr, tol=FP32_TOL):
    for a, b in zip(jr, tr):
        assert a.done and b.done
        assert a.tokens == b.tokens, (a.tokens, b.tokens)
        assert a.finish_reason == b.finish_reason
        if a.logits is not None:
            err = max(float(np.abs(x - y).max())
                      for x, y in zip(a.logits, b.logits))
            assert err <= tol, err
    js, ts = je.stats(), te.stats()
    for k in COUNTERS:
        assert ts[k] == js[k], (k, ts[k], js[k])


def test_staggered_admission_release_and_parity(model):
    """7 staggered-length requests through 2 slots: every slot is reused,
    finished slots re-admit at once, the decode step is built once, and
    each request's tokens equal the JAX engine's and ``generate``'s."""
    je, te = _pair(model, capture_logits=True)
    prompts = _prompts(7, seed=11)
    rng = np.random.RandomState(11)
    mnts = [int(rng.randint(2, 7)) for _ in prompts]
    jr, tr = _both(je, te, prompts, mnts)
    _assert_agree(je, te, jr, tr)
    st = te.stats()
    assert st["slot_occupancy_peak"] == 2 and st["decode_compiles"] == 1
    assert st["slot_occupancy"] == 0 and st["queue_depth"] == 0
    for p, m, r in zip(prompts, mnts, tr):
        assert r.tokens == _generate(model, p, m), r.id
        assert r.finish_reason == "length"
        assert r.latency() is not None and r.latency() >= 0
        assert (r.output[:len(p)] == p).all()
        assert len(r.logits) == m
    # CPU tensors: the steps ran eagerly over their buffers, uncaptured
    assert te._step.captures == 0
    assert all(w.captures == 0 for w in te._waves.values())


def test_prefill_ladder_bounds_compiles(model):
    """warmup() builds every ladder rung (the count the JAX engine's
    warmup returns); traffic after it builds no prefill step."""
    je, te = _pair(model)
    ladder = len(te.seq_buckets) * len(te.batch_buckets)
    got, want = te.warmup(), je.warmup()
    assert got == want <= ladder
    assert sorted(te._waves) == [(b, s) for b in te.batch_buckets
                                 for s in te.seq_buckets]
    assert te.stats()["prefill_compiles"] == got
    before = te.stats()["prefill_compiles"]
    jr, tr = _both(je, te, _prompts(9, lo=3, hi=16, seed=13), [2] * 9)
    _assert_agree(je, te, jr, tr)
    assert te.stats()["prefill_compiles"] == before
    assert te.stats()["decode_compiles"] == 1
    # a second warmup builds nothing
    assert te.warmup() == je.warmup() == 0


def test_warmup_covers_tight_top_rung(model):
    """A top rung whose prompts fit only with a smaller max_new_tokens
    (prompt 15 + 1 new on a max_len-16 ladder) is warmed too."""
    je, te = _pair(model, max_len=16, seq_buckets=(8, 14, 16),
                   batch_buckets=(1,))
    assert te.warmup() == je.warmup() == 3
    before = te.stats()["prefill_compiles"]
    jr, tr = _both(je, te, [np.ones((15,), np.int32)], [1])
    assert tr[0].done and len(tr[0].tokens) == 1
    assert te.stats()["prefill_compiles"] == before
    _assert_agree(je, te, jr, tr)


def test_warmup_ignores_small_max_queue(model):
    """Back-pressure is for traffic, not boot: a 4-wide warmup wave with
    max_queue 2 does not raise, and the cap comes back."""
    kw = dict(slots=4, seq_buckets=(8,), batch_buckets=(1, 2, 4),
              max_queue=2)
    je, te = _pair(model, **kw)
    assert te.warmup() == je.warmup() == 3
    assert te.max_queue == 2 and te.stats()["queue_rejects"] == 0
    p = _prompts(1, seed=23)[0]
    for _ in range(te.max_queue):
        te.submit(p, 2)
    with pytest.raises(S.ServingQueueFull):
        te.submit(p, 2)
    te.run()


def test_queue_backpressure(model):
    te = _port(model, slots=1, max_queue=2)
    p = _prompts(1, seed=17)[0]
    te.submit(p, 2)
    te.submit(p, 2)
    with pytest.raises(S.ServingQueueFull):
        te.submit(p, 2)
    assert te.stats()["queue_rejects"] == 1
    te.run()                        # drain frees the queue again
    r = te.submit(p, 2)
    te.run()
    assert r.tokens == _generate(model, p, 2)


def test_generate_larger_than_queue(model):
    """generate() absorbs a batch past max_queue by stepping the engine
    between submissions."""
    je, te = _pair(model, slots=1, max_queue=2)
    prompts = _prompts(6, seed=37)
    got = te.generate(prompts, max_new_tokens=2)
    assert got == je.generate(prompts, max_new_tokens=2)
    assert got == [_generate(model, p, 2) for p in prompts]
    assert te.stats()["queue_rejects"] == 0


def test_submit_validation(model):
    te = _port(model)
    with pytest.raises(ValueError):        # prompt + new > max_len
        te.submit(np.ones((16,), np.int32), te.max_len)
    with pytest.raises(ValueError):        # prompt beyond largest bucket
        te.submit(np.ones((te.seq_buckets[-1] + 1,), np.int32), 1)
    with pytest.raises(ValueError):
        te.submit(np.ones((4,), np.int32), 0)
    with pytest.raises(ValueError):
        te.submit(np.asarray([], np.int32), 2)
    with pytest.raises(ValueError):        # limits on a prepared Request
        te.submit(S.Request(np.ones((4,), np.int32), 2), max_new_tokens=8)
    req = te.submit(S.Request(np.ones((4,), np.int32), 2))
    te.run()
    assert req.done and len(req.tokens) == 2


def test_eos_early_stop_frees_slot(model):
    """A request whose eos_token the model emits finishes at its first
    occurrence with reason 'eos' and a freed slot."""
    p = _prompts(1, seed=19)[0]
    je, te = _pair(model)
    [toks] = te.generate([p], max_new_tokens=4)     # probe, same engine
    assert toks == je.generate([p], max_new_tokens=4)[0]
    eos = int(toks[-1])
    jr, tr = _both(je, te, [p], [4], eos_token=eos)
    assert tr[0].finish_reason == "eos"
    assert tr[0].tokens == toks[:toks.index(eos) + 1]
    assert te.stats()["slot_occupancy"] == 0
    _assert_agree(je, te, jr, tr)


def test_prefill_finished_requests_are_returned(model):
    """A request satisfied by its prefill's first token comes back from
    step()/run(), not only through its handle."""
    te = _port(model)
    req = te.submit(_prompts(1, seed=29)[0], 1)
    done = te.run()
    assert req.done and req in done and len(req.tokens) == 1
    assert te.stats()["slot_occupancy"] == 0
    assert te.stats()["decode_steps"] == 0


def test_engine_stats_are_per_engine(model):
    a, b = _port(model), _port(model)
    b.generate(_prompts(1, seed=31), max_new_tokens=3)
    sa, sb = a.stats(), b.stats()
    assert sa["requests_completed"] == 0 and sa["tokens_generated"] == 0
    assert sa["decode_compiles"] == 0 and sa["prefill_compiles"] == 0
    assert sa["tokens_per_s"] == 0.0
    assert sb["requests_completed"] == 1 and sb["tokens_generated"] == 3
    assert sb["prefill_compiles"] == 1 and sb["decode_compiles"] == 1


def test_wave_pad_rows_land_before_the_scratch_slots_real_row(model):
    """Three requests in a batch bucket of 4: the pad row scatters over
    the scratch slot, free[0], which is the first real row's slot; the
    real row is written after it, so that row's tokens, and the pool,
    are the JAX engine's."""
    je, te = _pair(model, slots=3, batch_buckets=(1, 4),
                   capture_logits=True)
    prompts = _prompts(3, lo=5, hi=8, seed=41)
    jr, tr = _both(je, te, prompts, [4, 4, 4])
    assert te.stats()["prefill_calls"] == 1 and sorted(te._waves) == [(4, 8)]
    assert [r.slot for r in tr] == [0, 1, 2]        # the pad row's: 0
    _assert_agree(je, te, jr, tr)
    for p, r in zip(prompts, tr):
        assert r.tokens == _generate(model, p, 4)
    np.testing.assert_allclose(te._cache_k.numpy(), np.asarray(je._cache_k),
                               rtol=0, atol=FP32_TOL)
    np.testing.assert_allclose(te._cache_v.numpy(), np.asarray(je._cache_v),
                               rtol=0, atol=FP32_TOL)


@pytest.mark.parametrize("quant", ["int8", "int8_dynamic", "fp8"])
def test_quantized_engine_matches_jax(model, quant):
    je, te = _pair(model, quant=quant, capture_logits=True)
    assert te.warmup() == je.warmup()
    prompts = _prompts(5, seed=43)
    jr, tr = _both(je, te, prompts, [3, 5, 2, 4, 3])
    _assert_agree(je, te, jr, tr, tol=QUANT_LOGIT_TOL)
    st = te.stats()
    assert st["quant"] == quant
    assert st["quant_matmuls"] == 4 * 2 * (st["decode_steps"]
                                           + st["prefill_calls"])
    assert st["dequant_kernel_calls"] == 0          # CPU: plain versions


def test_cache_dtype_and_kv_accounting(model):
    je, te = _pair(model, cache_dtype="bfloat16")
    assert str(te._cache_k.dtype) == "torch.bfloat16"
    jr, tr = _both(je, te, _prompts(3, seed=47), [3, 3, 3])
    _assert_agree(je, te, jr, tr)
    assert te.stats()["kv_bytes_reserved"] == 2 * te._cache_k.numel() * 2


def test_failed_step_aborts_and_zeroes_pool_in_place(model, monkeypatch):
    """A decode that raises aborts every in-flight request; the pool is
    zeroed in place (the captured steps keep its storage), no step is
    rebuilt, and the retry is token-exact."""
    te = _port(model)
    te.warmup()
    built = te.stats()["prefill_compiles"]
    prompt = np.arange(5, 12, dtype=np.int32)
    req = te.submit(prompt, 5)
    real, calls = te._decode, {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected decode failure")
        return real()
    monkeypatch.setattr(te, "_decode", flaky)
    ptrs = [t.data_ptr() for t in te._cache_operands()]
    with pytest.raises(RuntimeError, match="injected"):
        te.run()
    assert te.take_aborted() == [req] and req.failed
    st = te.stats()
    assert st["step_aborts"] == 1 and st["slot_occupancy"] == 0
    assert [t.data_ptr() for t in te._cache_operands()] == ptrs
    assert not te._cache_k.any() and not te._cache_v.any()
    te.submit(req.reset_for_retry())
    te.run()
    assert req.tokens == _generate(model, prompt, 5)
    assert te.stats()["prefill_compiles"] == built
    assert te.stats()["decode_compiles"] == 1
