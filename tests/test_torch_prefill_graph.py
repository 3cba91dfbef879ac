"""paddle_tpu_torch's prefill step objects on the CPU: the wave step (one
a (batch, seq) rung) and the chunk step (one an engine) against the eager
functions they run, and their build counts against the JAX engines'.

On the card each step is one CUDA graph, captured once and replayed; on
the CPU the same object runs its eager body over the same static buffers
(``tests/test_torch_cuda.py`` holds the replays against the eager steps
on a card).  The chunk step passes its offset and held-page flags as
device tensors, which send the held positions to scratch page 0; the
eager entry (an int offset, a list) leaves them out.

Tolerances: tokens and logits exact, pool bytes equal outside scratch
page 0 (the same arithmetic in the same order); ``prefill_compiles``, and
``warmup()``'s return value, equal to the JAX engines' on the same
traces, tokens exact against them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from paddle_tpu.inference import serving as JS
from paddle_tpu.inference import speculative as JSP
from paddle_tpu.models import gpt as J
from paddle_tpu_torch.inference import serving as S
from paddle_tpu_torch.inference import speculative as SP
from paddle_tpu_torch.models import gpt as T
from test_torch_gpt import numpy_params

POOL_NAMES = {False: ("_cache_k", "_cache_v"),
              True: ("_cache_k", "_cache_v", "_cache_ks", "_cache_vs")}


def _cfg(mod):
    return mod.GPTConfig(vocab_size=256, hidden_size=32, num_layers=2,
                         num_heads=2, max_seq_len=64, dtype="float32",
                         use_flash=False, remat=False,
                         **({"use_pallas_norm": True} if mod is T else {}))


@pytest.fixture(scope="module")
def model():
    """(jax cfg, jax params, port cfg, numpy tree): numpy weights."""
    jcfg = _cfg(J)
    tree = numpy_params(jcfg, 3)
    return jcfg, jax.tree_util.tree_map(jnp.asarray, tree), _cfg(T), tree


def _kw(kw):
    for k, v in (("slots", 3), ("max_len", 32), ("page_size", 8),
                 ("seq_buckets", (8, 16)), ("batch_buckets", (1, 2))):
        kw.setdefault(k, v)
    return kw


def _port(model, cls=S.PagedServingEngine, **kw):
    return cls((T.params_from_numpy(model[3], "cpu"), model[2]),
               device="cpu", **_kw(kw))


def _trace(n=8, seed=5):
    """3-14 token prompts, 3-7 new tokens: wave and (at prefill_chunk 8)
    chunked admissions, two sharing a prefix."""
    rng = np.random.RandomState(seed)
    out = [(rng.randint(1, 256, rng.randint(3, 15)).astype(np.int32),
            int(rng.randint(3, 8))) for _ in range(n)]
    out[3] = (np.concatenate([out[1][0][:8], out[3][0]])[:14], out[3][1])
    return out


def _eager_on_clones(eng, fn):
    """``fn()`` with the engine's pool swapped for clones of it; returns
    (fn's result, the clones)."""
    names = POOL_NAMES[bool(getattr(eng, "_kv_quant", False))]
    real = [getattr(eng, n) for n in names]
    clones = [t.clone() for t in real]
    for n, t in zip(names, clones):
        setattr(eng, n, t)
    try:
        return fn(), clones
    finally:
        for n, t in zip(names, real):
            setattr(eng, n, t)


def _assert_pools_equal_past_scratch(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x[:, 1:], y[:, 1:])


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_wave_step_matches_eager_prefill(model, quant):
    """A wave of two into rung (2, 16) with a prefix hit: the wave step's
    tokens, logits and pool equal the eager ``_prefill`` on clones of the
    pool with the same inputs."""
    kw = dict(quant="int8", kv_dtype="int8") if quant else {}
    eng = _port(model, capture_logits=True, **kw)
    first = eng.submit(np.arange(1, 12, dtype=np.int32), 2)
    eng.run()
    a = np.arange(1, 14, dtype=np.int32)            # one page shared
    b = np.arange(40, 50, dtype=np.int32)
    eng.submit(a, 3)
    eng.submit(b, 3)
    rec = {}
    real = eng._run_wave

    def probe(st):
        args = [torch.from_numpy(getattr(st, name).copy())   # the staged
                for name, _ in eng._wave_fields(2, 16)]
        rec["eager"] = _eager_on_clones(eng, lambda: eng._prefill(*args))
        rec["out"] = real(st)
        rec["pool"] = [t.clone() for t in eng._cache_operands()]
        rec["st"] = st
        return rec["out"]
    eng._run_wave = probe
    eng.step()
    (tok, last), clones = rec["eager"]
    got_tok, got_logits = rec["out"]
    np.testing.assert_array_equal(got_tok, tok.numpy())
    np.testing.assert_array_equal(got_logits, last.numpy())
    _assert_pools_equal_past_scratch(rec["pool"], clones)
    st = rec["st"]
    assert st is eng._waves[(2, 16)] and st._pool is None   # CPU: no pool
    np.testing.assert_array_equal(st.lens, [13, 10])
    assert eng.stats()["prefix_page_hits"] >= 1 and first.done


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("offset", [0, 16])
def test_chunk_step_matches_eager_chunk(model, quant, offset):
    """The chunk step (tensor offset and held mask) against the eager
    ``forward_paged_chunk(_quant)`` (int offset, held list) on clones of
    the pool: the same logits and token, and the same pool bytes outside
    page 0; the held page keeps its bytes, at the first chunk and
    mid-prompt."""
    kw = dict(quant="int8", kv_dtype="int8") if quant else {}
    eng = _port(model, prefill_chunk=8, max_len=48, capture_logits=True,
                **kw)
    row = np.array([3, 5, 2, 7, 0, 0], np.int32)
    held = [True, False, True, False]               # pages 3 and 2 held
    rng = np.random.default_rng(offset)
    for t in eng._cache_operands():                 # a pool with content
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape)).to(t.dtype)
                if t.is_floating_point() else
                torch.from_numpy(rng.integers(-100, 100, t.shape))
                .to(t.dtype))
    toks = rng.integers(0, 256, (1, 8)).astype(np.int32)
    take = 6
    fn = T.forward_paged_chunk_quant if quant else T.forward_paged_chunk
    before = [t.clone() for t in eng._cache_operands()]
    (want, *_), clones = _eager_on_clones(eng, lambda: fn(
        eng.params, torch.from_numpy(toks), eng.cfg,
        *[getattr(eng, n) for n in (
            ("_cache_k", "_cache_ks", "_cache_v", "_cache_vs") if quant
            else ("_cache_k", "_cache_v"))],
        torch.from_numpy(row), offset, held))
    st = S._ChunkStep(eng)
    st.toks[:] = toks
    st.row[:] = row
    st.held[:] = 0
    st.held[:len(held)] = held
    st.offset[0] = offset
    st.take[0] = take
    tok, logits = st()
    np.testing.assert_array_equal(logits[0], want[0, take - 1].numpy())
    assert tok[0] == int(torch.argmax(want[0, take - 1]))
    _assert_pools_equal_past_scratch(eng._cache_operands(), clones)
    page = int(row[offset // 8])
    for t, b in zip(eng._cache_operands(), before):
        assert torch.equal(t[:, page], b[:, page]) == held[offset // 8]


def _jax_pair(model, spec=None, **kw):
    kw = _kw(kw)
    if spec:
        return (JSP.SpeculativeServingEngine((model[1], model[0]),
                                             spec_mode="ngram", spec_k=3,
                                             **kw),
                _port(model, SP.SpeculativeServingEngine, spec_mode="ngram",
                      spec_k=3, **dict(kw)))
    return (JS.PagedServingEngine((model[1], model[0]), **kw),
            _port(model, **dict(kw)))


@pytest.mark.parametrize("chunk", [None, 8], ids=["waves", "chunked"])
@pytest.mark.parametrize("spec", [False, True], ids=["paged", "spec"])
def test_prefill_compiles_match_jax(model, chunk, spec):
    """The same trace through the JAX engine and the port's: ``warmup()``
    returns the same count, ``prefill_compiles`` is the same after warmup
    and after traffic (which builds nothing), tokens are equal; an
    aborted step rebuilds nothing."""
    je, te = _jax_pair(model, spec, prefill_chunk=chunk)
    got, want = te.warmup(), je.warmup()
    assert got == want and got == te.stats()["prefill_compiles"]
    assert got == len(te._waves) + (chunk is not None)
    assert (te._chunk_step is not None) == (chunk is not None)
    trace = _trace()
    jr = [je.submit(p, n) for p, n in trace]
    tr = [te.submit(p, n) for p, n in trace]
    je.run()
    te.run()
    assert [r.tokens for r in tr] == [r.tokens for r in jr]
    js, ts = je.stats(), te.stats()
    for k in ("prefill_compiles", "decode_compiles", "prefill_calls",
              "prefill_chunks", "requests_admitted", "tokens_generated"):
        assert ts[k] == js[k], (k, ts[k], js[k])
    assert ts["prefill_compiles"] == got
    assert (ts["prefill_chunks"] > 0) == (chunk is not None)

    def boom(*a):
        raise RuntimeError("injected")
    te._append_token = boom                 # the admission's first token
    te.submit(*trace[0])
    with pytest.raises(RuntimeError, match="injected"):
        te.run()
    del te._append_token
    assert te.take_aborted()
    r = te.submit(*trace[0])
    te.run()
    assert r.tokens == tr[0].tokens
    assert te.stats()["prefill_compiles"] == got


def test_cold_engine_builds_each_rung_at_first_use(model):
    """Without warmup the steps are built as traffic reaches them, one a
    rung and one chunk step, as the JAX engine compiles them."""
    je, te = _jax_pair(model, prefill_chunk=8)
    trace = _trace(seed=9)
    jr = [je.submit(p, n) for p, n in trace]
    tr = [te.submit(p, n) for p, n in trace]
    je.run()
    te.run()
    assert [r.tokens for r in tr] == [r.tokens for r in jr]
    assert te.stats()["prefill_compiles"] == je.stats()["prefill_compiles"]
    assert te.stats()["prefill_compiles"] == len(te._waves) + 1


class _HostReads(TorchDispatchMode):
    """Records the ops that read a tensor's value on the host (``.item()``,
    ``int()``, ``bool()``) or build a tensor from host values
    (``torch.tensor(list)``): inside a CUDA graph the first would sync
    during capture and the second would bake a host buffer's address."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten._local_scalar_dense.default,
                    torch.ops.aten.lift_fresh.default):
            self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_step_bodies_read_nothing_on_the_host(model, quant):
    """The bodies the graphs capture (every wave rung's, the chunk's with
    held pages, the slot engine's wave and decode) neither read a device
    value on the host nor copy host values in."""
    kw = dict(quant="int8", kv_dtype="int8") if quant else {}
    eng = _port(model, prefill_chunk=8, **kw)
    eng.warmup()
    slot = S.ServingEngine((T.params_from_numpy(model[3], "cpu"), model[2]),
                           device="cpu", slots=2, max_len=32,
                           seq_buckets=(8, 16), batch_buckets=(1, 2),
                           quant="int8" if quant else None)
    slot.warmup()
    st = eng._chunk_step
    st.toks[:] = 7
    st.row[:] = np.arange(1, 5)
    st.held[:] = [1, 0, 1, 0]
    st.offset[0] = 8
    st.take[0] = 5
    st()                                      # stage the inputs
    steps = [st, slot._step] + list(eng._waves.values()) + list(
        slot._waves.values())
    assert len(steps) == 2 + 2 + 4         # the paged rungs: seq 8 only
    for step in steps:
        with torch.inference_mode(), _HostReads() as mode:
            step._run()
        assert mode.ops == [], (type(step).__name__, mode.ops)
