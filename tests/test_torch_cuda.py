"""paddle_tpu_torch's CUDA kernels on a card, against their plain PyTorch
versions and through the model and engine.

Every test here needs a CUDA device and nvcc, is marked ``cuda``, and
skips with the reason elsewhere.  The file imports no JAX, so on a
machine with a card and without JAX it runs without the repository's
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: fp32 1e-5 (sums in another order; TF32 is off for the plain
versions' matmuls), 2e-4 on flash-attention gradients (the JAX package's
own flash test); bf16 two rounding steps (2**-6) for paged attention
outputs, whose kernel casts the unnormalised probabilities to bf16 where
the plain version casts the normalised ones, 2**-8 plus 2**-6 of each
element's own size for flash-attention gradients (of the magnitude of the
terms each sums, |ds| |k|, |ds|^T |q| and |p|^T |dO|, for the split
backward's) and, for its outputs, of sum_j p_j |v_j| (both sides round
every p_j, so that sum bounds the error; bf16 rounding is relative, so the
bound follows the element), and
one step (2**-7) for LayerNorm.  The quantized path: the dequant matmul
within 1e-5 of max|ref| in fp32 and 2**-8 + 2**-6 |ref| per element in
bf16 (the kernel rounds once, the plain version twice); int8 paged
attention within 1e-5 in fp32 and 2**-8 + 2**-6 sum_j p_j |v_j| per
element, capped at 2e-2, in bf16; the fp32 quantized engine on the card
against the CPU: tokens exact, logits within 1e-3.  The fused FFN against
the plain version of its own function (h and the output each rounded
once): 1e-5 in fp32, 2**-8 + 2**-6 |ref| per element in bf16; the fused
flash backward at the split backward's tolerances.  RMSNorm: 1e-5 of
max|ref| in fp32, one bf16 step (2**-7) of |ref| in bf16; the nn-API
encoder on the card against the CPU within 1e-5 of max|ref|.  The
row-invariant matmul: 1e-5 of max|ref| in fp32, 2**-8 + 2**-6 |ref| per
element in bf16, and its rows bit-equal across row counts.
"""
import dataclasses

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference.serving import PagedServingEngine
from paddle_tpu_torch.models import gpt as T
from paddle_tpu_torch.ops.cuda import (build, flash_attn, fused_ffn, norms,
                                      paged_attn, row_matmul)
from paddle_tpu_torch.ops.cuda import dequant_matmul as dqmm
from spec_probe import commit_write_probe

pytestmark = pytest.mark.cuda

FP32_TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _paged(rng, dev, dtype, S, nh, hd, ps, maxP, lens):
    P = S * maxP + 1
    q = torch.from_numpy(rng.standard_normal((S, 1, nh, hd),
                                             dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((P, ps, nh, hd),
                                             dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((P, ps, nh, hd),
                                             dtype=np.float32))
    table = np.zeros((S, maxP), np.int32)      # unused entries: scratch 0
    pages = rng.permutation(np.arange(1, P)).astype(np.int32)
    for s, ln in enumerate(lens):
        n = ln // ps + 1
        table[s, :n] = pages[s * maxP:s * maxP + n]
    out = [t.to(dev, dtype) for t in (q, k, v)]
    out += [torch.from_numpy(table).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev)]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [24, 32, 64, 80, 128])
def test_paged_attention_kernel_matches_plain(dev, dtype, hd):
    """hd 24 and 80 leave lanes of the last 16-byte slice past hd (and, at
    24 in fp32, rows off 16 bytes: one-element loads)."""
    ps, maxP = 16, 64
    lens = [0, ps - 1, ps, maxP * ps - 1] + list(range(5, 1000, 83))
    args = _paged(np.random.default_rng(hd), dev, dtype, len(lens), 16, hd,
                  ps, maxP, lens)
    before = paged_attn.launches
    out = paged_attn.paged_attention(*args)
    torch.cuda.synchronize()
    assert paged_attn.launches == before + 1
    ref = paged_attn._ref_paged_attention(*args)
    tol = FP32_TOL if dtype == torch.float32 else 2.0 ** -6
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 1, 1024), (4, 256, 1024),
                                   (3, 4096), (5, 24), (7, 2048), (2, 6),
                                   (3, 7), (5, 1001), (2, 70001)])
def test_layer_norm_kernel_matches_plain(dev, dtype, shape):
    """Vector rows, one-element rows (H = 6, 7, 1001: rows off 16 bytes)
    and rows too wide for registers (H = 70001, read three times)."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * 2 + 1)
    x = x.to(dev, dtype)
    g = torch.from_numpy(rng.standard_normal(shape[-1], dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal(shape[-1], dtype=np.float32))
    for wdt in (torch.float32, dtype):
        gw, bw = g.to(dev, wdt), b.to(dev, wdt)
        before = norms.launches
        out = norms.layer_norm(x, gw, bw)
        torch.cuda.synchronize()
        assert norms.launches == before + 1
        ref = norms._ref_layer_norm(x, gw, bw, 1e-5)
        if dtype == torch.float32:
            torch.testing.assert_close(out, ref, atol=FP32_TOL, rtol=0)
        else:
            # one bf16 rounding step of the largest outputs
            torch.testing.assert_close(out.float(), ref.float(),
                                       atol=2.0 ** -7 * 16, rtol=2.0 ** -7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_kernel_takes_strided_and_unaligned_rows(dev, dtype):
    """A transposed view (copied to rows first) and a view 4 bytes off
    16-byte alignment (one-element loads), each against the plain
    version."""
    rng = np.random.default_rng(11)
    base = torch.from_numpy(rng.standard_normal((64, 6 * 64 + 4),
                                                dtype=np.float32)).to(dev,
                                                                      dtype)
    g = torch.randn(64, device=dev)
    b = torch.randn(64, device=dev)
    tr = base[:, :48].t()                                   # [48, 64]
    off = 4 // base.element_size()
    un = base.reshape(-1)[off:off + 6 * 64].view(6, 64)     # 4 bytes off
    assert not tr.is_contiguous() and un.data_ptr() % 16 == 4
    for x in (tr, un):
        before = norms.launches
        out = norms.layer_norm(x, g, b)
        torch.cuda.synchronize()
        assert norms.launches == before + 1 and out.shape == x.shape
        ref = norms._ref_layer_norm(x, g, b, 1e-5)
        if dtype == torch.float32:
            torch.testing.assert_close(out, ref, atol=FP32_TOL, rtol=0)
        else:
            torch.testing.assert_close(out.float(), ref.float(),
                                       atol=2.0 ** -7 * 16, rtol=2.0 ** -7)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """An int64 table is refused by name; hd = 160 in fp32 (40 slices, two
    head-width groups), which the kernel used to refuse, runs and matches
    the plain version."""
    args = _paged(np.random.default_rng(0), dev, torch.float32, 2, 2, 64,
                  16, 2, [3, 20])
    with pytest.raises(TypeError, match="int32"):
        paged_attn.paged_attention(*args[:3], args[3].long(), args[4])
    wide = _paged(np.random.default_rng(0), dev, torch.float32, 2, 2, 160,
                  16, 2, [3, 20])
    out = paged_attn.paged_attention(*wide)
    torch.testing.assert_close(out, paged_attn._ref_paged_attention(*wide),
                               atol=FP32_TOL, rtol=0)


@pytest.mark.parametrize("case", [
    ("fp", torch.float32, 4, 160), ("fp", torch.bfloat16, 4, 320),
    ("fp", torch.bfloat16, 2, 600), ("int8", torch.float32, 4, 640),
    ("int8", torch.bfloat16, 4, 640), ("int8", torch.bfloat16, 2, 1100)],
    ids=lambda c: f"{c[0]}-{str(c[1])[6:]}-hd{c[3]}")
def test_paged_attention_wide_heads_match_plain(dev, case):
    """Heads past 32 16-byte slices (fp32 160, bf16 320 and 600, int8 640
    and 1100) run the kernels' head-width groups: each group's block owns
    its output columns and sums its scores over the whole width; ragged
    lanes and a multi-split slot (merged through the workspace)."""
    pool, dtype, nh, hd = case
    ps, maxP = 16, 16
    lens = [0, 15, 16, 255, 100]
    args = _paged(np.random.default_rng(hd), dev, torch.float32, len(lens),
                  nh, hd, ps, maxP, lens)
    if pool == "fp":
        args = [a.to(dtype) if a.is_floating_point() else a for a in args]
        out = paged_attn.paged_attention(*args)
        ref = paged_attn._ref_paged_attention(*args)
        scale = paged_attn._ref_paged_attention(*args[:2], args[2].abs(),
                                                *args[3:])
    else:
        q, k, v, table, lens_t = args
        kq, ks = T.quantize_kv(k)
        vq, vs = T.quantize_kv(v)
        qargs = ((2 * q).to(dtype), kq, ks, vq, vs, table, lens_t)
        out = paged_attn.paged_attention_quant(*qargs)
        ref = paged_attn._ref_paged_attention_quant(*qargs)
        scale = paged_attn._ref_paged_attention_quant(
            *qargs[:3], vq.abs(), *qargs[4:])
    torch.cuda.synchronize()
    assert out.shape == ref.shape and torch.isfinite(out.float()).all()
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=FP32_TOL, rtol=0)
    else:
        assert _per_element(out, ref, scale, cap=2e-2) <= 1.0


@pytest.mark.parametrize("pool", ["fp", "int8"])
def test_paged_attention_past_65535_slots(dev, pool):
    """S = 65,537 slots (nh 1, hd 64, a small pool) go in two launches of
    at most 65,535, each with its own slice of the workspace and tickets
    (maxP 8 of 16-position pages: two splits a slot on the fp kernel's
    plan)."""
    S, ps, maxP, P = 65537, 16, 8, 33
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((S, 1, 1, 64),
                                             dtype=np.float32)).to(dev)
    k, v = (torch.from_numpy(rng.standard_normal((P, ps, 1, 64),
                                                 dtype=np.float32)).to(dev)
            for _ in range(2))
    table = torch.from_numpy(rng.integers(1, P, (S, maxP))
                             .astype(np.int32)).to(dev)
    lens = torch.from_numpy(rng.integers(0, maxP * ps, S)
                            .astype(np.int32)).to(dev)
    if pool == "fp":
        before = paged_attn.launches
        out = paged_attn.paged_attention(q, k, v, table, lens)
        ref = paged_attn._ref_paged_attention(q, k, v, table, lens)
        launched = paged_attn.launches - before
    else:
        kq, ks = T.quantize_kv(k)
        vq, vs = T.quantize_kv(v)
        before = paged_attn.quant_launches
        out = paged_attn.paged_attention_quant(q, kq, ks, vq, vs, table,
                                               lens)
        ref = paged_attn._ref_paged_attention_quant(q, kq, ks, vq, vs, table,
                                                    lens)
        launched = paged_attn.quant_launches - before
    torch.cuda.synchronize()
    assert launched == 2
    torch.testing.assert_close(out, ref, atol=FP32_TOL, rtol=0)


def _probe_eager(eng, record):
    """Wrap ``eng._decode`` so that each step first runs the eager step
    function (``decode_step_paged`` or its int8 twin) on clones of the
    pool with the inputs the step stages, then the engine's own step (a
    graph replay after the first); ``record`` gets (eager logits, eager
    next tokens, the step's logits, its next tokens) of each step."""
    real = eng._decode

    def probe(wpages, woffs):
        ins = [torch.from_numpy(np.array(a, np.int32)).to(eng.device)
               for a in (eng._tables_np, wpages, woffs, eng._lens,
                         eng._last_tok)]
        pool = [t.clone() for t in eng._cache_operands()]
        with torch.inference_mode():
            if eng._kv_quant:
                lg, *_ = T.decode_step_paged_quant(
                    eng.params, ins[4], eng.cfg, pool[0], pool[2], pool[1],
                    pool[3], *ins[:4])
            else:
                lg, *_ = T.decode_step_paged(eng.params, ins[4], eng.cfg,
                                             *pool, *ins[:4])
        out = real(wpages, woffs)
        record.append((lg.float().cpu(), lg.argmax(-1).cpu().numpy(),
                       eng._step.logits.float().cpu(), out[0]))
        return out
    eng._decode = probe


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_graph_engine_matches_eager_step(dev, kv):
    """The engine's decode step on the card is one CUDA graph, captured at
    the first decode step and replayed after: every replay's next tokens
    equal the eager step function's on clones of the pool with the same
    inputs, and its logits are within 1e-3 (fp32, 2 layers of gpt_345m
    widths, 6 slots at mixed lengths)."""
    cfg = T.GPTConfig(vocab_size=1024, hidden_size=1024, num_layers=2,
                      num_heads=16, max_seq_len=256, dtype="float32",
                      use_flash=False, remat=False, use_pallas_norm=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(4),
                           device="cpu")
    kw = dict(quant="int8", kv_dtype="int8") if kv == "int8" else {}
    eng = PagedServingEngine((params, cfg), device=dev, slots=6,
                             max_len=128, page_size=16, **kw)
    rng = np.random.default_rng(9)
    for n in (3, 17, 40, 64, 90, 33):
        eng.submit(rng.integers(1, 1024, (n,)).astype(np.int32), 10)
    record = []
    _probe_eager(eng, record)
    eng.run()
    assert len(record) >= 9 and eng._step.captures == 1
    assert eng.stats()["decode_compiles"] == 1
    for eager, eager_nxt, step, nxt in record:
        assert np.array_equal(eager_nxt, nxt)
        torch.testing.assert_close(step, eager, atol=1e-3, rtol=0)


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_graph_engine_counts_through_churn_and_abort(dev, kv, monkeypatch):
    """``decode_compiles == 1`` and exact launch counts, counted per
    replay, through warmup, churn with prefix hits, an injected abort
    (the pool zeroed in place: its storage, which the graph baked, kept)
    and the retry; the retried request's tokens equal a clean run's."""
    cfg = _wide()
    L = cfg.num_layers
    params = T.init_params(cfg, torch.Generator().manual_seed(2), device=dev)
    kw = dict(quant="int8", kv_dtype="int8") if kv == "int8" else {}
    eng = PagedServingEngine((params, cfg), device=dev, slots=3, max_len=32,
                             page_size=8, seq_buckets=(8, 16),
                             batch_buckets=(1, 2), **kw)
    eng.warmup()
    assert eng.stats()["decode_compiles"] == 1 and eng._step.captures == 1
    attn = "quant_launches" if kv == "int8" else "launches"
    rng = np.random.default_rng(3)
    shared = rng.integers(1, 256, (8,)).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(1, 256, (n,))])
               .astype(np.int32) for n in (1, 5, 3, 7, 2)]
    setattr(paged_attn, attn, 0)
    norms.launches = dqmm.launches = 0
    reqs = [eng.submit(p, 6) for p in prompts]
    eng.run()
    st = eng.stats()
    fwd = st["decode_steps"] + st["prefill_calls"]
    assert st["prefix_page_hits"] > 0
    assert getattr(paged_attn, attn) == L * st["decode_steps"]
    assert norms.launches == _ln_launches(kv, L, st["decode_steps"],
                                          st["prefill_calls"])
    assert dqmm.launches == (4 * L * fwd if kv == "int8" else 0)
    ptrs = [t.data_ptr() for t in eng._cache_operands()]
    real = eng._decode
    calls = {"n": 0}

    def flaky(*a):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected decode failure")
        return real(*a)
    monkeypatch.setattr(eng, "_decode", flaky)
    req = eng.submit(prompts[1], 6)
    with pytest.raises(RuntimeError, match="injected"):
        eng.run()
    monkeypatch.undo()
    assert eng.take_aborted() == [req]
    assert [t.data_ptr() for t in eng._cache_operands()] == ptrs
    assert not any(bool(t.any()) for t in eng._cache_operands())
    eng.submit(req.reset_for_retry())
    eng.run()
    assert req.tokens == reqs[1].tokens
    st = eng.stats()
    assert st["decode_compiles"] == 1 and eng._step.captures == 1
    assert getattr(paged_attn, attn) == L * st["decode_steps"]
    assert norms.launches == _ln_launches(kv, L, st["decode_steps"],
                                          st["prefill_calls"])


def test_dead_engine_is_collected_before_a_capture(dev):
    """An engine that became garbage (its decode step holds it in a cycle)
    is collected before the next engine's decode step is captured, not
    by the cyclic collector inside that capture, where its graph's,
    events' and pinned buffers' CUDA calls invalidated the capture
    (``test_graph_engine_counts_through_churn_and_abort`` failed so)."""
    import gc
    import weakref

    cfg = _wide()
    params = T.init_params(cfg, torch.Generator().manual_seed(4), device=dev)

    def engine():
        return PagedServingEngine((params, cfg), device=dev, slots=2,
                                  max_len=32, page_size=8,
                                  seq_buckets=(8, 16), batch_buckets=(1, 2))
    old = engine()
    old.warmup()
    dead = weakref.ref(old)
    del old
    was = gc.isenabled()
    gc.disable()
    try:
        assert dead() is not None       # kept alive by the cycle
        eng = engine()
        eng.warmup()
        assert dead() is None and eng._step.captures == 1
    finally:
        if was:
            gc.enable()


def test_captured_engine_survives_a_grown_workspace(dev):
    """A later eager call that needs a larger paged-attention workspace
    replaces the per-device buffers; the captured engine keeps the ones
    it baked (``_step._held``), so its next replays still decode exactly
    (tokens equal ``generate``) after the freed sizes are reused."""
    cfg = T.GPTConfig(vocab_size=256, hidden_size=128, num_layers=2,
                      num_heads=2, max_seq_len=128, dtype="float32",
                      use_flash=False, remat=False, use_pallas_norm=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(6), device=dev)
    card = torch.device("cuda", torch.cuda.current_device())
    # the engine's capture bakes freshly sized buffers (earlier tests may
    # have grown the per-device ones past the call below)
    paged_attn._work.pop(card, None)
    eng = PagedServingEngine((params, cfg), device=dev, slots=2, max_len=128,
                             page_size=8, seq_buckets=(8, 16, 32),
                             batch_buckets=(1, 2))
    eng.warmup()
    assert eng._cache_k.device == card
    assert paged_attn._split_plan(eng._pages_per_slot, 8)[1] > 1
    held = eng._step._held
    assert held and held[0].data_ptr() == paged_attn._work[card][0]
    # an eager call with far more slots grows (replaces) the workspace
    big = _paged(np.random.default_rng(1), dev, torch.float32, 64, 16, 64,
                 16, 512, [8000] * 64)
    paged_attn.paged_attention(*big)
    assert paged_attn._work[card][0] != held[0].data_ptr()
    junk = [torch.full_like(t, 7) for t in held]   # the sizes, reused
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 256, (n,)).astype(np.int32) for n in (5, 20)]
    reqs = [eng.submit(p, 30) for p in prompts]
    eng.run()
    for p, r in zip(prompts, reqs):
        want = T.generate(params, cfg, torch.from_numpy(p)[None].to(dev), 30)
        assert r.tokens == want[0, len(p):].tolist()
    assert all(bool((t == 7).all()) for t in junk)


def _wide():
    return T.GPTConfig(vocab_size=256, hidden_size=128, num_layers=2,
                       num_heads=2, max_seq_len=64, dtype="float32",
                       use_flash=False, remat=False, use_pallas_norm=True)


def _ln_launches(kv, L, decodes, others):
    """LayerNorm kernel launches for ``decodes`` paged decode steps (or fp
    verifies) and ``others`` prefill waves, chunks and eager forwards:
    2L + 1 a forward, but with float weights and the fp pool a decode
    step launches lnf alone (ln1 and ln2 are the qkv and fc1 products'
    prologue, ``row_matmul.ln_launches``)."""
    return (decodes if kv == "fp" else (2 * L + 1) * decodes) + (
        2 * L + 1) * others


def test_engine_on_card_matches_generate(dev):
    """The engine (paged kernel + LayerNorm kernel) and ``generate`` (dense
    cached attention + LayerNorm kernel) agree token for token in fp32."""
    cfg = _wide()
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    eng = PagedServingEngine((params, cfg), device=dev, slots=2, max_len=32,
                             page_size=8, seq_buckets=(8, 16),
                             batch_buckets=(1, 2))
    eng.warmup()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 256, (n,)).astype(np.int32)
               for n in (5, 11, 3, 16)]
    paged_attn.launches = norms.launches = row_matmul.ln_launches = 0
    reqs = [eng.submit(p, 8) for p in prompts]
    eng.run()
    st = eng.stats()
    L = cfg.num_layers
    assert paged_attn.launches == st["decode_steps"] * L
    assert norms.launches >= _ln_launches("fp", L, st["decode_steps"],
                                          st["prefill_calls"])
    assert row_matmul.ln_launches >= 2 * L * st["decode_steps"]
    for p, r in zip(prompts, reqs):
        want = T.generate(params, cfg, torch.from_numpy(p)[None].to(dev), 8)
        assert r.tokens == want[0, len(p):].tolist()


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_chunked_engine_on_card_matches_cpu(dev, kv):
    """Chunked prefill on the card (fp32): tokens equal the CPU engine's,
    logits within 1e-3, and the LayerNorm (and dequant-matmul) launches
    are exact over chunks, waves and decode steps."""
    cfg = _wide()
    L = cfg.num_layers
    params = T.init_params(cfg, torch.Generator().manual_seed(5),
                           device="cpu")
    kw = dict(quant="int8", kv_dtype="int8") if kv == "int8" else {}
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 256, (n,)).astype(np.int32)
               for n in (22, 5, 17, 9)]
    runs = {}
    for d in ("cuda", "cpu"):
        eng = PagedServingEngine((params, cfg), device=d, slots=3,
                                 max_len=32, page_size=8,
                                 seq_buckets=(8, 16), batch_buckets=(1, 2),
                                 prefill_chunk=8, capture_logits=True, **kw)
        eng.warmup()
        norms.launches = dqmm.launches = 0
        reqs = [eng.submit(p, 6) for p in prompts]
        eng.run()
        st = eng.stats()
        fwd = st["decode_steps"] + st["prefill_calls"] + st["prefill_chunks"]
        if d == "cuda":
            # prompts past 8 tokens go in chunks of 8: 3 + 3 + 2
            assert st["prefill_chunks"] == 8
            assert norms.launches == _ln_launches(
                kv, L, st["decode_steps"],
                st["prefill_calls"] + st["prefill_chunks"])
            assert dqmm.launches == (4 * L * fwd if kv == "int8" else 0)
            assert eng._step.captures == 1
        runs[d] = reqs
    for a, b in zip(runs["cuda"], runs["cpu"]):
        assert a.tokens == b.tokens
        torch.testing.assert_close(torch.from_numpy(np.stack(a.logits)),
                                   torch.from_numpy(np.stack(b.logits)),
                                   atol=1e-3, rtol=0)


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_wave_written_prefix_page_on_card(dev, kv):
    """On the card (fp32), a page that a wave of two prompts wrote and a
    longer chunked prompt then hits keeps the wave's bytes while both
    wave requests still decode (the chunk computes it at another row
    count), and every request's tokens equal the CPU engine's."""
    cfg = _wide()
    params = T.init_params(cfg, torch.Generator().manual_seed(7),
                           device="cpu")
    kw = dict(quant="int8", kv_dtype="int8") if kv == "int8" else {}
    rng = np.random.default_rng(12)
    a, c = (rng.integers(1, 256, 8).astype(np.int32) for _ in range(2))
    b = np.concatenate([a, rng.integers(1, 256, 13).astype(np.int32)])
    runs = {}
    for d in ("cuda", "cpu"):
        eng = PagedServingEngine((params, cfg), device=d, slots=3,
                                 max_len=32, page_size=8,
                                 seq_buckets=(8, 16), batch_buckets=(1, 2),
                                 prefill_chunk=8, **kw)
        ra, rc = eng.submit(a, 10), eng.submit(c, 10)
        eng.step()
        page = int(eng._tables_np[ra.slot, 0])
        snap = [p[:, page].clone() for p in eng._cache_operands()]
        rb = eng.submit(b, 4)
        while eng.stats()["prefill_chunks"] < 3:
            eng.step()
        assert not (ra.done or rc.done)
        assert int(eng._tables_np[rb.slot, 0]) == page
        for p, s in zip(eng._cache_operands(), snap):
            assert torch.equal(p[:, page], s)
        eng.run()
        runs[d] = [r.tokens for r in (ra, rc, rb)]
    assert runs["cuda"] == runs["cpu"]


@pytest.mark.parametrize("kv", ["fp", "int8"])
@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_speculative_engine_on_card(dev, mode, kv):
    """The speculative engine on the card (fp32, self-draft in draft
    mode): one verify graph (and two draft graphs), tokens equal the
    non-speculative engine's on the card, exact LayerNorm, paged and
    dequant and row-matmul launches (4L a verify with float weights), and
    every verify, all-reject or accepting, changing the pool only at the
    positions it committed.  (The pool's bytes against the
    non-speculative engine's are asserted by ``chip_smoke.py`` (y) and,
    for one verify against one decode, by
    ``test_verify_lane_writes_the_decode_bytes``.)"""
    import dataclasses

    from paddle_tpu_torch.inference.speculative import (
        SpeculativeServingEngine)
    cfg = _wide()
    L = cfg.num_layers
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    kw = dict(quant="int8", kv_dtype="int8") if kv == "int8" else {}
    skw = ({"spec_draft_cfg": dataclasses.asdict(cfg),
            "spec_draft_seed": 0} if mode == "draft" else {})
    ekw = dict(device=dev, slots=2, max_len=32, page_size=8,
               seq_buckets=(8, 16), batch_buckets=(1,), **kw)
    prompt = np.arange(1, 12, dtype=np.int32)
    base = PagedServingEngine((params, cfg), **ekw)
    rb = base.submit(prompt, 8)
    base.run()
    spec = SpeculativeServingEngine((params, cfg), spec_mode=mode,
                                    spec_k=3, **skw, **ekw)
    seen = []
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, 256, (n,)).astype(np.int32)
               for n in (5, 11, 3, 14)]
    want = [base.submit(p, 10) for p in prompts]
    base.run()
    with commit_write_probe(spec, seen):
        spec._spec_reject = lambda step: True
        rs = spec.submit(prompt, 8)
        spec.run()
        rejected = spec.stats()["accepted_tokens"]
        spec._spec_reject = None
        before = spec.stats()
        norms.launches = dqmm.launches = row_matmul.launches = 0
        row_matmul.ln_launches = 0
        paged_attn.launches = paged_attn.quant_launches = 0
        dqmm.rows_launches.clear()
        reqs = [spec.submit(p, 10) for p in prompts]
        spec.run()
    assert rs.tokens == rb.tokens and rejected == 0
    st = spec.stats()
    assert [r.tokens for r in reqs] == [r.tokens for r in want]
    assert st["decode_compiles"] == 1 and spec._step.captures == 1
    assert st["spec_draft_compiles"] == (2 if mode == "draft" else 0)
    assert seen and not any(bad for bad, _ in seen), seen
    st = {k: st[k] - before[k] for k in ("decode_steps", "prefill_calls",
                                         "spec_steps")}
    fwd = st["decode_steps"] + st["prefill_calls"]
    # the draft model (a self-draft: the target's config) runs W + k - 1
    # slot decodes a verify and its blocks (no head) a 16-token
    # ingestion chunk
    ingest = sum(-(-len(p) // 16) for p in prompts)
    dfwd, dblk = ((0, 0) if mode == "ngram"
                  else (6 * st["decode_steps"], ingest))
    assert norms.launches == _ln_launches(
        kv, L, st["decode_steps"], st["prefill_calls"] + dfwd) + 2 * L * dblk
    assert dqmm.launches == (4 * L * fwd if kv == "int8" else 0)
    # W paged-attention launches a layer a verify (one a lane), at the
    # decode's call shape
    attn = "quant_launches" if kv == "int8" else "launches"
    assert getattr(paged_attn, attn) == 4 * L * st["spec_steps"]
    assert row_matmul.launches == (4 * L * st["spec_steps"] if kv == "fp"
                                   else 0)
    assert row_matmul.ln_launches == (2 * L * st["spec_steps"] if kv == "fp"
                                      else 0)
    if kv == "int8":
        # the verify's rows, S * W = 8, and the 8-token waves' (one a
        # prompt of at most 8 tokens, batch bucket 1)
        waves8 = sum(len(p) <= 8 for p in prompts)
        assert dqmm.rows_launches[8] == 4 * L * (st["spec_steps"] + waves8)


class _StepProbe:
    """Stands in for an engine's step object: attribute reads reach the
    step (the engine stages through them); a call runs ``fn(step)``."""

    def __init__(self, step, fn):
        self.__dict__.update(_step=step, _fn=fn)

    def __getattr__(self, name):
        return getattr(self._step, name)

    def __call__(self):
        return self._fn(self._step)


def _pool_names(eng):
    return (("_cache_k", "_cache_v", "_cache_ks", "_cache_vs")
            if getattr(eng, "_kv_quant", False) else ("_cache_k", "_cache_v"))


def _eager_on_clones(eng, fn):
    """``fn()`` with the engine's pool swapped for clones (the graphs keep
    the storage they baked); returns (its result, the clones)."""
    names = _pool_names(eng)
    real = [getattr(eng, n) for n in names]
    clones = [t.clone() for t in real]
    for n, t in zip(names, clones):
        setattr(eng, n, t)
    try:
        with torch.inference_mode():
            return fn(), clones
    finally:
        for n, t in zip(names, real):
            setattr(eng, n, t)


def _staged(step, names):
    return [torch.from_numpy(np.array(getattr(step, n))).to(step.device)
            for n in names]


def _probe_prefill(eng, record):
    """Hold every wave and chunk replay of ``eng`` against its eager
    function (``_prefill``; ``forward_paged_chunk`` with an int offset and
    a held list) on clones of the pool with the staged inputs; ``record``
    gets (kind, tokens equal, pool pages 1.. equal, max |logit diff|)."""
    real_wave = eng._run_wave

    def compare(kind, eager, clones, got, logits):
        tok, last = eager
        same = all(bool(torch.equal(a[:, 1:], b[:, 1:])) for a, b in
                   zip([getattr(eng, n) for n in _pool_names(eng)], clones))
        record.append((kind, np.array_equal(tok.cpu().numpy(), got), same,
                       float((last.float() - logits.float()).abs().max())))

    def wave(st):
        b, s = st.tokens.shape
        args = _staged(st, [n for n, _ in eng._wave_fields(b, s)])
        eager, clones = _eager_on_clones(eng, lambda: eng._prefill(*args))
        out = real_wave(st)
        compare("wave", eager, clones, out[0], st.logits)
        return out

    def chunk(st):
        toks, row = _staged(st, ("toks", "row"))
        held = [bool(h) for h in st.held]
        offset, take = int(st.offset[0]), int(st.take[0])

        def run():
            if eng._kv_quant:
                lg, *_ = T.forward_paged_chunk_quant(
                    eng.params, toks, eng.cfg, eng._cache_k, eng._cache_ks,
                    eng._cache_v, eng._cache_vs, row, offset, held)
            else:
                lg, *_ = T.forward_paged_chunk(
                    eng.params, toks, eng.cfg, eng._cache_k, eng._cache_v,
                    row, offset, held)
            last = lg[0, take - 1:take]
            return last.argmax(-1), last
        eager, clones = _eager_on_clones(eng, run)
        out = st()
        compare("chunk", eager, clones, out[0], st.logits)
        return out

    eng._run_wave = wave
    if eng._chunk_step is not None:
        eng._chunk_step = _StepProbe(eng._chunk_step, chunk)


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_prefill_graphs_match_eager_steps(dev, kv):
    """Every rung's wave step and the chunk step are captured in
    ``warmup()`` into the engine's one prefill pool, and traffic captures
    nothing; every wave and chunk replay gives the eager function's
    tokens and pool bytes (outside page 0) on clones of the pool (fp32),
    the held pages of a prefix hit included; launches stay exact."""
    cfg = _wide()
    L = cfg.num_layers
    params = T.init_params(cfg, torch.Generator().manual_seed(8),
                           device="cpu")
    kw = dict(quant="int8", kv_dtype="int8") if kv == "int8" else {}
    eng = PagedServingEngine((params, cfg), device=dev, slots=3, max_len=48,
                             page_size=8, seq_buckets=(8, 16, 24),
                             batch_buckets=(1, 2), prefill_chunk=16, **kw)
    built = eng.warmup()
    steps = list(eng._waves.values()) + [eng._chunk_step]
    assert built == len(steps) == eng.stats()["prefill_compiles"] == 5
    assert all(st.captures == 1 for st in steps)
    pools = {st._pool for st in steps}
    assert len(pools) == 1 and None not in pools
    rng = np.random.default_rng(10)
    shared = rng.integers(1, 256, (16,)).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(1, 256, (n,))])
               .astype(np.int32) for n in (4, 20, 2)]
    prompts += [rng.integers(1, 256, (n,)).astype(np.int32) for n in (5, 9)]
    record = []
    _probe_prefill(eng, record)
    norms.launches = dqmm.launches = 0
    reqs = [eng.submit(prompts[0], 6)]
    eng.run()                       # its pages registered: later hits
    reqs += [eng.submit(p, 6) for p in prompts[1:]]
    eng.run()
    st = eng.stats()
    assert all(r.done for r in reqs) and st["prefix_page_hits"] > 0
    kinds = [k for k, *_ in record]
    assert "wave" in kinds and "chunk" in kinds
    for kind, tok, pool, diff in record:
        assert tok and pool, (kind, diff)
    assert st["prefill_compiles"] == built
    assert all(s.captures == 1 for s in steps)
    # each probed call also ran its eager function once
    fwd = (st["decode_steps"] + st["prefill_calls"] + st["prefill_chunks"]
           + len(record))
    assert norms.launches == _ln_launches(kv, L, st["decode_steps"],
                                          fwd - st["decode_steps"])
    assert dqmm.launches == (4 * L * fwd if kv == "int8" else 0)


def test_slot_engine_graphs_on_card(dev):
    """The slot-contiguous engine on the card (fp32): its wave steps and
    decode step are captured in ``warmup()``, every decode replay equals
    the eager ``decode_step_slots`` on clones of the pool (tokens and pool
    bytes), tokens equal the CPU engine's, logits within 1e-3, and the
    LayerNorm launches are exact."""
    from paddle_tpu_torch.inference.serving import ServingEngine
    cfg = _wide()
    L = cfg.num_layers
    params = T.init_params(cfg, torch.Generator().manual_seed(11),
                           device="cpu")
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, 256, (n,)).astype(np.int32)
               for n in (5, 14, 3, 9, 16)]
    runs = {}
    for d in ("cuda", "cpu"):
        eng = ServingEngine((params, cfg), device=d, slots=3, max_len=48,
                            seq_buckets=(8, 16), batch_buckets=(1, 2, 4),
                            capture_logits=True)
        built = eng.warmup()
        assert built == len(eng._waves) == eng.stats()["prefill_compiles"]
        record = []
        real = eng._step
        if d == "cuda":
            assert real.captures == 1
            assert all(w.captures == 1 for w in eng._waves.values())

            def decode(st):
                lens, toks, act = _staged(st, ("lens", "toks", "active"))
                (lg, _), clones = _eager_on_clones(
                    eng, lambda: T.decode_step_slots(
                        eng.params, toks, cfg, {"k": eng._cache_k,
                                                "v": eng._cache_v,
                                                "len": lens}, act != 0))
                out = st()
                record.append((
                    np.array_equal(lg.argmax(-1).cpu().numpy(), out[0]),
                    all(bool(torch.equal(a, b)) for a, b in zip(
                        eng._cache_operands(), clones))))
                return out
            eng._step = _StepProbe(real, decode)
        norms.launches = 0
        reqs = [eng.submit(p, 8) for p in prompts]
        eng.run()
        eng._step = real
        st = eng.stats()
        if d == "cuda":
            assert record and all(t and p for t, p in record), record
            # each probed decode also ran the eager step once
            fwd = st["decode_steps"] + st["prefill_calls"] + len(record)
            assert norms.launches == (2 * L + 1) * fwd
            assert st["decode_compiles"] == 1 and real.captures == 1
            assert st["prefill_compiles"] == built
        runs[d] = reqs
    for a, b in zip(runs["cuda"], runs["cpu"]):
        assert a.tokens == b.tokens
        torch.testing.assert_close(torch.from_numpy(np.stack(a.logits)),
                                   torch.from_numpy(np.stack(b.logits)),
                                   atol=1e-3, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 1000, 1000, 16, 64, True),
                                   (2, 256, 256, 4, 128, False),
                                   (2, 200, 200, 4, 256, True),
                                   (2, 130, 130, 4, 32, True),
                                   (1, 300, 300, 3, 96, False),
                                   (4100, 16, 16, 16, 32, False),
                                   (65537, 16, 16, 1, 64, False),
                                   (8, 512, 512, 12, 64, False),
                                   (64, 512, 512, 12, 64, False),
                                   (128, 32, 32, 8, 64, False),
                                   (32, 24, 40, 8, 64, False),
                                   (32, 40, 24, 8, 64, False),
                                   (32, 1, 1, 8, 64, False),
                                   (32, 1, 33, 8, 64, False),
                                   (32, 1, 82, 8, 64, False)])
def test_flash_kernels_match_plain(dev, dtype, shape):
    """Forward (out, lse) and split backward (dq, dk, dv) against
    ``_ref_flash_fwd`` / ``_ref_flash_bwd``, the bf16 gradients per element
    within 2**-8 + 2**-6 of the magnitude of the terms they sum
    (``_ref_flash_bwd_terms``); q/k/v are strided views of one
    fused [B, N, 3, H] projection, as the model passes them.  hd 256 runs
    its own forward and the backward's head-width groups; hd 32 and 96 are
    zero-padded to 64 and 128 at the true width's scale; B * nh = 65,600
    passes the old gridDim.y limit, B = 65,537 takes two launches of the
    (row tiles, nh, B) grid, and [8, 512, 12, 64] and [64, 512, 12, 64]
    with no mask are the ERNIE-3.0-Base encoder's attention (the second
    at ``bench.py``'s pretraining batch); the last six are the
    Transformer-base seq2seq path's: its training attention, the
    cross-attention with Nq != Nk (separate q and k, v tensors) and a
    decode step's Nq = 1 against 1, 33 and 82 keys."""
    B, N, Nk, nh, hd, causal = shape
    g = torch.Generator(device=dev).manual_seed(N)
    if N == Nk:
        qkv = torch.randn(B, N, 3, nh * hd, device=dev, generator=g).to(
            dtype)
        q, k, v = [qkv[:, :, i].reshape(B, N, nh, hd) for i in range(3)]
    else:
        q = torch.randn(B, N, nh, hd, device=dev, generator=g).to(dtype)
        k, v = (torch.randn(B, Nk, nh, hd, device=dev, generator=g).to(
            dtype) for _ in range(2))
    do = torch.randn(B, N, nh, hd, device=dev, generator=g).to(dtype)
    before = (flash_attn.fwd_launches, flash_attn.dq_launches,
              flash_attn.dkv_launches)
    out, lse = flash_attn.flash_fwd(q, k, v, causal)
    dq, dk, dv = flash_attn.flash_bwd(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    assert (flash_attn.fwd_launches, flash_attn.dq_launches,
            flash_attn.dkv_launches) == tuple(n + 1 for n in before)
    ref_out, ref_lse = flash_attn._ref_flash_fwd(q, k, v, causal)
    # the backward's plain version gets the kernels' own out and lse, so
    # the forward's bf16 rounding does not reach delta = rowsum(dO * out)
    refs = flash_attn._ref_flash_bwd(q, k, v, out, lse, do, causal)
    f32 = dtype == torch.float32
    torch.testing.assert_close(lse, ref_lse, atol=FP32_TOL, rtol=0)
    bf16_tol = dict(atol=2.0 ** -8, rtol=2.0 ** -6)
    if f32:
        torch.testing.assert_close(out, ref_out, atol=FP32_TOL, rtol=0)
    else:
        # the bf16 forward's error follows sum_j p_j |v_j|, not |out|
        scale = flash_attn._ref_flash_fwd(q, k, v.abs(), causal)[0].float()
        err = (out.float() - ref_out.float()).abs()
        worst = float((err / (bf16_tol["atol"]
                              + bf16_tol["rtol"] * scale)).max())
        assert worst <= 1.0, worst
    if f32:
        for got, ref in zip((dq, dk, dv), refs):
            torch.testing.assert_close(got.float(), ref.float(), atol=2e-4,
                                       rtol=0)
    else:
        # each bf16 gradient's error follows the magnitude of the terms it
        # sums (|ds| |k|, |ds|^T |q|, |p|^T |dO|), not |ref|: a cancelling
        # sum can sit below one bf16 step of its largest term
        terms = flash_attn._ref_flash_bwd_terms(q, k, v, out, lse, do,
                                                causal)
        for name, got, ref, scale in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                         refs, terms):
            assert _per_element(got, ref, scale) <= 1.0, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 1000, 1000, 4, 64, True),
                                   (8, 512, 512, 12, 64, False),
                                   (2, 300, 300, 4, 128, True),
                                   (1, 128, 320, 4, 64, True),
                                   (2, 200, 200, 2, 256, True),
                                   (1, 200, 200, 2, 384, False)])
def test_split_backward_is_bitwise_deterministic(dev, dtype, shape):
    """The split backward has no atomics and no reductions: two launches
    of the dq kernel and of the dk/dv kernel on the same operands give the
    same bits (hd 256 and 384 on the kernels' head-width groups)."""
    B, N, Nk, nh, hd, causal = shape
    g = torch.Generator(device=dev).manual_seed(N + hd)
    q = torch.randn(B, N, nh, hd, device=dev, generator=g).to(dtype)
    k, v = (torch.randn(B, Nk, nh, hd, device=dev, generator=g).to(dtype)
            for _ in range(2))
    do = torch.randn(B, N, nh, hd, device=dev, generator=g).to(dtype)
    out, lse = flash_attn.flash_fwd(q, k, v, causal)
    ops = flash_attn._bwd_operands(q, k, v, out, do)
    args = (*ops[:4], lse, ops[4], causal, 1.0 / hd ** 0.5)
    first = (flash_attn._launch_dq(*args), *flash_attn._launch_dkv(*args))
    second = (flash_attn._launch_dq(*args), *flash_attn._launch_dkv(*args))
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name
        assert bool(torch.isfinite(a.float()).all()), name


def test_flash_attention_autograd_on_card(dev):
    """The autograd Function: one forward and one dq + one dk/dv launch,
    gradients equal to the plain backward's."""
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(2, 192, 4, 64, device=dev, generator=g)
               .requires_grad_() for _ in range(3))
    before = (flash_attn.fwd_launches, flash_attn.dq_launches,
              flash_attn.dkv_launches)
    out = flash_attn.flash_attention(q, k, v, causal=True)
    do = torch.randn_like(out)
    got = torch.autograd.grad(out, (q, k, v), do)
    assert (flash_attn.fwd_launches, flash_attn.dq_launches,
            flash_attn.dkv_launches) == tuple(n + 1 for n in before)
    with torch.no_grad():
        ref_out, lse = flash_attn._ref_flash_fwd(q, k, v, True)
        refs = flash_attn._ref_flash_bwd(q, k, v, ref_out, lse, do, True)
    for a, b in zip(got, refs):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=0)


@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [320, 384, 512, 640])
def test_flash_wide_heads_match_plain(dev, hd, dtype, fused):
    """Heads wider than 256 (the reference's Pallas kernel takes every
    multiple of 128) run the kernels' head-width groups: the forward and
    the split or the fused backward, through the autograd Function, against
    ``_ref_flash_fwd`` / ``_ref_flash_bwd`` (fp32 1e-5 and 2e-4; bf16 per
    element as ``test_flash_kernels_match_plain``)."""
    B, N, nh = 2, 200, 2
    g = torch.Generator(device=dev).manual_seed(hd)
    qkv = torch.randn(B, N, 3, nh * hd, device=dev, generator=g).to(dtype)
    q, k, v = [qkv[:, :, i].reshape(B, N, nh, hd).requires_grad_()
               for i in range(3)]
    do = torch.randn(B, N, nh, hd, device=dev, generator=g).to(dtype)
    counters = ("fwd_launches", "dq_launches", "dkv_launches",
                "fused_launches")
    before = [getattr(flash_attn, c) for c in counters]
    try:
        flash_attn.set_default_blocks(bwd_fused=fused)
        out = flash_attn.flash_attention(q, k, v, causal=True)
        got = torch.autograd.grad(out, (q, k, v), do)
    finally:
        flash_attn.set_default_blocks(bwd_fused=False)
    torch.cuda.synchronize()
    want = (1, 0, 0, 1) if fused else (1, 1, 1, 0)
    assert tuple(getattr(flash_attn, c) - n
                 for c, n in zip(counters, before)) == want
    with torch.no_grad():
        o2, lse = flash_attn.flash_fwd(q, k, v, True)
        ref_out, ref_lse = flash_attn._ref_flash_fwd(q, k, v, True)
        refs = flash_attn._ref_flash_bwd(q, k, v, out, lse, do, True)
        torch.testing.assert_close(o2, out, atol=0, rtol=0)
        torch.testing.assert_close(lse, ref_lse, atol=FP32_TOL, rtol=0)
        if dtype == torch.float32:
            torch.testing.assert_close(out, ref_out, atol=FP32_TOL, rtol=0)
        else:
            scale = flash_attn._ref_flash_fwd(q, k, v.abs(), True)[0]
            assert _per_element(out, ref_out, scale) <= 1.0
    for name, a, b in zip(("dq", "dk", "dv"), got, refs):
        assert a.shape == b.shape and a.dtype == dtype, name
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, atol=2e-4, rtol=0, msg=name)
        else:
            assert _per_element(a, b, b) <= 1.0, name


@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 257, 256, 4, 64),
                                   (2, 512, 256, 4, 64),
                                   (1, 300, 150, 2, 128)],
                         ids=["N=Nk+1", "N=2Nk", "N=2Nk-hd128"])
def test_flash_causal_rows_with_no_key_match_plain(dev, shape, dtype,
                                                   fused):
    """Causal with N > Nk (the kernels used to refuse it): the first
    N - Nk rows see no key and get the mean of V (lse -1e30), dq = 0 and
    dO / Nk into dv, the rest run the kernels on a row-offset view; the
    forward and the split or fused backward through the autograd Function
    against ``_ref_flash_fwd`` / ``_ref_flash_bwd`` (fp32 1e-5 and 2e-4,
    bf16 per element as ``test_flash_kernels_match_plain``)."""
    B, N, Nk, nh, hd = shape
    g = torch.Generator(device=dev).manual_seed(N + Nk)
    q = torch.randn(B, N, nh, hd, device=dev, generator=g).to(dtype)
    k, v = (torch.randn(B, Nk, nh, hd, device=dev, generator=g).to(dtype)
            for _ in range(2))
    do = torch.randn(B, N, nh, hd, device=dev, generator=g).to(dtype)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = flash_attn.nokey_launches
    try:
        flash_attn.set_default_blocks(bwd_fused=fused)
        out = flash_attn.flash_attention(q, k, v, causal=True)
        got = torch.autograd.grad(out, (q, k, v), do)
    finally:
        flash_attn.set_default_blocks(bwd_fused=False)
    torch.cuda.synchronize()
    assert flash_attn.nokey_launches == before + 2
    rows = N - Nk
    with torch.no_grad():
        o2, lse = flash_attn.flash_fwd(q, k, v, True)
        ref_out, ref_lse = flash_attn._ref_flash_fwd(q, k, v, True)
        refs = flash_attn._ref_flash_bwd(q, k, v, out, lse, do, True)
        terms = flash_attn._ref_flash_bwd_terms(q, k, v, out, lse, do, True)
        torch.testing.assert_close(o2, out, atol=0, rtol=0)
        assert bool((lse[..., :rows] == -1e30).all())
        torch.testing.assert_close(lse, ref_lse, atol=FP32_TOL, rtol=0)
        assert not got[0][:, :rows].any()
        if dtype == torch.float32:
            torch.testing.assert_close(out, ref_out, atol=FP32_TOL, rtol=0)
        else:
            scale = flash_attn._ref_flash_fwd(q, k, v.abs(), True)[0]
            assert _per_element(out, ref_out, scale) <= 1.0
    for name, a, b, t in zip(("dq", "dk", "dv"), got, refs, terms):
        assert a.shape == b.shape and a.dtype == dtype, name
        assert bool(torch.isfinite(a.float()).all()), name
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, atol=2e-4, rtol=0, msg=name)
        else:
            assert _per_element(a, b, t) <= 1.0, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_gradients_on_card_match_plain(dev, dtype):
    """The kernel's forward is differentiable: x, g and b get the plain
    version's gradients."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((4, 37, 1024),
                                             dtype=np.float32))
    x = x.to(dev, dtype).requires_grad_()
    g = torch.randn(1024, device=dev).requires_grad_()
    b = torch.randn(1024, device=dev).requires_grad_()
    dy = torch.randn(4, 37, 1024, device=dev).to(dtype)
    before = norms.launches
    got = torch.autograd.grad(norms.layer_norm(x, g, b), (x, g, b), dy)
    assert norms.launches == before + 1
    want = torch.autograd.grad(norms._ref_layer_norm(x, g, b, 1e-5),
                               (x, g, b), dy)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=FP32_TOL, rtol=FP32_TOL)


def _per_element(got, ref, scale, cap=None):
    """Worst |got - ref| / (2**-8 + 2**-6 |scale|) (at most ``cap``)."""
    den = 2.0 ** -8 + 2.0 ** -6 * scale.float().abs()
    if cap is not None:
        den = den.clamp(max=cap)
    return float(((got.float() - ref.float()).abs() / den).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(8, 1024, 3072), (8, 4096, 1024),
                                   (3, 128, 256), (1000, 1024, 4096),
                                   (128, 256, 128)])
def test_dequant_matmul_kernel_matches_plain(dev, dtype, M, K, N):
    g = torch.Generator(device=dev).manual_seed(M + K + N)
    x = torch.randn(M, K, device=dev, generator=g).to(dtype)
    w = torch.randint(-127, 128, (K, N), device=dev, generator=g,
                      dtype=torch.int8)
    s = (torch.rand(N, device=dev, generator=g) + 0.1) / 64
    before = dqmm.launches
    out = dqmm.dequant_matmul(x, w, s)
    torch.cuda.synchronize()
    assert dqmm.launches == before + 1 and out.dtype == dtype
    ref = dqmm._ref_dequant_matmul(x, w, s)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=0,
                                   atol=1e-5 * float(ref.abs().max()))
    else:
        assert _per_element(out, ref, ref) <= 1.0
    # twice in a row: the split-K tickets are back at 0 after a launch
    torch.testing.assert_close(dqmm.dequant_matmul(x, w, s), out, rtol=0,
                               atol=0)


@pytest.mark.parametrize("K,N", [(13, 10), (1030, 1000)])
def test_dequant_matmul_takes_strided_rows_and_refuses_by_name(dev, K, N):
    """Strided x rows go in without a copy; K off a multiple of 8 and N
    off one of 16, which the kernels used to refuse, run (the weight
    zero-padded, as ``pad_weight`` pads it once for the engine), as does a
    strided, misaligned weight; each against the plain version, fp32 and
    bf16; float weights are refused by name."""
    g = torch.Generator(device=dev).manual_seed(3)
    base = torch.randn(6, 2, 3, 128, device=dev, generator=g)
    x = base[:, 1, 1]                       # rows 768 floats apart
    w = torch.randint(-127, 128, (128, 256), device=dev, generator=g,
                      dtype=torch.int8)
    s = torch.rand(256, device=dev, generator=g) + 0.1
    ref = dqmm._ref_dequant_matmul(x, w, s)
    torch.testing.assert_close(dqmm.dequant_matmul(x, w, s), ref, rtol=0,
                               atol=1e-5 * float(ref.abs().max()))
    with pytest.raises(TypeError, match="int8 weights only"):
        dqmm.dequant_matmul(x, w.float(), s)
    xo = torch.randn(9, K, device=dev, generator=g)
    wbase = torch.randint(-127, 128, (K, N + 3), device=dev, generator=g,
                          dtype=torch.int8)
    wo = wbase[:, 3:]                       # strided, 3 bytes off
    so = (torch.rand(N, device=dev, generator=g) + 0.1) / 64
    wp, sp = dqmm.pad_weight(wo, so)
    for dtype in (torch.float32, torch.bfloat16):
        xd = xo.to(dtype)
        ref = dqmm._ref_dequant_matmul(xd, wo, so)
        before = dqmm.launches
        got = dqmm.dequant_matmul(xd, wo, so)
        pre = dqmm.dequant_matmul(xd, wp, sp, n=N)
        torch.cuda.synchronize()
        assert dqmm.launches == before + 2 and got.shape == (9, N)
        torch.testing.assert_close(pre, got, atol=0, rtol=0)
        if dtype == torch.float32:
            torch.testing.assert_close(got, ref, rtol=0,
                                       atol=1e-5 * float(ref.abs().max()))
        else:
            assert _per_element(got, ref, ref) <= 1.0


DQMM_SHAPES = [(1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024)]


@pytest.mark.parametrize("K,N", DQMM_SHAPES, ids=["qkv", "proj", "fc1",
                                                  "fc2"])
@pytest.mark.parametrize("M", [1, 8, 16, 17, 63, 64, 65, 1000, 4096])
def test_dequant_matmul_bf16_regimes_match_plain(dev, M, K, N):
    """The bf16 kernels at the serving path's four weights (gpt_345m's qkv,
    proj, fc1, fc2), at M on both sides of the regime threshold
    (dqmm_stream up to 16 rows, dqmm_wg above), per element within
    2**-8 + 2**-6 |ref|."""
    g = torch.Generator(device=dev).manual_seed(M * 7 + K + N)
    x = torch.randn(M, K, device=dev, generator=g).to(torch.bfloat16)
    w = torch.randint(-127, 128, (K, N), device=dev, generator=g,
                      dtype=torch.int8)
    s = (torch.rand(N, device=dev, generator=g) + 0.1) / 64
    before = dqmm.launches
    out = dqmm.dequant_matmul(x, w, s)
    torch.cuda.synchronize()
    assert dqmm.launches == before + 1
    assert bool(torch.isfinite(out.float()).all())
    assert _per_element(out, dqmm._ref_dequant_matmul(x, w, s),
                        dqmm._ref_dequant_matmul(x, w, s)) <= 1.0


@pytest.mark.parametrize("M", [8, 64, 4096])
def test_dequant_matmul_bf16_is_bitwise_deterministic(dev, M):
    """No atomics and fixed summation orders (the cluster's partials in
    rank order): the same inputs twice give the same bits."""
    g = torch.Generator(device=dev).manual_seed(M)
    x = torch.randn(M, 1024, device=dev, generator=g).to(torch.bfloat16)
    w = torch.randint(-127, 128, (1024, 4096), device=dev, generator=g,
                      dtype=torch.int8)
    s = (torch.rand(4096, device=dev, generator=g) + 0.1) / 64
    a = dqmm.dequant_matmul(x, w, s)
    b = dqmm.dequant_matmul(x, w, s)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_long_slot_empty_lanes_clamped_table(dev,
                                                                    dtype):
    """One slot at 8,191 positions (a full table of 512 pages: the
    largest split plan), len-0 lanes beside a partly filled one, and
    table entries outside [0, P) (-1, -5, -P - 3, P and P + 40), which
    read the reference's pages: a negative entry wraps once (e + P), then
    the index is clamped to [0, P - 1]."""
    ps, maxP = 16, 512
    for lens in ([8190], [0, 0, 700, 0]):
        args = _paged(np.random.default_rng(len(lens)), dev, dtype,
                      len(lens), 16, 64, ps, maxP, lens)
        q, k, v, table, lens_t = args
        P = k.shape[0]
        if len(lens) > 1:
            table[2, 3] = -5
            table[2, 7] = P + 40
            table[2, 9] = -1
            table[2, 11] = -P - 3
            table[2, 13] = P
        before = paged_attn.launches
        out = paged_attn.paged_attention(q, k, v, table, lens_t)
        torch.cuda.synchronize()
        assert paged_attn.launches == before + 1
        pages = paged_attn._table_pages(table, P).int()
        ref = paged_attn._ref_paged_attention(q, k, v, table, lens_t)
        torch.testing.assert_close(
            ref, paged_attn._ref_paged_attention(q, k, v, pages, lens_t),
            atol=0, rtol=0)
        assert torch.isfinite(out).all()
        if dtype == torch.float32:
            torch.testing.assert_close(out, ref, atol=FP32_TOL, rtol=0)
        else:
            scale = paged_attn._ref_paged_attention(q, k, v.abs(), table,
                                                    lens_t)
            assert _per_element(out, ref, scale) <= 1.0
        if len(lens) > 1:                      # the int8 kernel alike
            kq, ks = T.quantize_kv(k.float())
            vq, vs = T.quantize_kv(v.float())
            qargs = (q, kq, ks, vq, vs, table, lens_t)
            qout = paged_attn.paged_attention_quant(*qargs)
            qref = paged_attn._ref_paged_attention_quant(*qargs)
            if dtype == torch.float32:
                torch.testing.assert_close(qout, qref, atol=FP32_TOL, rtol=0)
            else:
                qscale = paged_attn._ref_paged_attention_quant(
                    q, kq, ks, vq.abs(), vs, table, lens_t)
                assert _per_element(qout, qref, qscale, cap=2e-2) <= 1.0


def _paged_quant(dev, dtype, S, nh, hd, ps, maxP, lens):
    args = _paged(np.random.default_rng(hd + S), dev, torch.float32, S, nh,
                  hd, ps, maxP, lens)
    q, k, v, table, lens_t = args
    kq, ks = T.quantize_kv(k)
    vq, vs = T.quantize_kv(v)
    return (2 * q).to(dtype), kq, ks, vq, vs, table, lens_t


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 24, 32, 64, 80, 128])
def test_paged_attention_quant_kernel_matches_plain(dev, dtype, hd):
    """hd 24 (int8 rows off 16 bytes: one-byte loads) and 80 (lanes of
    the last slice past hd) besides the powers of two."""
    ps, maxP = 16, 32
    lens = [0, ps - 1, ps, maxP * ps - 1] + list(range(5, 500, 71))
    args = _paged_quant(dev, dtype, len(lens), 8, hd, ps, maxP, lens)
    before = (paged_attn.launches, paged_attn.quant_launches)
    out = paged_attn.paged_attention_quant(*args)
    torch.cuda.synchronize()
    assert (paged_attn.launches, paged_attn.quant_launches) == (
        before[0], before[1] + 1)
    ref = paged_attn._ref_paged_attention_quant(*args)
    assert torch.isfinite(out).all()
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=FP32_TOL, rtol=0)
    else:
        q, kq, ks, vq, vs, table, lens_t = args
        scale = paged_attn._ref_paged_attention_quant(q, kq, ks, vq.abs(),
                                                      vs, table, lens_t)
        assert _per_element(out, ref, scale, cap=2e-2) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["one slot of 8191", "16 ragged slots"])
def test_paged_attention_quant_long_and_ragged_slots(dev, dtype, case):
    """The int8 kernel at one slot of 8,191 positions (a split plan of
    several splits, merged in the launch) and at 16 ragged slots over 64
    pages (lens 0, ps - 1, ps, a full table and 12 others; one split a
    slot): against the plain version under the gates above, one launch a
    call, bitwise-equal outputs from two calls, every ticket back at 0."""
    ps = 16
    if case == "one slot of 8191":
        maxP, lens = 512, [8190]
    else:
        maxP = 64
        lens = [0, ps - 1, ps, maxP * ps - 1] + [
            int(n) for n in np.random.default_rng(16).integers(
                1, maxP * ps - 1, 12)]
    args = _paged_quant(dev, dtype, len(lens), 16, 64, ps, maxP, lens)
    before = (paged_attn.launches, paged_attn.quant_launches)
    out = paged_attn.paged_attention_quant(*args)
    again = paged_attn.paged_attention_quant(*args)
    torch.cuda.synchronize()
    assert (paged_attn.launches, paged_attn.quant_launches) == (
        before[0], before[1] + 2)
    assert torch.equal(out, again)
    work = paged_attn._work.get(out.device)
    if work is not None:
        assert int(work[5].abs().sum()) == 0
    ref = paged_attn._ref_paged_attention_quant(*args)
    assert torch.isfinite(out).all()
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=FP32_TOL, rtol=0)
    else:
        q, kq, ks, vq, vs, table, lens_t = args
        scale = paged_attn._ref_paged_attention_quant(q, kq, ks, vq.abs(),
                                                      vs, table, lens_t)
        assert _per_element(out, ref, scale, cap=2e-2) <= 1.0


def test_paged_attention_quant_refuses_by_name(dev):
    q, kq, ks, vq, vs, table, lens = _paged_quant(dev, torch.float32, 2, 2,
                                                  64, 16, 2, [3, 20])
    with pytest.raises(TypeError, match="int8"):
        paged_attn.paged_attention_quant(q, kq.float(), ks, vq, vs, table,
                                         lens)
    with pytest.raises(TypeError, match="int32"):
        paged_attn.paged_attention_quant(q, kq, ks, vq, vs, table.long(),
                                         lens)


def test_quantized_engine_on_card_matches_cpu(dev):
    """``quant="int8", kv_dtype="int8"`` in fp32 at 2 layers of
    ``gpt_345m`` widths (a smaller vocabulary): the card (kernels) and the
    CPU (plain versions) give the same tokens and logits within 1e-3;
    every forward launches 4L dequant matmuls, every decode step L int8
    paged attentions."""
    cfg = T.GPTConfig(vocab_size=4096, hidden_size=1024, num_layers=2,
                      num_heads=16, max_seq_len=256, dtype="float32",
                      use_flash=False, remat=False, use_pallas_norm=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(1),
                           device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 4096, (n,)).astype(np.int32)
               for n in (9, 40, 17, 64)]
    runs = {}
    for d in (dev, torch.device("cpu")):
        eng = PagedServingEngine((params, cfg), device=d, quant="int8",
                                 kv_dtype="int8", slots=4, max_len=128,
                                 page_size=16, capture_logits=True)
        before = (dqmm.launches, paged_attn.quant_launches)
        reqs = [eng.submit(p, 12) for p in prompts]
        eng.run()
        st = eng.stats()
        fwd = st["decode_steps"] + st["prefill_calls"]
        if d.type == "cuda":
            assert (dqmm.launches - before[0],
                    paged_attn.quant_launches - before[1]) == (
                4 * 2 * fwd, 2 * st["decode_steps"])
            assert st["dequant_kernel_calls"] == 8 * fwd + 2 * st[
                "decode_steps"]
        runs[d.type] = reqs
    for a, b in zip(runs["cuda"], runs["cpu"]):
        assert a.tokens == b.tokens
        err = max(float(np.abs(x - y).max())
                  for x, y in zip(a.logits, b.logits))
        assert err <= 1e-3, err


@pytest.mark.parametrize("quant", ["int8_dynamic", "fp8"])
def test_other_weight_modes_on_card_match_cpu(dev, quant):
    """The reference has no kernel for these modes: ``int8_dynamic`` runs
    ``torch._int_mm`` (rows padded past its CUDA minimum), ``fp8``
    dequantizes in plain PyTorch.  fp32, card against CPU: tokens exact,
    logits within 1e-3; no dequant-matmul launch."""
    cfg = T.GPTConfig(vocab_size=512, hidden_size=256, num_layers=2,
                      num_heads=4, max_seq_len=128, dtype="float32",
                      use_flash=False, remat=False, use_pallas_norm=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(4),
                           device="cpu")
    prompts = [np.arange(1, n + 1, dtype=np.int32) * 7 % 512
               for n in (5, 19, 33)]
    runs = {}
    for d in (dev, torch.device("cpu")):
        eng = PagedServingEngine((params, cfg), device=d, quant=quant,
                                 kv_dtype="int8", slots=4, max_len=64,
                                 page_size=16, capture_logits=True)
        before = dqmm.launches
        reqs = [eng.submit(p, 8) for p in prompts]
        eng.run()
        assert dqmm.launches == before
        runs[d.type] = reqs
    for a, b in zip(runs["cuda"], runs["cpu"]):
        assert a.tokens == b.tokens
        err = max(float(np.abs(x - y).max())
                  for x, y in zip(a.logits, b.logits))
        assert err <= 1e-3, err


# ---------------------------------------------------------------------------
# the fused FFN and the fused flash backward (the GPT-3 1.3B recipe's routes)
# ---------------------------------------------------------------------------

def _ffn_args(dev, dtype, M, H, F, seed=0):
    """x ~ N(0, 1), weights scaled by 1/sqrt(fan-in), biases N(0, 0.1^2):
    outputs of order one."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, device=dev, generator=g) * scale).to(dtype)
    return (rnd(M, H), rnd(H, F, scale=H ** -0.5), rnd(F, scale=0.1),
            rnd(F, H, scale=F ** -0.5), rnd(H, scale=0.1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,H,F", [(1000, 1024, 4096), (8, 1024, 4096),
                                   (128, 128, 256), (37, 264, 104),
                                   (256, 4096, 16384), (300, 768, 3072),
                                   (5, 6, 10)])
def test_fused_ffn_kernel_matches_plain(dev, dtype, M, H, F):
    """The kernel against ``_ref_fused_ffn`` (its own function): fp32 within
    1e-5, bf16 per element 2**-8 + 2**-6 |ref|.  Ragged M and F tiles,
    H = 264 (a multiple of 8, not of 64), H = 4096 (two column groups),
    H = 768 (a cluster of 8 blocks of 128 columns, two past H) and H = 6,
    F = 10 (zero-padded to 8 and 16)."""
    args = _ffn_args(dev, dtype, M, H, F)
    before = fused_ffn.launches
    got = fused_ffn.fused_ffn_fwd(*args)
    torch.cuda.synchronize()
    assert fused_ffn.launches == before + 1
    assert got.shape == (M, H) and got.dtype == dtype
    ref = fused_ffn._ref_fused_ffn(*args)
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=FP32_TOL, rtol=FP32_TOL)
        torch.testing.assert_close(got, fused_ffn._ref_ffn(*args),
                                   atol=FP32_TOL, rtol=FP32_TOL)
    else:
        assert _per_element(got, ref, ref) <= 1.0


def test_fused_ffn_autograd_on_card_and_refusals(dev):
    """One launch a forward; gradients of every input equal autograd of
    ``_ref_ffn``; the widths refused before this kernel (H = 2056 and 12, F
    = 100) now run and match the plain version; operands of another dtype
    are refused by name."""
    args = [a.requires_grad_() for a in
            _ffn_args(dev, torch.float32, 3 * 40, 256, 512, seed=1)]
    x = args[0].reshape(3, 40, 256)
    before = fused_ffn.launches
    out = fused_ffn.fused_ffn(x, *args[1:])
    assert fused_ffn.launches == before + 1 and out.shape == x.shape
    dy = torch.randn_like(out)
    got = torch.autograd.grad(out, args, dy)
    want = torch.autograd.grad(fused_ffn._ref_ffn(x, *args[1:]), args, dy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=FP32_TOL, rtol=FP32_TOL)
    for dt, M, H, F in ((torch.float32, 4, 2056, 64),
                        (torch.float32, 4, 12, 64),
                        (torch.bfloat16, 4, 64, 100)):
        ffn = _ffn_args(dev, dt, M, H, F)
        got = fused_ffn.fused_ffn(*ffn)
        ref = fused_ffn._ref_fused_ffn(*ffn)
        if dt == torch.float32:
            torch.testing.assert_close(got, ref, atol=FP32_TOL,
                                       rtol=FP32_TOL)
        else:
            assert _per_element(got, ref, ref) <= 1.0
    bad = list(_ffn_args(dev, torch.bfloat16, 4, 64, 64))
    bad[1] = bad[1].float()
    with pytest.raises(TypeError, match="w1"):
        fused_ffn.fused_ffn(*bad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 1000, 1000, 16, 64, True),
                                   (2, 256, 256, 4, 128, False),
                                   (1, 128, 320, 16, 64, True),
                                   (2, 512, 512, 16, 128, True),
                                   (2, 200, 200, 4, 256, True),
                                   (2, 130, 130, 4, 32, True),
                                   (1, 300, 300, 3, 96, False)])
def test_fused_flash_backward_matches_plain(dev, dtype, shape):
    """With ``bwd_fused=True`` the backward is one fused launch (no split
    launch) whose dq, dk, dv match ``_ref_flash_bwd`` at the split
    kernels' tolerances: fp32 2e-4, bf16 per element 2**-8 + 2**-6 |ref|."""
    B, N, Nk, nh, hd, causal = shape
    g = torch.Generator(device=dev).manual_seed(N + hd)
    q = torch.randn(B, N, nh, hd, device=dev, generator=g).to(dtype)
    k, v = (torch.randn(B, Nk, nh, hd, device=dev, generator=g).to(dtype)
            for _ in range(2))
    do = torch.randn(B, N, nh, hd, device=dev, generator=g).to(dtype)
    out, lse = flash_attn.flash_fwd(q, k, v, causal)
    counts = (flash_attn.dq_launches, flash_attn.dkv_launches,
              flash_attn.fused_launches)
    try:
        flash_attn.set_default_blocks(bwd_fused=True)
        got = flash_attn.flash_bwd(q, k, v, out, lse, do, causal)
    finally:
        flash_attn.set_default_blocks(bwd_fused=False)
    torch.cuda.synchronize()
    assert (flash_attn.dq_launches, flash_attn.dkv_launches,
            flash_attn.fused_launches) == (counts[0], counts[1],
                                           counts[2] + 1)
    refs = flash_attn._ref_flash_bwd(q, k, v, out, lse, do, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, refs):
        assert a.dtype == dtype, name
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, atol=2e-4, rtol=0)
        else:
            assert _per_element(a, b, b) <= 1.0, name


def test_train_step_fused_routes_on_card_match_cpu(dev):
    """A narrow fp32 model with ``use_fused_ffn`` and ``bwd_fused=True``
    under remat "full": per step L fused-FFN launches (the recompute keeps
    the op's output), L fused backward launches, no split backward launch;
    the loss equals the CPU step's within 1e-5."""
    from paddle_tpu_torch.models import gpt_hybrid as TH
    cfg = T.GPTConfig(vocab_size=256, hidden_size=128, num_layers=2,
                      num_heads=2, max_seq_len=64, dtype="float32",
                      use_flash=True, use_fused_ffn=True,
                      use_pallas_norm=True)
    gen = torch.Generator().manual_seed(0)
    cpu_p = T.init_params(cfg, gen, device="cpu")
    dev_p = {k: (v.to(dev) if torch.is_tensor(v)
                 else {kk: vv.to(dev) for kk, vv in v.items()})
             for k, v in cpu_p.items()}
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 256,
                                                              (2, 64)))
    L = cfg.num_layers
    try:
        flash_attn.set_default_blocks(bwd_fused=True)
        before = (fused_ffn.launches, flash_attn.fused_launches,
                  flash_attn.dq_launches, flash_attn.dkv_launches)
        lg, _ = TH.loss_and_grads(dev_p, toks.to(dev), toks.to(dev), cfg)
        after = (fused_ffn.launches, flash_attn.fused_launches,
                 flash_attn.dq_launches, flash_attn.dkv_launches)
        lc, _ = TH.loss_and_grads(cpu_p, toks, toks, cfg)
    finally:
        flash_attn.set_default_blocks(bwd_fused=False)
    assert tuple(a - b for a, b in zip(after, before)) == (L, L, 0, 0)
    assert abs(float(lg) - float(lc)) <= FP32_TOL


def _flash_counts():
    return (flash_attn.fwd_launches, flash_attn.dq_launches,
            flash_attn.dkv_launches, flash_attn.fused_launches,
            flash_attn.nokey_launches, norms.launches, norms.rms_launches)


def test_ernie_train_step_on_card(dev):
    """A short step of ERNIE-3.0-Base pretraining (full width, 2 layers,
    [4, 512], bf16 compute, remat, ``use_flash``): per step 2L flash
    forwards (the remat recompute), L split dq and L dk/dv launches, no
    fused backward, no norm kernel, and no flash operand copied (q, k, v
    are strided views of the fused projection); a finite loss that a
    second step lowers."""
    from paddle_tpu_torch.models import bert
    cfg = dataclasses.replace(bert.ernie_3_base(), num_layers=2)
    gen = torch.Generator(device=dev).manual_seed(0)
    params, m, v = bert.init_pretrain_state(cfg, gen, dev)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, (4, 512))
    mlm = np.where(rng.rand(4, 512) < 0.15, toks, -100)
    nsp = rng.randint(0, 2, (4,))
    batch = [torch.from_numpy(a.astype(np.int32)).to(dev)
             for a in (toks, mlm, nsp)]
    step = bert.make_train_step(cfg)
    copies, real = [], flash_attn._kernel_operand

    def counted(t):
        out = real(t)
        if out is not t:
            copies.append(tuple(t.shape))
        return out
    before = _flash_counts()
    try:
        flash_attn._kernel_operand = counted
        losses = [float(step(params, m, v, t, *batch, 1e-4)[3])
                  for t in (1, 2)]
    finally:
        flash_attn._kernel_operand = real
    L = cfg.num_layers
    got = tuple(a - b for a, b in zip(_flash_counts(), before))
    assert got == (4 * L, 2 * L, 2 * L, 0, 0, 0, 0)
    assert not copies
    assert all(np.isfinite(losses)) and losses[1] < losses[0]


@pytest.mark.parametrize("pad", [False, True], ids=["flash", "pad_mask"])
def test_ernie_loss_and_grads_on_card_match_cpu(dev, pad):
    """The fp32 pretrain loss and every leaf's gradient on the card
    (flash kernels, or the dense route with a pad mask) against the CPU
    (plain versions): loss within 1e-5, gradients within 1e-4 of
    max|grad| (H = 128, two heads of 64, 2 layers, [2, 256])."""
    from paddle_tpu_torch.models import bert, common
    cfg = bert.BertConfig(vocab_size=512, hidden_size=128, num_layers=2,
                          num_heads=2, max_seq_len=256, type_vocab_size=4,
                          dtype="float32")
    cpu_p = bert.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    paths, vals = zip(*common._leaves(cpu_p))
    dev_p = common._build(paths, [x.to(dev) for x in vals])
    rng = np.random.RandomState(1)
    toks = torch.from_numpy(rng.randint(0, 512, (2, 256)))
    mlm = torch.where(torch.from_numpy(rng.rand(2, 256) < 0.15), toks, -100)
    nsp = torch.tensor([0, 1])
    mask = torch.ones_like(toks)
    mask[1, 100:] = 0

    def loss_of(*args):
        t, ml, nl, pm = args
        return lambda p: bert.pretrain_loss(p, t, ml, cfg, None,
                                            pm if pad else None, nl)
    before = _flash_counts()
    lg, gg = common.value_and_grad(
        loss_of(*(x.to(dev) for x in (toks, mlm, nsp, mask))), dev_p)
    launched = tuple(a - b for a, b in zip(_flash_counts(), before))
    lc, gc = common.value_and_grad(loss_of(toks, mlm, nsp, mask), cpu_p)
    L = cfg.num_layers
    assert launched == ((0,) * 7 if pad else (2 * L, L, L, 0, 0, 0, 0))
    assert abs(float(lg) - float(lc)) <= FP32_TOL * abs(float(lc))
    for path, g in common._leaves(gc):
        err = float((common._at(gg, path).cpu() - g).abs().max())
        assert err <= 1e-4 * float(g.abs().max()), path


def _rms_close(out, ref, dtype):
    """fp32: within 1e-5 of max|ref|; bf16: one bf16 step of |ref|."""
    if dtype == torch.float32:
        top = float(ref.abs().max()) if ref.numel() else 0.0
        tol = FP32_TOL * max(1.0, top)
        torch.testing.assert_close(out, ref, atol=tol, rtol=0)
    else:
        torch.testing.assert_close(out.float(), ref.float(), atol=1e-6,
                                   rtol=2.0 ** -7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 512, 768), (4, 8, 256), (3, 1000),
                                   (2, 8), (5, 1001), (3, 7), (2, 40000),
                                   (2, 70001), (0, 768)])
def test_rms_norm_kernel_matches_plain(dev, dtype, shape):
    """Vector rows, one-element rows (H not a multiple of 16 bytes), rows
    read twice (too wide for registers) and no rows; g in fp32 and in x's
    dtype."""
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * 2
                         + 0.5).to(dev, dtype)
    g = torch.from_numpy(rng.standard_normal(shape[-1], dtype=np.float32))
    for wdt in (torch.float32, dtype):
        gw = g.to(dev, wdt)
        before = norms.rms_launches
        out = norms.rms_norm(x, gw)
        torch.cuda.synchronize()
        assert norms.rms_launches == before + (x.numel() > 0)
        assert out.shape == x.shape and out.dtype == dtype
        _rms_close(out, norms._ref_rms_norm(x, gw, 1e-6), dtype)


def test_rms_norm_kernel_takes_rows_off_16_bytes(dev):
    """A contiguous view that starts 4 bytes into its storage takes the
    one-element loads."""
    base = torch.randn(3 * 768 + 1, device=dev)
    x = base[1:].view(3, 768)
    g = torch.randn(768, device=dev)
    _rms_close(norms.rms_norm(x, g), norms._ref_rms_norm(x, g, 1e-6),
               torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_gradients_on_card_match_plain(dev, dtype):
    rng = np.random.default_rng(22)
    x = torch.from_numpy(rng.standard_normal((4, 37, 768),
                                             dtype=np.float32))
    x = x.to(dev, dtype).requires_grad_()
    g = torch.randn(768, device=dev).requires_grad_()
    dy = torch.randn(4, 37, 768, device=dev).to(dtype)
    before = norms.rms_launches
    got = torch.autograd.grad(norms.rms_norm(x, g), (x, g), dy)
    assert norms.rms_launches == before + 1
    want = torch.autograd.grad(norms._ref_rms_norm(x, g, 1e-6), (x, g), dy)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=FP32_TOL, rtol=FP32_TOL)


def test_rms_norm_refuses_by_name(dev):
    """float16 and a wrong g are refused by name; a transposed view (which
    the kernel used to refuse) is copied to rows and a view 4 bytes off
    16-byte alignment takes one-element loads, each against the plain
    version in fp32 and bf16."""
    g = torch.ones(64, device=dev)
    with pytest.raises(TypeError, match="float16"):
        norms.rms_norm(torch.randn(2, 64, device=dev).half(), g)
    with pytest.raises(ValueError, match=r"must be \[64\]"):
        norms.rms_norm(torch.randn(2, 64, device=dev), g[:32])
    rng = np.random.default_rng(12)
    for dtype in (torch.float32, torch.bfloat16):
        base = torch.from_numpy(rng.standard_normal(
            (64, 6 * 64 + 4), dtype=np.float32)).to(dev, dtype)
        gw = torch.randn(64, device=dev)
        tr = base[:, :48].t()                                # [48, 64]
        off = 4 // base.element_size()
        un = base.reshape(-1)[off:off + 6 * 64].view(6, 64)  # 4 bytes off
        assert not tr.is_contiguous() and un.data_ptr() % 16 == 4
        for x in (tr, un):
            before = norms.rms_launches
            out = norms.rms_norm(x, gw)
            torch.cuda.synchronize()
            assert norms.rms_launches == before + 1 and out.shape == x.shape
            _rms_close(out, norms._ref_rms_norm(x, gw, 1e-6), dtype)


def test_nn_encoder_on_card_matches_cpu(dev):
    """The nn-API encoder (pre-LN, RMSNorm final norm) at H=128, nh=2, 2
    layers: under ``no_grad`` the card launches 2L LayerNorm, L flash and
    1 RMSNorm kernels a forward and matches the CPU within 1e-5 of
    max|ref|; recording, it launches only the L flash forwards."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.framework import core

    def build():
        m = nn.Sequential(
            ("emb", nn.Embedding(1000, 128)),
            ("encoder", nn.TransformerEncoder(
                nn.TransformerEncoderLayer(128, 2, 512, dropout=0.0,
                                           activation="gelu",
                                           normalize_before=True),
                2, norm=nn.RMSNorm(128))))
        return m.eval()

    ids = np.random.default_rng(23).integers(0, 1000, (2, 64))
    prev = core._state.expected_place
    try:
        pt.set_device("cpu")
        cpu = build()
        state = {k: v.numpy() for k, v in cpu.state_dict().items()}
        with pt.no_grad():
            want = cpu(pt.to_tensor(ids)).numpy()
        pt.set_device("gpu")
        card = build()
        card.set_state_dict(state)
        counts = (norms.launches, flash_attn.fwd_launches,
                  norms.rms_launches)
        with pt.no_grad():
            got = card(pt.to_tensor(ids)).numpy()
        after = (norms.launches, flash_attn.fwd_launches,
                 norms.rms_launches)
        assert tuple(a - b for a, b in zip(after, counts)) == (4, 2, 1)
        rec = card(pt.to_tensor(ids))
        assert not rec.stop_gradient
        assert (norms.launches, flash_attn.fwd_launches,
                norms.rms_launches) == (after[0], after[1] + 2, after[2])
    finally:
        core._state.expected_place = prev
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FP32_TOL * np.abs(want).max())


def test_eager_ernie_training_on_card_matches_cpu(dev):
    """Phase (s) of ``chip_smoke.py`` at a smaller size: the eager loop
    (``ErnieForPretraining``, ``loss.backward()``, AdamW with
    ``ClipGradByGlobalNorm(1.0)``) in fp32, H=128, nh=2 (hd 64), 2
    layers, [2, 128], numpy weights, 3 steps on the card (the flash
    forward 2L and split backward L a step) and on the CPU: losses within
    1e-5 relative, every first-step ``.grad`` within 1e-4 of its
    max|grad| (the JAX flash test's 2e-4 and (q)'s 1e-4), the params after
    3 steps within 1e-4 of their max."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.framework import core
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig(vocab_size=512, hidden_size=128, num_layers=2,
                          num_heads=2, max_seq_len=128, dtype="float32")
    rng = np.random.default_rng(31)
    toks = rng.integers(0, 512, (2, 128)).astype(np.int32)
    mlm = np.where(rng.random((2, 128)) < 0.15, toks, -100).astype(np.int32)
    nsp = rng.integers(0, 2, (2,)).astype(np.int32)
    weights, out = None, {}
    prev = core._state.expected_place
    try:
        for place in ("gpu", "cpu"):
            pt.set_device(place)
            model = bert.ErnieForPretraining(cfg)
            if weights is None:
                weights = {k: (1 + 0.1 * rng.standard_normal(p.shape)
                               if k.endswith("_g") else
                               0.02 * rng.standard_normal(p.shape))
                           .astype(np.float32)
                           for k, p in model.state_dict().items()}
            model.set_state_dict(weights)
            opt = pt.optimizer.AdamW(
                learning_rate=1e-3, epsilon=1e-6,
                grad_clip=pt.nn.ClipGradByGlobalNorm(1.0),
                parameters=model.parameters())
            args = [pt.to_tensor(a) for a in (toks, mlm, nsp)]
            before = (flash_attn.fwd_launches, flash_attn.dq_launches,
                      flash_attn.dkv_launches)
            losses, grads = [], None
            for _ in range(3):
                loss = model(*args)
                loss.backward()
                if grads is None:
                    grads = {k: p.grad.numpy()
                             for k, p in model.state_dict().items()}
                opt.step()
                opt.clear_grad()
                losses.append(float(loss))
            launched = tuple(a - b for a, b in zip(
                (flash_attn.fwd_launches, flash_attn.dq_launches,
                 flash_attn.dkv_launches), before))
            out[place] = (losses, grads, {
                k: p.numpy() for k, p in model.state_dict().items()},
                launched)
    finally:
        core._state.expected_place = prev
    (lg, gg, pg, launched), (lc, gc, pc, cpu_launched) = (out["gpu"],
                                                          out["cpu"])
    assert launched == (12, 6, 6) and cpu_launched == (0, 0, 0)
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    for k in gc:
        np.testing.assert_allclose(gg[k], gc[k], rtol=0, err_msg=k,
                                   atol=1e-4 * max(np.abs(gc[k]).max(),
                                                   1e-30))
        np.testing.assert_allclose(pg[k], pc[k], rtol=0, err_msg=k,
                                   atol=1e-4 * np.abs(pc[k]).max())


def test_dropout_mask_and_scaler_flag_stay_on_the_card(dev):
    """Dropout draws its mask on the card from the card's generator (the
    same seed gives the same mask; no host-to-device copy), and the
    scaler's non-finite flag is a device tensor until ``step`` reads it."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.framework import core
    from paddle_tpu_torch.nn import functional as F

    prev = core._state.expected_place
    try:
        pt.set_device("gpu")
        x = pt.to_tensor(np.ones((256, 256), np.float32))
        pt.seed(3)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            a = F.dropout(x, 0.25)
            torch.cuda.synchronize()
        copies = [e for e in prof.events() if "HtoD" in e.name]
        assert not copies, copies
        pt.seed(3)
        b = F.dropout(x, 0.25)
        assert a.value.is_cuda
        assert torch.equal(a.value, b.value)
        assert abs(float((a.value == 0).float().mean()) - 0.25) < 0.01
        lin = pt.nn.Linear(4, 2)
        opt = pt.optimizer.SGD(learning_rate=0.1,
                               parameters=lin.parameters())
        scaler = pt.amp.GradScaler()
        loss = pt.sum(lin(pt.to_tensor(np.ones((3, 4), np.float32))))
        scaler.scale(loss).backward()
        scaler.unscale_(opt)
        assert isinstance(scaler._found_inf, torch.Tensor)
        assert scaler._found_inf.is_cuda
        scaler.step(opt)
        assert scaler._found_inf is False
    finally:
        core._state.expected_place = prev


def test_loader_prefetches_pinned_copies_on_a_side_stream(dev, tmp_path):
    """The ring loader with ``prefetch_to_device``: batches on the card,
    each copied from pinned memory on a stream where no kernel of the
    consumer runs, and every held batch still what it was produced as
    after the epoch (the ring's slab is never read after its release)."""
    import json

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.framework import core

    class Distinct(pt.io.Dataset):
        def __len__(self):
            return 64

        def __getitem__(self, i):
            return np.full((4097,), i, np.float32), np.int64(i)

    prev = core._state.expected_place
    try:
        pt.set_device("gpu")
        pt.io.reset_prefetch_stats()
        loader = pt.io.DataLoader(Distinct(), batch_size=4, num_workers=1,
                                  prefetch_factor=2, use_native_ring=True,
                                  prefetch_to_device=2)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            held = []
            for x, y in loader:
                held.append((x, y, (x.value * 2).sum()))   # consumer work
            torch.cuda.synchronize()
        trace = tmp_path / "loader.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
        h2d = [e for e in events if e.get("cat") == "gpu_memcpy"
               and "HtoD" in e.get("name", "")]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        assert len(h2d) == 32 and kernels
        assert all("Pinned" in e["name"] for e in h2d), {
            e["name"] for e in h2d}
        assert not ({e["args"].get("stream") for e in h2d}
                    & {e["args"].get("stream") for e in kernels})
        stats = pt.io.prefetch_stats()
        assert stats["batches"] == 16 and stats["hits"] + stats["misses"] == 16
        for b, (x, y, _) in enumerate(held):
            assert x.value.is_cuda and y.value.is_cuda
            idx = np.arange(4 * b, 4 * b + 4)
            np.testing.assert_array_equal(
                x.numpy(), np.repeat(idx, 4097).reshape(4, 4097))
            np.testing.assert_array_equal(y.numpy(), idx)
    finally:
        core._state.expected_place = prev


def test_hapi_classifier_on_card_matches_cpu(dev):
    """Phase (v) of ``chip_smoke.py`` at a smaller size: an ERNIE
    classifier (``ErnieModel`` pooled -> ``Linear(H, 2)``) in fp32, H=128,
    nh=2, 2 layers, [4, 128], numpy weights, through ``Model.fit`` (3
    steps of AdamW, ``ClipGradByGlobalNorm(1.0)``, ``LinearWarmup``),
    ``evaluate`` and ``predict`` on the card (the ring loader with
    prefetch, the flash kernels) and on the CPU (the single-process
    loader): losses within 1e-5 relative, params within 1e-5 of their
    max, the evaluation loss and predictions within 1e-4 of max|ref|."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.framework import core
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig(vocab_size=512, hidden_size=128, num_layers=2,
                          num_heads=2, max_seq_len=128, dtype="float32")
    rng = np.random.default_rng(41)
    toks = rng.integers(0, 512, (20, 128)).astype(np.int64)
    labels = toks[:, :1] % 2

    class Tokens(pt.io.Dataset):
        def __init__(self, lo, hi):
            self.lo, self.hi = lo, hi

        def __len__(self):
            return self.hi - self.lo

        def __getitem__(self, i):
            return toks[self.lo + i], labels[self.lo + i]

    class Classifier(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.ernie = bert.ErnieModel(cfg)
            self.cls = pt.nn.Linear(128, 2)

        def forward(self, t):
            return self.cls(self.ernie(t)[1])

    weights, out = None, {}
    prev = core._state.expected_place
    try:
        for place in ("gpu", "cpu"):
            pt.set_device(place)
            net = Classifier()
            if weights is None:
                weights = {k: (1 + 0.1 * rng.standard_normal(p.shape)
                               if k.endswith("_g") else
                               0.02 * rng.standard_normal(p.shape))
                           .astype(np.float32)
                           for k, p in net.state_dict().items()}
            net.set_state_dict(weights)
            opt = pt.optimizer.AdamW(
                learning_rate=pt.optimizer.lr.LinearWarmup(1e-4, 1, 0.0,
                                                           1e-4),
                weight_decay=0.01, epsilon=1e-6,
                grad_clip=pt.nn.ClipGradByGlobalNorm(1.0),
                parameters=net.parameters())
            model = pt.Model(net)
            model.prepare(opt, pt.nn.CrossEntropyLoss(),
                          pt.metric.Accuracy())
            kw = (dict(num_workers=2, use_native_ring=True,
                       prefetch_to_device=2) if place == "gpu" else {})
            losses = []

            class Record(pt.callbacks.Callback):
                def on_train_batch_end(self, step, logs=None):
                    losses.append(logs["loss"])
            np.random.seed(7)
            model.fit(pt.io.DataLoader(Tokens(0, 12), batch_size=4,
                                       shuffle=True, **kw),
                      epochs=1, verbose=0, callbacks=[Record()])
            params = {k: p.numpy() for k, p in net.state_dict().items()}
            ev = model.evaluate(pt.io.DataLoader(Tokens(12, 20), batch_size=4,
                                                 **kw), verbose=0)
            pred = model.predict(pt.io.DataLoader(Tokens(12, 20),
                                                  batch_size=4, **kw),
                                 stack_outputs=True)[0]
            out[place] = losses, params, ev, pred
    finally:
        core._state.expected_place = prev
    (lg, pg, eg, dg), (lc, pc, ec, dc) = out["gpu"], out["cpu"]
    assert len(lg) == 3
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    for k in pc:
        np.testing.assert_allclose(pg[k], pc[k], rtol=0, err_msg=k,
                                   atol=1e-5 * np.abs(pc[k]).max())
    assert eg["acc"] == ec["acc"]
    assert abs(eg["loss"] - ec["loss"]) <= 1e-4 * abs(ec["loss"])
    np.testing.assert_allclose(dg, dc, rtol=0, atol=1e-4 * np.abs(dc).max())


_BF16, _F32 = torch.bfloat16, torch.float32
# (dtype, K, N, W's offset in elements from a 16-byte boundary, route)
_ROW_CASES = [
    # tensor cores: gpt_345m's four block products, a small one, K and N
    # off the 64-row and 64-column boxes, and both smaller than one box
    (_BF16, 1024, 3072, 0, "tensor"), (_BF16, 1024, 1024, 0, "tensor"),
    (_BF16, 1024, 4096, 0, "tensor"), (_BF16, 4096, 1024, 0, "tensor"),
    (_BF16, 256, 768, 0, "tensor"), (_BF16, 1032, 1000, 0, "tensor"),
    (_BF16, 8, 8, 0, "tensor"), (_BF16, 40, 24, 0, "tensor"),
    # CUDA cores: N % 8 != 0 (odd N: one-element loads), K % 8 != 0, W off
    # 16 bytes
    (_BF16, 13, 10, 0, "cuda_core"), (_BF16, 1030, 1001, 0, "cuda_core"),
    (_BF16, 1030, 1000, 0, "cuda_core"), (_BF16, 1024, 1024, 1, "cuda_core"),
    (_F32, 1024, 3072, 0, "cuda_core"), (_F32, 4096, 1024, 0, "cuda_core"),
    (_F32, 256, 768, 0, "cuda_core"), (_F32, 13, 10, 0, "cuda_core"),
    (_F32, 1030, 1001, 0, "cuda_core")]
_ROW_MS = (1, 2, 8, 10, 40, 64, 320)      # 320: 64 slots x a window of 5


def _row_close(got, ref, dt):
    if dt == _F32:
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=FP32_TOL * float(ref.abs().max()))
    else:
        torch.testing.assert_close(got.float(), ref.float(), rtol=2 ** -6,
                                   atol=2 ** -8)


@pytest.mark.parametrize("dt,K,N,off,route", _ROW_CASES)
def test_row_matmul_matches_plain_and_is_row_invariant(dev, dt, K, N, off,
                                                       route):
    """The row-invariant matmul against ``x @ w`` (fp32 within 1e-5 of
    max|ref|; bf16 2**-8 + 2**-6 |ref| per element, the dequant matmul's
    gate: cuBLAS reduces in fp32 too, in another order, and both round
    once), and each row of an [M, N] launch bit-equal to the M = 1 launch
    on that row, for M in 1, 2, 8, 10, 40, 64, 320, on the route the
    wrapper picks (asserted).  The bf16 tensor-core shapes also run the
    CUDA-core kernel on the same inputs, held to the same gate and row
    invariance."""
    gen = torch.Generator(device=dev).manual_seed(K + N)
    buf = torch.empty(K * N + 8, dtype=dt, device=dev)
    w = buf[off:off + K * N].view(K, N)
    w.copy_((torch.randn((K, N), device=dev, generator=gen) * 0.02).to(dt))
    x = torch.randn((max(_ROW_MS), K), device=dev, generator=gen).to(dt)
    assert row_matmul._args(x, w)[0] == route
    routes = [route] + (["cuda_core"] if route == "tensor" else [])
    with torch.inference_mode():
        mm = torch.backends.cuda.matmul
        was = mm.allow_bf16_reduced_precision_reduction
        mm.allow_bf16_reduced_precision_reduction = False
        try:
            ref = row_matmul._ref_matmul(x, w)
        finally:
            mm.allow_bf16_reduced_precision_reduction = was
        for r in routes:
            ones = torch.cat([row_matmul._launch(x[i:i + 1], w, r)
                              for i in range(x.shape[0])])
            for M in _ROW_MS:
                got = (row_matmul.matmul(x[:M], w) if r == route
                       else row_matmul._launch(x[:M], w, r))
                assert torch.equal(got, ones[:M]), (r, M)
            _row_close(ones, ref, dt)


# (x dtype, g and b dtype, K, N, route): qkv and fc1 of gpt_345m on both
# routes, K and N off the 64-row boxes (tensor cores), rows too wide for
# the tensor route's shared memory, off 8 and small (CUDA cores), fp32 on
# the CUDA cores
_LN_CASES = [
    *[(_BF16, g, K, N, "tensor") for g in (_F32, _BF16)
      for K, N in ((1024, 3072), (1024, 4096), (1032, 1000))],
    *[(_BF16, g, K, N, "cuda_core") for g in (_F32, _BF16)
      for K, N in ((1030, 1001), (13, 10), (2048, 512))],
    *[(_F32, g, K, N, "cuda_core") for g in (_F32, _BF16)
      for K, N in ((1024, 3072), (1024, 4096), (1030, 1001))]]


@pytest.mark.parametrize("dt,gdt,K,N,route", _LN_CASES)
def test_ln_matmul_matches_plain_and_is_row_invariant(dev, dt, gdt, K, N,
                                                      route):
    """The product with its LayerNorm prologue against its plain version
    (``_ref_layer_norm`` then ``x @ w``) at the row product's gates, at
    M = 8, 40 and the ragged 13 and 37, and each row of an [M, N] launch
    bit-equal to the M = 1 launch on that row for M in 1, 2, 8, 10, 40,
    64, 320, on the route the wrapper picks and, for the tensor route,
    on the CUDA cores too; each launch counted in ``launches`` and
    ``ln_launches``."""
    gen = torch.Generator(device=dev).manual_seed(K + N + 1)
    w = (torch.randn((K, N), device=dev, generator=gen) * 0.02).to(dt)
    x = (torch.randn((max(_ROW_MS), K), device=dev, generator=gen) * 2
         + 0.5).to(dt)
    g = (1 + 0.1 * torch.randn(K, device=dev, generator=gen)).to(gdt)
    b = (0.1 * torch.randn(K, device=dev, generator=gen)).to(gdt)
    assert row_matmul._args(x, w, ln=True)[0] == route
    routes = [route] + (["cuda_core"] if route == "tensor" else [])
    with torch.inference_mode():
        mm = torch.backends.cuda.matmul
        was = mm.allow_bf16_reduced_precision_reduction
        mm.allow_bf16_reduced_precision_reduction = False
        try:
            ref = row_matmul._ref_ln_matmul(x, g, b, 1e-5, w)
        finally:
            mm.allow_bf16_reduced_precision_reduction = was
        for r in routes:
            ones = torch.cat([row_matmul._ln_launch(x[i:i + 1], g, b, 1e-5,
                                                    w, r)
                              for i in range(x.shape[0])])
            for M in _ROW_MS:
                before = (row_matmul.launches, row_matmul.ln_launches)
                got = (row_matmul.ln_matmul(x[:M], g, b, 1e-5, w)
                       if r == route
                       else row_matmul._ln_launch(x[:M], g, b, 1e-5, w, r))
                assert (row_matmul.launches, row_matmul.ln_launches) == (
                    before[0] + 1, before[1] + 1)
                assert torch.equal(got, ones[:M]), (r, M)
            for M in (8, 13, 37, 40):
                _row_close(ones[:M], ref[:M], dt)


def test_ln_matmul_refuses_a_gradient_on_the_card(dev):
    x = torch.randn(8, 64, device=dev, requires_grad=True)
    g, b = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    w = torch.randn(64, 32, device=dev)
    before = row_matmul.ln_launches
    with pytest.raises(RuntimeError, match="ln_matmul: a forward only"):
        row_matmul.ln_matmul(x, g, b, 1e-5, w)
    assert row_matmul.ln_launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_verify_lane_writes_the_decode_bytes(dev, dtype):
    """One fp verify against one paged decode from the same pool: lane 0
    of the verify's window K/V (what an accepted lane commits) is
    bit-equal to what the decode writes, in every layer, because both take
    the row-invariant products (4L launches each, 2L of them with the
    LayerNorm prologue)."""
    cfg = dataclasses.replace(_wide(), dtype=dtype)
    L = cfg.num_layers
    params = T.prepare_params(T.init_params(
        cfg, torch.Generator().manual_seed(3), device=dev), cfg)
    S, ps, maxP = 2, 8, 4
    cache = T.init_paged_cache(cfg, 1 + S * maxP, ps, device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    for name in ("k", "v"):
        cache[name].copy_(torch.randn(cache[name].shape, device=dev,
                                      generator=g).to(cache[name].dtype))
    table = (1 + torch.arange(S * maxP, device=dev, dtype=torch.int32)
             ).reshape(S, maxP)
    lens = torch.tensor([5, 11], device=dev, dtype=torch.int32)
    toks = torch.tensor([[7, 9, 3, 1, 2], [4, 8, 6, 5, 0]], device=dev,
                        dtype=torch.int32)
    pos = lens.long()
    wp = table.long()[torch.arange(S, device=dev), pos // ps]
    wo = pos % ps
    with torch.inference_mode():
        row_matmul.launches = row_matmul.ln_launches = 0
        _, wk, wv = T.decode_step_paged_verify(
            params, toks, cfg, cache["k"].clone(), cache["v"].clone(), table,
            lens)
        assert (row_matmul.launches, row_matmul.ln_launches) == (4 * L,
                                                                 2 * L)
        ck, cv = cache["k"].clone(), cache["v"].clone()
        T.decode_step_paged(params, toks[:, 0], cfg, ck, cv, table, wp, wo,
                            lens)
        assert (row_matmul.launches, row_matmul.ln_launches) == (8 * L,
                                                                 4 * L)
    for i in range(L):
        assert torch.equal(wk[i, :, 0], ck[i, wp, wo]), i
        assert torch.equal(wv[i, :, 0], cv[i, wp, wo]), i


# --------------------------------------------------------------------------
# the eager tensor API on the card: a compact copy of chip_smoke.py (ad)
# --------------------------------------------------------------------------

@pytest.fixture
def card():
    """Skips without a card (the ops here build no kernel, so nvcc is not
    needed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _first_per_op(cases):
    seen, out = set(), []
    for c in cases:
        op = c.name.split(":")[0]
        if op not in seen:
            seen.add(op)
            out.append(c)
    return out


def test_op_sweep_on_card(card):
    """One case of every op, activation and loss, and every case of the
    rest of nn (functionals and layers), on the card against the CPU:
    values, dtypes and gradients at the case's tolerance, every output on
    the card."""
    import paddle_tpu_torch as pt
    from tools import op_sweep as S
    cases = (_first_per_op(S.TENSOR_CASES) + _first_per_op(S.ACT_CASES)
             + _first_per_op(S.LOSS_CASES) + S.LOSS_LAYER_CASES
             + S.NN_CASES + S.NN_LAYER_CASES)
    checked, failed, _ = S.card_sweep(pt, cases)
    assert not failed, failed
    assert len(checked) == len(cases)


def test_setitem_and_inplace_grads_on_card(card):
    """``x[i] = v`` and the in-place operators on the card: values and the
    gradients flowing to x and v equal the CPU's."""
    import paddle_tpu_torch as pt
    from tools import op_sweep as S
    cases = [c for c in S.TENSOR_CASES
             if c.name.startswith(("op:setitem", "op:i", "method:inplace"))]
    assert len(cases) >= 8
    checked, failed, _ = S.card_sweep(pt, cases)
    assert not failed, failed


def test_host_sync_ops_return_on_the_card(card):
    """The ops whose output size depends on the data read it back from the
    card and return their outputs there, equal to the CPU's."""
    import paddle_tpu_torch as pt
    from tools import op_sweep as S
    names = ("nonzero", "unique", "unique_consecutive", "masked_select",
             "where:nonzero", "mode", "op:getitem_mask", "op:setitem_mask")
    cases = [c for c in S.TENSOR_CASES
             if c.name.split(":")[0] in names or c.name in names]
    assert len(cases) >= 10
    checked, failed, _ = S.card_sweep(pt, cases)
    assert not failed, failed


def test_random_ops_draw_on_the_card(card):
    """The random ops draw from the card's generator: the reference's
    dtypes, their ranges and moments, one seed one draw, and no draw on
    the card moves the CPU's stream."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.framework import core
    from tools import op_sweep as S
    checked, failed = S.card_random(pt)
    assert not failed, failed
    prev = core._state.expected_place
    try:
        pt.set_device("cpu")
        pt.seed(3)
        a = pt.rand([8]).numpy()
        pt.seed(3)
        pt.set_device("gpu")
        pt.rand([1000])
        pt.set_device("cpu")
        np.testing.assert_array_equal(pt.rand([8]).numpy(), a)
    finally:
        core._state.expected_place = prev


def test_dtype_faults_stay_closed_on_card(card):
    """The dtype axis of the op tables (bool, small and unsigned integers,
    16-bit floats: casts that saturate and map NaN to 0, unsigned sums,
    bool products, integer division by zero, bf16 to the host) on the
    card against the CPU, every output on the card."""
    import paddle_tpu_torch as pt
    from tools import op_sweep as S
    checked, failed, _ = S.card_sweep(pt, S.DTYPES)
    assert not failed, failed
    assert len(checked) == len(S.DTYPES)


# --------------------------------------------------------------------------
# jit.to_static: one CUDA graph per signature
# --------------------------------------------------------------------------

def _small_encoder(pt, L=2, H=128, nh=2, F=256, V=512, N=64, dropout=0.0):
    from paddle_tpu_torch import nn

    class Enc(nn.Layer):
        def __init__(self):
            super().__init__()
            self.word = nn.Embedding(V, H)
            self.pos = nn.Embedding(N, H)
            self.encoder = nn.TransformerEncoder(
                nn.TransformerEncoderLayer(H, nh, F, dropout=dropout,
                                           activation="gelu",
                                           attn_dropout=0.0,
                                           normalize_before=True),
                L, norm=nn.RMSNorm(H))
            for layer in self.encoder.layers:
                layer.self_attn.dropout = 0.0
            self.head = nn.Linear(H, V)

        def forward(self, ids):
            h = self.word(ids) + self.pos(pt.arange(ids.shape[1]))
            h = self.encoder(h)
            return h, self.head(h)
    m = Enc().eval()
    rng = np.random.RandomState(0)
    m.set_state_dict({k: (1 + 0.1 * rng.standard_normal(v.shape)
                          if "norm" in k else
                          0.02 * rng.standard_normal(v.shape)).astype(
                              np.float32)
                      for k, v in m.state_dict().items()})
    return m


def _counts():
    return (norms.launches, flash_attn.fwd_launches, norms.rms_launches)


@pytest.fixture
def on_card(dev):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.framework import core
    prev = core._state.expected_place
    pt.set_device("gpu")
    yield pt
    core._state.expected_place = prev


def test_to_static_captures_once_and_replays_with_launch_counts(on_card):
    """The first call captures (one warm-up, one capture), later calls
    replay: each replay adds 2L LayerNorm, L flash forward and 1 RMSNorm
    launches to the counters, the outputs equal the eager forward's bit
    for bit, stop gradients, and an output a caller holds keeps its value
    after the next replay.  A second shape captures a second graph."""
    pt = on_card
    from paddle_tpu_torch.ops import dispatch
    model = _small_encoder(pt)
    sfn = pt.jit.to_static(model)
    rng = np.random.RandomState(1)
    ids = [pt.to_tensor(rng.randint(0, 512, (2, 64)).astype(np.int32))
           for _ in range(3)]
    dispatch.reset_cache_stats()
    sfn(ids[0])
    st = dispatch.cache_stats()
    assert (st["misses"], st["warming"], st["hits"]) == (1, 1, 0), st
    before = _counts()
    h1, l1 = sfn(ids[1])
    keep = l1.numpy().copy()
    h2, l2 = sfn(ids[2])
    torch.cuda.synchronize()
    got = tuple(a - b for a, b in zip(_counts(), before))
    assert got == (2 * 2 * 2, 2 * 2, 2), got
    assert dispatch.cache_stats()["hits"] == 2
    assert l1.stop_gradient and h1.stop_gradient
    np.testing.assert_array_equal(l1.numpy(), keep)
    with pt.no_grad():
        eh, el = model(ids[2])
    np.testing.assert_array_equal(l2.numpy(), el.numpy())
    np.testing.assert_array_equal(h2.numpy(), eh.numpy())
    sfn(pt.to_tensor(rng.randint(0, 512, (1, 32)).astype(np.int32)))
    st = dispatch.cache_stats()
    assert st["misses"] == 2 and st["evictions"] == 0 and st["fallbacks"] == 0
    assert len(sfn._graphs) == 2


def test_to_static_sees_in_place_updates_and_recaptures_rebinding(on_card):
    pt = on_card
    from paddle_tpu_torch.ops import dispatch
    model = _small_encoder(pt)
    sfn = pt.jit.to_static(model)
    ids = pt.to_tensor(np.random.RandomState(2).randint(
        0, 512, (2, 64)).astype(np.int32))
    sfn(ids)
    dispatch.reset_cache_stats()
    w = model.head.weight
    w.set_value(w.numpy() * 2.0)               # in place: seen
    _, got = sfn(ids)
    with pt.no_grad():
        _, want = model(ids)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert dispatch.cache_stats()["misses"] == 0
    model.to(dtype="bfloat16")                 # rebinding: a new capture
    _, got = sfn(ids)
    _, got2 = sfn(ids)
    with pt.no_grad():
        _, want = model(ids)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got2.value, want.value)
    assert dispatch.cache_stats()["misses"] == 1


def test_to_static_dropout_draws_fresh_masks(on_card):
    """A training-mode forward with dropout: two replays draw different
    masks; re-seeding gives the first replay's mask again."""
    pt = on_card
    drop = pt.nn.Dropout(0.1)
    sfn = pt.jit.to_static(drop)
    x = pt.to_tensor(np.ones((64, 256), np.float32))
    sfn(x)                                     # warm-up and capture
    pt.seed(11)
    a = sfn(x).numpy()
    b = sfn(x).numpy()
    pt.seed(11)
    c = sfn(x).numpy()
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(a, c)
    assert abs((a == 0).mean() - 0.1) < 0.02


def test_check_numerics_and_nan_guard_inside_a_graph(on_card):
    """``check_numerics`` in a captured forward raises ``NanInfError`` at
    the call that replays it, not with finite weights; the nan guard on
    during the capture names the first op with a non-finite output."""
    pt = on_card
    w = pt.to_tensor(np.ones((4, 4), np.float32))

    def fn(x):
        return pt.debug.check_numerics(pt.matmul(x, w) + 1.0, "fwd")
    sfn = pt.jit.to_static(fn)
    x = pt.to_tensor(np.ones((2, 4), np.float32))
    sfn(x)
    sfn(x)                                     # a replay, finite
    w.value[0, 0] = float("inf")
    with pytest.raises(pt.debug.NanInfError, match="fwd: non-finite"):
        sfn(x)
    w.value[0, 0] = 1.0

    def g(x):
        return pt.tanh(pt.matmul(x, w)) * 2.0
    with pt.debug.check_nan_inf_guard():
        sg = pt.jit.to_static(g)
        sg(x)
        sg(x)
        w.value[1, 1] = float("nan")
        with pytest.raises(pt.debug.NanInfError, match="op 'matmul'"):
            sg(x)


def test_nan_guard_state_keys_the_graph_and_checks_the_taken_branch(
        on_card):
    """The guard's state is part of the signature: turning it off makes
    a new graph that checks nothing, turning it on again replays the
    guarded one.  A ``cond`` captured under the guard raises for a
    non-finite value in the branch the predicate selects, not in the
    other one."""
    pt = on_card
    from paddle_tpu_torch.ops import dispatch
    w = pt.to_tensor(np.ones((4, 4), np.float32))

    def g(x):
        return pt.tanh(pt.matmul(x, w))
    sg = pt.jit.to_static(g)
    x = pt.to_tensor(np.ones((2, 4), np.float32))
    dispatch.reset_cache_stats()
    with pt.debug.check_nan_inf_guard():
        sg(x)
        w.value[1, 1] = float("nan")
        with pytest.raises(pt.debug.NanInfError, match="op 'matmul'"):
            sg(x)
    sg(x)                                      # guard off: a new graph
    sg(x)
    assert dispatch.cache_stats()["misses"] == 2
    with pt.debug.check_nan_inf_guard():
        with pytest.raises(pt.debug.NanInfError, match="op 'matmul'"):
            sg(x)
    assert dispatch.cache_stats()["misses"] == 2

    def f(x):
        return pt.static.cond(x.sum() > 0, lambda: pt.log(x), lambda: -x)
    with pt.debug.check_nan_inf_guard():
        sf = pt.jit.to_static(f)
        neg = pt.to_tensor(np.array([-1.0, -2.0], np.float32))
        for _ in range(3):                     # warm-up, capture, replay
            np.testing.assert_array_equal(sf(neg).numpy(), [1.0, 2.0])
        mixed = pt.to_tensor(np.array([-1.0, 4.0], np.float32))
        with pytest.raises(pt.debug.NanInfError, match="op 'log'"):
            sf(mixed)


def test_to_static_raw_torch_tensors_are_inputs(on_card):
    """A raw ``torch.Tensor`` argument is keyed by shape, dtype and
    device and copied in at each replay, as a Tensor is; a host read of
    a Tensor inside the forward breaks the capture and that signature
    runs eagerly."""
    pt = on_card
    from paddle_tpu_torch.ops import dispatch
    sfn = pt.jit.to_static(lambda x, t: x * t)    # t arrives a Tensor
    x = pt.to_tensor(np.ones((3,), np.float32))
    dispatch.reset_cache_stats()
    for k in range(4):
        t = torch.full((3,), float(k), device=x.value.device)
        np.testing.assert_array_equal(sfn(x, t).numpy(), [k] * 3)
    st = dispatch.cache_stats()
    assert (st["misses"], st["hits"], st["fallbacks"]) == (1, 3, 0), st
    sh = pt.jit.to_static(lambda x: x * float(x.sum()))
    for _ in range(2):
        np.testing.assert_array_equal(sh(x).numpy(), [3.0] * 3)
    st = dispatch.cache_stats()
    assert st["fallbacks"] == 2 and st["blacklisted"] >= 1, st


def test_to_static_replay_is_one_profiler_event(on_card):
    """With the profiler on, a replay records one host event under the
    layer's name and none for the ops inside the graph."""
    pt = on_card
    net = pt.nn.Sequential(pt.nn.Linear(64, 64), pt.nn.GELU())
    sfn = pt.jit.to_static(net)
    x = pt.to_tensor(np.ones((8, 64), np.float32))
    sfn(x)                                     # warm-up and capture
    with pt.profiler.Profiler() as prof:
        sfn(x)
        sfn(x)
    rows = {r[0]: r[1] for r in prof.summary()[1:]}
    assert rows == {"Sequential": 2}, rows


def test_to_static_control_flow_on_card(on_card):
    """``cond`` on a tensor predicate is captured (both branches, one
    select); ``while_loop`` on one cannot be and runs eagerly, counted
    under ``fallbacks``; both equal the eager results."""
    pt = on_card
    from paddle_tpu_torch.ops import dispatch

    def f(x):
        return pt.static.cond(x.sum() > 0, lambda: x * 2, lambda: -x)

    def w(x):
        i = pt.zeros([], "int32")
        _, y = pt.static.while_loop(lambda i, y: i < 4,
                                    lambda i, y: (i + 1, y + x), [i, x * 0])
        return y
    sf, sw = pt.jit.to_static(f), pt.jit.to_static(w)
    dispatch.reset_cache_stats()
    for v in ([1.0, 2.0], [-1.0, -2.0], [3.0, -1.0]):
        x = pt.to_tensor(np.array(v, np.float32))
        np.testing.assert_array_equal(sf(x).numpy(), f(x).numpy())
        np.testing.assert_array_equal(sw(x).numpy(), w(x).numpy())
    st = dispatch.cache_stats()
    assert st["misses"] == 1 and st["hits"] == 2, st
    # the while loop's capture broke once, then two eager calls
    assert st["fallbacks"] == 3 and st["blacklisted"] == 1, st


# --------------------------------------------------------------------------
# the kernels as torch.library ops, the exported artifact's graph a bucket,
# the async checkpoint and the reader on the card
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_registered_ops_match_plain_on_card(dev, dtype):
    """``paddle_tpu::layer_norm``, ``rms_norm`` and ``flash_fwd`` on CUDA
    tensors launch their kernels (one count each) and agree with their
    plain versions at the tolerances above; their fake implementations
    give the real outputs' shapes and dtypes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(4, 33, 96, device=dev, generator=g).to(dtype)
    w = (1 + 0.1 * torch.randn(96, device=dev, generator=g)).to(dtype)
    b = (0.1 * torch.randn(96, device=dev, generator=g)).to(dtype)
    q, k, v = (torch.randn(2, 70, 3, 64, device=dev, generator=g).to(dtype)
               for _ in range(3))
    n0 = (norms.launches, norms.rms_launches, flash_attn.fwd_launches)
    ln = torch.ops.paddle_tpu.layer_norm(x, w, b, 1e-5)
    rms = torch.ops.paddle_tpu.rms_norm(x, w, 1e-6)
    out, lse = torch.ops.paddle_tpu.flash_fwd(q, k, v, True)
    assert (norms.launches, norms.rms_launches, flash_attn.fwd_launches) \
        == tuple(n + 1 for n in n0)
    tol = FP32_TOL if dtype == torch.float32 else 2.0 ** -7
    for got, ref in ((ln, norms._ref_layer_norm(x, w, b, 1e-5)),
                     (rms, norms._ref_rms_norm(x, w, 1e-6))):
        assert got.dtype == dtype and got.shape == x.shape
        scale = ref.float().abs().max() if dtype == torch.float32 else \
            ref.float().abs()
        assert ((got.float() - ref.float()).abs() <= tol * scale + (
            0 if dtype == torch.float32 else 2.0 ** -8)).all()
    ro, rl = flash_attn._ref_flash_fwd(q, k, v, True)
    assert (out.float() - ro.float()).abs().max() <= (
        FP32_TOL * float(ro.float().abs().max()) if dtype == torch.float32
        else 2.0 ** -8 + 2.0 ** -6 * float(ro.float().abs().max()))
    assert (lse - rl).abs().max() <= 1e-4
    with FakeTensorMode() as mode:
        fx, fw, fb, fq = (mode.from_tensor(t) for t in (x, w, b, q))
        fo, fl = torch.ops.paddle_tpu.flash_fwd(fq, fq, fq, False)
        assert torch.ops.paddle_tpu.layer_norm(fx, fw, fb, 1e-5).shape == \
            x.shape
        assert (fo.shape, fo.dtype, fl.shape, fl.dtype) == (
            q.shape, dtype, (2, 3, 70), torch.float32)


def test_exported_artifact_replays_one_graph_a_bucket(on_card, tmp_path):
    """A small encoder exported on the card with a dynamic batch: batch 4
    captures its graph, batch 3 pads to the 4-bucket and the probe
    replays it twice, batch 4 replays once; each run adds 2L LayerNorm, L
    flash forward and 1 RMSNorm launch a pass; ``standalone_compiles``
    moves by one; outputs within 1e-5 of the eager forward's max."""
    pt = on_card
    from paddle_tpu_torch.inference import export
    model = _small_encoder(pt)
    prefix = str(tmp_path / "enc")
    meta = pt.inference.save_inference_model(
        prefix, model, [pt.static.InputSpec([None, 64], "int32")])
    assert meta["dynamic_batch"]
    sm = export.StandaloneModel(prefix)
    rng = np.random.RandomState(3)
    ids = {b: rng.randint(0, 512, (b, 64)).astype(np.int32) for b in (3, 4)}
    c0 = export.serving_stats()["standalone_compiles"]
    per = (2 * 2, 2, 1)
    for b, passes in ((4, 1), (3, 2), (4, 1)):
        before = _counts()
        outs = sm(ids[b])
        torch.cuda.synchronize()
        got = tuple(a - z for a, z in zip(_counts(), before))
        assert got == tuple(passes * n for n in per), (b, got)
        with pt.no_grad():
            want = model(pt.to_tensor(ids[b]))
        for o, w in zip(outs, want):
            assert o.shape == w.value.shape and o.is_cuda
            assert (o - w.value).abs().max() <= \
                FP32_TOL * w.value.abs().max()
    assert export.serving_stats()["standalone_compiles"] == c0 + 1
    assert len(sm._calls) == 1


def test_async_save_then_step_writes_the_pre_step_values(on_card, tmp_path):
    """``CheckpointManager(async_save=True)``: a save followed at once by
    an optimizer step (no sync between) writes the values before it."""
    pt = on_card
    from paddle_tpu_torch.utils import CheckpointManager
    net = pt.nn.Linear(1024, 1024)
    opt = pt.optimizer.Adam(learning_rate=0.1, parameters=net.parameters())
    x = pt.to_tensor(np.ones((64, 1024), np.float32))
    pt.mean(net(x)).backward()
    before = net.weight.value.detach().clone()
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, model=net, optimizer=opt)
    opt.step()
    mgr.wait()
    assert not torch.equal(net.weight.value, before)
    got = pt.load(str(tmp_path / "step_1" / "model.pdparams"))
    assert torch.equal(got["weight"].value.to(before.device), before)


def test_double_buffer_feeds_the_card_without_a_host_sync(on_card):
    """A started py_reader with the double buffer fills a static program
    on the card: each batch goes through pinned memory with non-blocking
    copies, and a fetchless run makes no host sync
    (``torch.cuda.set_sync_debug_mode("error")``); the loss then equals
    the same program fed the same batch by hand."""
    pt = on_card
    from paddle_tpu_torch import fluid, static
    pt.enable_static()
    try:
        main, startup = static.Program(), static.Program()
        with static.program_guard(main, startup):
            rd = fluid.layers.py_reader(capacity=2, shapes=[(-1, 64)],
                                        dtypes=["float32"],
                                        use_double_buffer=True)
            x = fluid.layers.read_file(rd)
            loss = pt.mean(static.nn.fc(x, 8))
        rng = np.random.RandomState(0)
        batches = [(rng.randn(16, 64).astype(np.float32),)
                   for _ in range(3)]
        rd.decorate_batch_generator(lambda: iter(batches))
        exe = static.Executor()
        rd.start()
        assert rd._pass.ring is not None
        exe.run(main, fetch_list=[])            # warm: the replay prepared
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            exe.run(main, fetch_list=[])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        got, = exe.run(main, fetch_list=[loss])
        with pytest.raises(fluid.core.EOFException):
            exe.run(main, fetch_list=[loss])
        rd.reset()
        want, = exe.run(main, feed={x.name: batches[2][0]},
                        fetch_list=[loss])
    finally:
        pt.disable_static()
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# the sequence-to-sequence path: chip_smoke.py (am), (an) at small widths
# --------------------------------------------------------------------------

def test_flash_promotes_a_bf16_query_against_fp32_caches(dev):
    """A bf16 query against float32 k and v (a bf16 decode step against
    ``gen_cache``'s float32 caches): the nn functional promotes, the fp32
    forward kernel runs once, and the float32 output equals the plain
    version on the promoted operands."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.nn.functional import flash_attention
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(32, 1, 8, 64, device=dev, generator=g).bfloat16()
    k, v = (torch.randn(32, 33, 8, 64, device=dev, generator=g)
            for _ in range(2))
    before = flash_attn.fwd_launches
    out = flash_attention(pt.to_tensor(q), pt.to_tensor(k), pt.to_tensor(v))
    assert flash_attn.fwd_launches == before + 1
    assert out.value.dtype == torch.float32
    ref = flash_attn._ref_flash_fwd(q.float(), k, v, False)[0]
    torch.testing.assert_close(out.value, ref, atol=FP32_TOL, rtol=0)


def _seq2seq_parity(run, beam):
    """``run()`` -> (loss, model, beam outputs) on the card and on the
    CPU (``tools/seq2seq.py``): the loss within 1e-5, every gradient
    within 1e-4 of the largest, the beams exact."""
    import paddle_tpu_torch as pt
    from tools import seq2seq
    res = seq2seq.card_against_cpu(pt, lambda place: (*run(), None))
    err = seq2seq.loss_grad_errors(res)
    assert err["loss_rel_err"] <= 1e-5, err
    assert err["grad_err_over_max"] <= 1e-4, err
    beams = seq2seq.beam_parity(res, beam)
    assert beams["tokens_equal"] and beams["parents_equal"], beams


def _beam(pt, cell, init, beam, steps):
    from tools import seq2seq
    return seq2seq.beam_decode(pt, cell, init, beam, steps)


def test_transformer_seq2seq_step_and_beam_on_card_match_cpu(dev):
    """(am)'s model at d_model 64, 2 + 2 layers, V 500, fp32, dropout 0:
    one step's loss and gradients and a 10-step beam decode, card against
    CPU; 2L flash forwards, dq and dk/dv in the card's step."""
    import paddle_tpu_torch as pt
    from tools import seq2seq
    rng = np.random.default_rng(5)
    src, tgt = rng.integers(3, 500, (4, 12)), rng.integers(3, 500, (4, 9))
    state = {}

    def run():
        pt.seed(0)
        model = seq2seq.nmt_transformer(pt, 500, 64, 4, 2, 128, 0.0, 64)
        if not state:
            state.update({k: 0.05 * rng.standard_normal(v.shape).astype(
                np.float32) for k, v in model.state_dict().items()})
        model.set_state_dict(state)
        before = flash_attn.fwd_launches
        logits = model(pt.to_tensor(src), pt.to_tensor(tgt[:, :-1]))
        fwd.append(flash_attn.fwd_launches - before)
        loss = seq2seq.label_smoothed_ce(pt, logits, pt.to_tensor(
            tgt[:, 1:]), 500)
        model.eval()
        cell = seq2seq.TransformerCell(pt, model.transformer.decoder,
                                       model.embed, model.project)
        with pt.no_grad():
            init = cell.initial(model.encode(pt.to_tensor(src[:2])))
        return loss, model, _beam(pt, cell, init, 4, 10)
    fwd = []
    before = (flash_attn.dq_launches, flash_attn.dkv_launches)
    _seq2seq_parity(run, 4)
    # the card's step: encoder self- and cross-attention take the kernels
    # (the decoder's self-attention is dense under its mask); the CPU
    # launches nothing
    assert fwd == [4, 0]
    assert (flash_attn.dq_launches - before[0],
            flash_attn.dkv_launches - before[1]) == (4, 4)


def test_rnn_seq2seq_step_and_beam_on_card_match_cpu(dev):
    """(an)'s model at hidden 64, vocabularies 300 / 200, fp32, dropout 0,
    ragged lengths: one step's loss and gradients and a 10-step beam-5
    decode, card against CPU."""
    import paddle_tpu_torch as pt
    from tools import seq2seq
    rng = np.random.default_rng(6)
    src = rng.integers(3, 300, (6, 14))
    src_len = rng.integers(3, 15, 6)
    tgt = rng.integers(3, 200, (6, 11))
    tgt_len = rng.integers(3, 11, 6)
    state = {}

    def run():
        model = seq2seq.rnn_seq2seq(pt, 300, 200, 64, 2, 0.0)
        if not state:
            state.update({k: 0.1 * rng.standard_normal(v.shape).astype(
                np.float32) for k, v in model.state_dict().items()})
        model.set_state_dict(state)
        logits = model(pt.to_tensor(src), pt.to_tensor(src_len),
                       pt.to_tensor(tgt[:, :-1]))
        loss = seq2seq.masked_ce(pt, logits, pt.to_tensor(tgt[:, 1:]),
                                 pt.to_tensor(tgt_len))
        model.eval()
        with pt.no_grad():
            init = model.encode(pt.to_tensor(src[:2]),
                                pt.to_tensor(src_len[:2]))
        return loss, model, _beam(pt, seq2seq.RNNCell(model), init, 5, 10)
    _seq2seq_parity(run, 5)


@pytest.fixture
def card():
    """A CUDA device; the vision ops need no kernel build."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.framework import core
    prev = core._state.expected_place
    yield pt
    core._state.expected_place = prev


def _on(pt, place, fn, arrays, grads=()):
    """``fn`` of Tensors made from ``arrays`` on ``place``: its outputs
    and the listed inputs' gradients of sum(first output), as numpy."""
    pt.set_device(place)
    ts = [pt.to_tensor(a, stop_gradient=i not in grads)
          for i, a in enumerate(arrays)]
    out = fn(*ts)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    if grads:
        outs[0].sum().backward()
    return ([np.asarray(o.numpy()) for o in outs]
            + [np.asarray(ts[i].grad.numpy()) for i in grads])


def _vision_boxes(rng, *shape):
    xy = rng.uniform(0, 0.6, shape + (2,))
    wh = rng.uniform(0.02, 0.4, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("case", ["voc", "ties", "eta"])
def test_multiclass_nms_on_card_matches_cpu(card, case):
    """The batched greedy NMS at (ap)'s shape (8 images, 21 classes, 1,917
    boxes, top 400, keep 200), on tie sets (quantised scores, duplicated
    boxes) and under the adaptive eta: rows and kept indices on the card
    equal the CPU's, bit for bit (the same IoU arithmetic)."""
    pt = card
    from paddle_tpu_torch.vision import detection as D
    rng = np.random.RandomState(30)
    boxes = _vision_boxes(rng, 8, 1917)
    if case == "ties":
        boxes[:, 600:1200] = boxes[:, :600]
        scores = rng.choice([0.02, 0.3, 0.3, 0.6], (8, 21, 1917))
    else:
        scores = rng.uniform(0, 1, (8, 21, 1917)) ** 4
    kw = dict(score_threshold=0.01, nms_top_k=400, keep_top_k=200,
              nms_threshold=0.45, return_index=True)
    if case == "eta":
        kw.update(nms_eta=0.9, nms_threshold=0.8)
    fn = lambda b, s: D.multiclass_nms(b, s, **kw)     # noqa: E731
    args = [boxes, scores.astype(np.float32)]
    got, want = _on(pt, "gpu", fn, args), _on(pt, "cpu", fn, args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (want[1] >= 0).sum() > 100


def test_ssd_loss_on_card_matches_cpu(card):
    """``ssd_loss`` at (ap)'s shape (8 images, 1,917 priors, 21 classes,
    8 gts with padding): the loss within 1e-5 and the location and
    confidence gradients within 1e-5 of max|ref|; the matching and the
    hard negatives (integers) decide the same terms on both."""
    pt = card
    from paddle_tpu_torch.vision import detection as D
    rng = np.random.RandomState(31)
    gt = _vision_boxes(rng, 8, 8)
    gt[:, 5:] = 0.0
    args = [(rng.randn(8, 1917, 4) * 0.3).astype(np.float32),
            rng.randn(8, 1917, 21).astype(np.float32), gt,
            rng.randint(1, 21, (8, 8)).astype(np.int64),
            _vision_boxes(rng, 1917)]
    got = _on(pt, "gpu", D.ssd_loss, args, grads=(0, 1))
    want = _on(pt, "cpu", D.ssd_loss, args, grads=(0, 1))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=FP32_TOL * np.abs(w).max())
