"""paddle_tpu_torch's quantized serving path against the JAX package.

The same numpy-drawn inputs go through the JAX functions and the port's
plain PyTorch versions on the CPU: weight and KV quantization, the
dequant matmul and int8 paged attention (also against the Pallas kernels
in interpret mode), a quantized block and decode step, and the whole
``PagedServingEngine(quant="int8", kv_dtype="int8")`` under churn, a
prefix hit, copy-on-write and preemption.

Tolerances:

* quantization: int8 codes and fp32 scales byte-equal (the same fp32 ops;
  ``torch.round`` and ``jnp.round`` both round half to even);
* dequant matmul and int8 paged attention: 1e-5 in float32 (only the
  order of fp32 sums differs); in bf16 one rounding step (2**-7 relative),
  where the two frameworks round at the same places;
* block and decode step: 1e-5;
* engine against the JAX engine (fp32): greedy tokens exact, logits within
  1e-3.  The K/V written into the int8 pool come out of two forwards that
  differ by about 1e-7, which can move a value across a rounding midpoint:
  codes may differ by 1, in at most 0.1% of them;
* quantized engine against the fp32 engine, both in the port: tokens
  exact, logits within 0.05 (the JAX suite's ``LOGIT_BUDGET``).

The CUDA kernels are held against the plain versions on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import quantization as JQ
from paddle_tpu.inference import serving as JS
from paddle_tpu.models import gpt as J
from paddle_tpu.ops.pallas import dequant_matmul as jax_dqmm
from paddle_tpu.ops.pallas import paged_attn as jax_paged
from paddle_tpu_torch import quantization as TQ
from paddle_tpu_torch.inference import serving as S
from paddle_tpu_torch.models import gpt as T
from paddle_tpu_torch.ops.cuda import dequant_matmul as dqmm
from paddle_tpu_torch.ops.cuda import norms, paged_attn
from test_torch_gpt import numpy_params

FP32_TOL = 1e-5
BF16_RTOL = 2.0 ** -7
ENGINE_LOGIT_TOL = 1e-3
LOGIT_BUDGET = 0.05
CODE_FLIP_SHARE = 1e-3
QLEAVES = ("qkv_w", "proj_w", "fc1_w", "fc2_w")


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() \
            else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def _cfg(mod, **kw):
    base = dict(vocab_size=256, hidden_size=32, num_layers=2, num_heads=2,
                max_seq_len=64, dtype="float32", use_flash=False,
                remat=False, use_pallas_norm=True)
    base.update(kw)
    return mod.GPTConfig(**base)


@pytest.fixture(scope="module")
def model():
    jcfg = _cfg(J)
    tree = numpy_params(jcfg, 0)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, jp, _cfg(T), tree


# --------------------------------------------------------------------------
# quantization
# --------------------------------------------------------------------------

def test_quant_absmax_scale_matches_reference():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((2, 8, 3, 4)) * 0.3).astype(np.float32)
    w[1, :, 2, 1] = 0.0                            # an all-zero channel
    for axis in (None, 0, (0, 2, 3), -1):
        got = TQ.quant_absmax_scale(_t(w), axis=axis)
        want = JQ.quant_absmax_scale(jnp.asarray(w), axis=axis)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantize_params_byte_equal(model):
    _, jp, _, tree = model
    jq = J.quantize_params(jp, "int8")
    tq = T.quantize_params(T.params_from_numpy(tree, "cpu"), "int8")
    for name in QLEAVES:
        got, want = tq["blocks"][name], jq["blocks"][name]
        assert got["qw"].dtype == torch.int8
        assert got["scale"].dtype == torch.float32
        np.testing.assert_array_equal(got["qw"].numpy(),
                                      np.asarray(want["qw"]))
        np.testing.assert_array_equal(got["scale"].numpy(),
                                      np.asarray(want["scale"]))
    # everything else is left as it was
    np.testing.assert_array_equal(tq["blocks"]["qkv_b"].numpy(),
                                  tree["blocks"]["qkv_b"])
    assert tq["wte"].dtype == torch.float32
    # an already quantized tree is kept
    again = T.quantize_params(tq, "int8")
    assert again["blocks"]["fc1_w"]["qw"] is tq["blocks"]["fc1_w"]["qw"]


@pytest.mark.parametrize("mode", ["int8_dynamic", "fp8"])
def test_quantize_params_other_modes_byte_equal(model, mode):
    _, jp, _, tree = model
    jq = J.quantize_params(jp, mode)
    tq = T.quantize_params(T.params_from_numpy(tree, "cpu"), mode)
    key = "qw_dyn" if mode == "int8_dynamic" else "qw"
    for name in QLEAVES:
        got, want = tq["blocks"][name], jq["blocks"][name]
        assert sorted(got) == sorted(want) == sorted([key, "scale"])
        # compare the code bytes (fp8 as its raw byte pattern)
        np.testing.assert_array_equal(
            got[key].view(torch.uint8).numpy(),
            np.asarray(want[key]).view(np.uint8))
        np.testing.assert_array_equal(got["scale"].numpy(),
                                      np.asarray(want["scale"]))


def test_int8_dynamic_matmul_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 32).astype(np.float32)
    w = rng.randn(32, 16).astype(np.float32)
    ws = (np.abs(w).max(0) / 127.0).astype(np.float32)
    wq = np.clip(np.round(w / ws), -127, 127).astype(np.int8)
    for dt, jdt, tol in ((torch.float32, jnp.float32, FP32_TOL),
                         (torch.bfloat16, jnp.bfloat16, FP32_TOL)):
        got = TQ.int8_dynamic_matmul(_t(x, dt), _t(wq), _t(ws))
        want = JQ.int8_dynamic_matmul(jnp.asarray(x, jdt), jnp.asarray(wq),
                                      jnp.asarray(ws))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=tol * float(np.abs(want).max()),
                                   rtol=0)
    # per-row scales: a row's result does not depend on its batch mates
    row, loud = _t(x[0, :1]), _t(1000 * x[1, :1])
    alone = TQ.int8_dynamic_matmul(row, _t(wq), _t(ws))
    stacked = TQ.int8_dynamic_matmul(torch.cat([row, loud]), _t(wq),
                                     _t(ws))[:1]
    assert torch.equal(alone, stacked)


def test_quantize_kv_byte_equal():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 5, 4, 16)) * 3).astype(np.float32)
    x[0, 0, 1] = 0.0                               # absmax 0: scale 1e-8
    x[1, 2, 3, :4] = [127.0, -63.5, 0.5, 1.5]      # round-half-even ties
    x[1, 2, 3, 4:] = 0.0
    q, s = T.quantize_kv(_t(x))
    jq, js = J.quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        T.dequantize_kv(q, s, "float32").numpy(),
        np.asarray(J.dequantize_kv(jq, js, jnp.float32)))


# --------------------------------------------------------------------------
# dequant matmul
# --------------------------------------------------------------------------

def _dqmm_inputs(seed, lead, K, N):
    rng = np.random.RandomState(seed)
    x = rng.randn(*lead, K).astype(np.float32)
    wq = rng.randint(-127, 128, (K, N)).astype(np.int8)
    s = ((rng.rand(N).astype(np.float32) + 0.1) / 64)
    return x, wq, s


@pytest.mark.parametrize("lead,K,N", [((1,), 128, 256), ((3,), 128, 256),
                                      ((8,), 256, 128), ((2, 4), 64, 192)])
def test_dequant_matmul_plain_matches_jax_fp32(lead, K, N):
    x, wq, s = _dqmm_inputs(sum(lead) + K, lead, K, N)
    got = dqmm.dequant_matmul(_t(x), _t(wq), _t(s))
    want = jax_dqmm.dequant_matmul(jnp.asarray(x), jnp.asarray(wq),
                                   jnp.asarray(s))
    assert got.shape == (*lead, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=FP32_TOL * float(np.abs(want).max()),
                               rtol=0)


@pytest.mark.parametrize("M", [1, 3, 32])
def test_dequant_matmul_plain_matches_jax_bf16(M):
    x, wq, s = _dqmm_inputs(M, (M,), 128, 256)
    got = dqmm.dequant_matmul(_t(x, torch.bfloat16), _t(wq), _t(s))
    want = jax_dqmm.dequant_matmul(jnp.asarray(x, jnp.bfloat16),
                                   jnp.asarray(wq), jnp.asarray(s))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_RTOL,
                               atol=BF16_RTOL)


@pytest.mark.parametrize("M,K,N", [(8, 128, 256), (3, 128, 256)])
def test_dequant_matmul_plain_matches_interpret_kernel(M, K, N):
    """Against ``_dqmm_tpu`` in interpret mode (M padded to the sublane
    minimum, as the JAX wrapper does)."""
    x, wq, s = _dqmm_inputs(M + 7, (M,), K, N)
    Mp = -(-M // 8) * 8
    xp = np.concatenate([x, np.zeros((Mp - M, K), np.float32)])
    blocks = jax_dqmm._pick_blocks(Mp, K, N, 4)
    kern = jax_dqmm._dqmm_tpu(jnp.asarray(xp), jnp.asarray(wq),
                              jnp.asarray(s), *blocks, interpret=True)[:M]
    got = dqmm._ref_dequant_matmul(_t(x), _t(wq), _t(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(kern),
                               atol=FP32_TOL * float(np.abs(kern).max()),
                               rtol=0)


def test_dequant_matmul_on_cpu_runs_plain_and_counts_nothing():
    x, wq, s = _dqmm_inputs(5, (2, 3), 64, 128)
    before = dqmm.launches
    out = dqmm.dequant_matmul(_t(x), _t(wq), _t(s).reshape(1, -1))
    assert dqmm.launches == before
    assert torch.equal(out.reshape(6, 128), dqmm._ref_dequant_matmul(
        _t(x).reshape(6, 64), _t(wq), _t(s)))


def test_dequant_matmul_cuda_checks_refuse_by_name():
    """The checks the wrapper runs before a launch (they read only shapes
    and dtypes, so CPU tensors exercise them).  K off a multiple of 8 and
    N off one of 16 pass (the wrapper pads them); a padded weight whose
    shape is not the padded form of x's K and ``n`` is refused."""
    x = torch.zeros(4, 64)
    s = torch.ones(128)
    with pytest.raises(TypeError, match="int8 weights only"):
        dqmm._check_cuda(x, torch.zeros(64, 128), s)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dqmm._check_cuda(x.half(), torch.zeros(64, 128, dtype=torch.int8),
                         s)
    dqmm._check_cuda(torch.zeros(4, 60),
                     torch.zeros(60, 120, dtype=torch.int8), torch.ones(120))
    w, sp = dqmm.pad_weight(torch.zeros(60, 120, dtype=torch.int8),
                            torch.ones(120))
    dqmm._check_cuda(torch.zeros(4, 60), w, sp, n=120)
    with pytest.raises(ValueError, match="padded form"):
        dqmm._check_cuda(torch.zeros(4, 60), w, sp, n=100)
    with pytest.raises(ValueError, match="scale"):
        dqmm._check_cuda(x, torch.zeros(64, 128, dtype=torch.int8),
                         torch.ones(64))


@pytest.mark.parametrize("K,N", [(13, 10), (1030, 1000)])
def test_dequant_matmul_padded_then_plain_matches_jax(K, N):
    """Any K and N, as the reference takes them: the weight zero-padded to
    K a multiple of 8 and N of 16 (``pad_weight``), x's columns padded to
    K, the plain version on the padded operands and the output cut back
    to N, against the JAX ``dequant_matmul``."""
    x, wq, s = _dqmm_inputs(K + N, (5,), K, N)
    w, sp = dqmm.pad_weight(_t(wq), _t(s))
    assert w.shape == (-(-K // 8) * 8, -(-N // 16) * 16)
    assert sp.shape == (w.shape[1],) and dqmm.kernel_ready(w)
    assert not w[K:].any() and not w[:, N:].any() and not sp[N:].any()
    got = dqmm.dequant_matmul(_t(x), w, sp, n=N)
    want = jax_dqmm.dequant_matmul(jnp.asarray(x), jnp.asarray(wq),
                                   jnp.asarray(s))
    assert got.shape == (5, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=FP32_TOL * float(np.abs(want).max()),
                               rtol=0)
    # a weight the kernels take as it is comes back as it is
    ready = torch.ones(16, 32, dtype=torch.int8)
    assert dqmm.pad_weight(ready, torch.ones(32))[0] is ready


def test_prepare_params_pads_an_off_multiple_quantized_weight_once():
    """A width off the kernels' multiples (H = 36: qkv N = 108, fc1 K =
    36 rows of N = 144) gets its padded form once in ``prepare_params``;
    the quantized block through it equals the reference's."""
    cfg_j = _cfg(J, hidden_size=36, num_heads=2)
    tree = numpy_params(cfg_j, 5)
    tp = T.quantize_params(T.params_from_numpy(tree, "cpu"), "int8")
    cfg_t = _cfg(T, hidden_size=36, num_heads=2)
    p = T.prepare_params(tp, cfg_t)
    leaf = p["blocks"]["qkv_w"]
    assert leaf["qw_k"].shape == (2, 40, 112)
    assert leaf["scale_k"].shape == (2, 112)
    assert T.prepare_params(p, cfg_t)["blocks"]["qkv_w"]["qw_k"] is \
        leaf["qw_k"]                                   # padded once
    x = np.random.default_rng(6).standard_normal((2, 3, 36)).astype(
        np.float32)
    jq = J.quantize_params(jax.tree_util.tree_map(jnp.asarray, tree), "int8")
    jblk = jax.tree_util.tree_map(lambda a: a[1], jq["blocks"])
    want = J.block_apply(cfg_j, jnp.asarray(x), jblk)
    got = T.block_apply(cfg_t, _t(x), T.layer(p, 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_TOL,
                               rtol=0)


def test_dequant_matmul_rows_take_strided_views_without_a_copy():
    base = torch.zeros(6, 96)
    view = base[:, 16:80]                      # rows 96 apart, K = 64
    x2, lda = dqmm._rows(view, 64)
    assert lda == 96 and x2.data_ptr() == view.data_ptr()
    odd = torch.zeros(6, 70)[:, 3:67]          # misaligned rows: a copy
    x2, lda = dqmm._rows(odd, 64)
    assert lda == 64 and x2.is_contiguous() and torch.equal(x2, odd)


@pytest.mark.parametrize("M,N,K", [(8, 1024, 1024), (8, 4096, 1024),
                                   (4096, 4096, 1024), (3, 256, 128)])
def test_dequant_matmul_split_covers_k(M, N, K):
    """Every split gets at least one k step, and the splits cover K."""
    for bk in (16, 32):
        tpb, ksplit = dqmm._split(M, N, K, bk, 4 * 132)
        steps = -(-K // bk)
        assert (ksplit - 1) * tpb < steps <= ksplit * tpb


@pytest.mark.parametrize("M", [1, 3, 8, 9, 16])
@pytest.mark.parametrize("K,N", [(1024, 3072), (1024, 1024), (1024, 4096),
                                 (4096, 1024), (128, 256), (120, 256),
                                 (8, 16), (2048, 64), (8192, 1024)])
def test_dequant_matmul_stream_plan_covers_k_once(M, K, N):
    """dqmm_stream's plan: a cluster of at most 8 blocks, kb a multiple of
    the 64-row box and at most 16 of them, every block some rows below K,
    shared memory within the card's per-block limit, and every k16 step
    below K taken by exactly one (block, warp), the eight warps of a block
    sharing its steps evenly; the blocks' partials meet in rank order
    (ranks 0..cs-1)."""
    regime, cs, kb = dqmm._plan(M, N, K, 132)
    assert regime == "stream"
    assert 1 <= cs <= dqmm._ST_MAX_CS and kb % dqmm._ST_ROWS == 0
    assert kb <= dqmm._ST_SLOTS * dqmm._ST_ROWS
    assert (cs - 1) * kb < K <= cs * kb
    assert dqmm._stream_smem(M, kb, cs) <= dqmm._SMEM
    steps = dqmm._stream_steps(K, cs, kb)
    below = [(r, k0) for r, _, k0 in steps if k0 < K]
    assert sorted(k0 for _, k0 in below) == list(range(0, K, 16))
    assert sorted({r for r, _ in below}) == list(range(cs))
    for r in range(cs):
        per = [sum(1 for rr, w, _ in steps if (rr, w) == (r, q))
               for q in range(8)]
        assert max(per) - min(per) <= 1


@pytest.mark.parametrize("M,K,N,want", [
    (8, 1024, 4096, "stream"), (16, 1024, 4096, "stream"),
    (17, 1024, 4096, "wg128"), (64, 1024, 4096, "wg128"),
    (65, 1024, 4096, "wg128"), (767, 1024, 4096, "wg128"),
    (768, 1024, 4096, "wg256"), (1000, 1024, 4096, "wg256"),
    (4096, 4096, 1024, "wg256"), (1, 1024, 1024, "stream"),
    # more than 16 boxes a block even at 8 blocks a cluster
    (8, 16384, 1024, "wg128"), (16, 8192, 1024, "stream")])
def test_dequant_matmul_plan_picks_the_regime_from_m(M, K, N, want):
    assert dqmm._plan(M, N, K, 132)[0] == want


# --------------------------------------------------------------------------
# int8 paged attention
# --------------------------------------------------------------------------

def _quant_paged_inputs(seed, S, nh, hd, P, ps, maxP, lens=None):
    """The JAX kernel tests' draw: int8 codes, scales (rand + 0.05) / 64,
    random tables (entries past a lane's fill are garbage)."""
    rng = np.random.RandomState(seed)
    q = rng.randn(S, 1, nh, hd).astype(np.float32)
    kq = rng.randint(-127, 128, (P, ps, nh, hd)).astype(np.int8)
    vq = rng.randint(-127, 128, (P, ps, nh, hd)).astype(np.int8)
    ks = (rng.rand(P, ps, nh).astype(np.float32) + 0.05) / 64
    vs = (rng.rand(P, ps, nh).astype(np.float32) + 0.05) / 64
    pt = rng.randint(0, P, (S, maxP)).astype(np.int32)
    if lens is None:
        lens = rng.randint(0, maxP * ps, (S,))
    return q, kq, ks, vq, vs, pt, np.asarray(lens, np.int32)


QUANT_PAGED_SHAPES = [(4, 4, 16, 12, 8, 4), (2, 2, 64, 6, 16, 2),
                      (3, 4, 32, 16, 8, 6)]


@pytest.mark.parametrize("shape", QUANT_PAGED_SHAPES)
def test_paged_attention_quant_plain_matches_jax_fp32(shape):
    args = _quant_paged_inputs(sum(shape), *shape)
    got = paged_attn.paged_attention_quant(*[_t(a) for a in args])
    ja = [jnp.asarray(a) for a in args]
    want = jax_paged.paged_attention_quant(*ja)
    kern = jax_paged._paged_attention_quant_tpu(*ja, interpret=True)
    assert got.shape == (shape[0], 1, shape[1], shape[2])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_TOL,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=FP32_TOL,
                               rtol=0)


def test_paged_attention_quant_len_zero_lane_attends_position_zero():
    args = _quant_paged_inputs(7, 2, 2, 16, 5, 8, 3, lens=[0, 13])
    q, kq, ks, vq, vs, pt, lens = args
    got = paged_attn._ref_paged_attention_quant(*[_t(a) for a in args])
    ja = [jnp.asarray(a) for a in args]
    kern = jax_paged._paged_attention_quant_tpu(*ja, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=FP32_TOL,
                               rtol=0)
    # lane 0 sees position 0 alone: its output is that position's V
    v0 = vq[pt[0, 0], 0].astype(np.float32) * vs[pt[0, 0], 0][:, None]
    np.testing.assert_allclose(got[0, 0].numpy(), v0, atol=FP32_TOL,
                               rtol=0)


def test_paged_attention_quant_plain_matches_jax_bf16():
    """The compute-dtype casts around p.V (V and p cast to bf16) mirror
    the reference's; a float32 test could not see a missing cast."""
    args = _quant_paged_inputs(9, 3, 2, 32, 8, 8, 3)
    q = args[0]
    rest = args[1:]
    got = paged_attn.paged_attention_quant(_t(q, torch.bfloat16),
                                           *[_t(a) for a in rest])
    want = jax_paged.paged_attention_quant(jnp.asarray(q, jnp.bfloat16),
                                           *[jnp.asarray(a) for a in rest])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_RTOL,
                               atol=BF16_RTOL)


def test_paged_attention_quant_on_cpu_counts_nothing_and_checks_by_name():
    args = [_t(a) for a in _quant_paged_inputs(3, *QUANT_PAGED_SHAPES[0])]
    before = (paged_attn.launches, paged_attn.quant_launches)
    paged_attn.paged_attention_quant(*args)
    assert (paged_attn.launches, paged_attn.quant_launches) == before
    q, kq, ks, vq, vs, pt, lens = args
    with pytest.raises(TypeError, match="int8"):
        paged_attn._check_cuda_quant(q, kq.float(), ks, vq, vs, pt, lens)
    # any hd runs: up to 512 the kernel masks the ragged lanes, wider
    # heads (528: two head-width groups of 512) run the WIDE instances
    paged_attn._check_cuda_quant(torch.zeros(4, 1, 4, 24),
                                 torch.zeros(12, 8, 4, 24, dtype=torch.int8),
                                 ks, torch.zeros(12, 8, 4, 24,
                                                 dtype=torch.int8),
                                 vs, pt, lens)
    q528 = torch.zeros(4, 1, 4, 528)
    k528 = torch.zeros(12, 8, 4, 528, dtype=torch.int8)
    paged_attn._check_cuda_quant(q528, k528, ks, k528, vs, pt, lens)
    assert paged_attn._head_groups(528, 16) == (2, 512)
    with pytest.raises(ValueError, match="scales"):
        paged_attn._check_cuda_quant(q, kq, ks[:, :4].contiguous(), vq,
                                     vs, pt, lens)


# --------------------------------------------------------------------------
# model: quantized block, decode step and forward
# --------------------------------------------------------------------------

def _wide(mod):
    return _cfg(mod, hidden_size=128, num_heads=2)       # hd 64


@pytest.fixture(scope="module")
def wide():
    jcfg, tcfg = _wide(J), _wide(T)
    tree = numpy_params(jcfg, 3)
    jq = J.quantize_params(jax.tree_util.tree_map(jnp.asarray, tree))
    tq = T.quantize_params(T.params_from_numpy(tree, "cpu"))
    return jcfg, jq, tcfg, tq


def test_block_apply_with_quantized_weights_matches_jax(wide):
    jcfg, jq, tcfg, tq = wide
    x = np.random.default_rng(4).standard_normal((2, 5, 128)).astype(
        np.float32)
    jblk = jax.tree_util.tree_map(lambda a: a[1], jq["blocks"])
    want = J.block_apply(jcfg, jnp.asarray(x), jblk)
    got = T.block_apply(tcfg, _t(x), T.layer(tq, 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_TOL,
                               rtol=0)


def test_forward_with_quantized_weights_matches_jax(wide):
    jcfg, jq, tcfg, tq = wide
    toks = np.random.default_rng(5).integers(0, 256, (2, 9))
    want = J.forward(jq, jnp.asarray(toks), jcfg)
    got = T.forward(tq, _t(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_TOL,
                               rtol=0)


def _assert_codes_close(got, want):
    """int8 codes equal but for a move of one, in at most 0.1% of them."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1
    assert (d > 0).mean() <= CODE_FLIP_SHARE


def test_decode_step_paged_quant_matches_jax(wide):
    jcfg, jq, tcfg, tq = wide
    rng = np.random.default_rng(6)
    L, P, ps, nh, hd = 2, 7, 8, 2, 64
    k0, ks0 = J.quantize_kv(jnp.asarray(
        rng.standard_normal((L, P, ps, nh, hd)).astype(np.float32)))
    v0, vs0 = J.quantize_kv(jnp.asarray(
        rng.standard_normal((L, P, ps, nh, hd)).astype(np.float32)))
    pools = [np.asarray(a) for a in (k0, ks0, v0, vs0)]
    table = np.array([[1, 2, 0], [3, 4, 5], [0, 0, 0]], np.int32)
    lens = np.array([9, 17, 0], np.int32)
    wp = np.array([2, 5, 0], np.int32)
    wo = lens % ps
    toks = np.array([3, 77, 0], np.int32)
    jl, *jpools = J.decode_step_paged_quant(
        jq, jnp.asarray(toks), jcfg, *[jnp.asarray(a) for a in pools],
        jnp.asarray(table), jnp.asarray(wp), jnp.asarray(wo),
        jnp.asarray(lens))
    tpools = [_t(a.copy()) for a in pools]
    tl, *tout = T.decode_step_paged_quant(
        tq, _t(toks), tcfg, *tpools, _t(table), _t(wp), _t(wo), _t(lens))
    assert all(a is b for a, b in zip(tout, tpools))       # in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=FP32_TOL,
                               rtol=0)
    for got, want in zip(tout, jpools):
        if got.dtype == torch.int8:
            _assert_codes_close(got.numpy(), np.asarray(want))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=0)


def test_quantized_block_routes_through_the_wrapper(wide, monkeypatch):
    _, _, tcfg, tq = wide
    calls = []
    real = T.dequant_matmul

    def spy(x, w, s):
        calls.append(tuple(w.shape))
        return real(x, w, s)
    monkeypatch.setattr(T, "dequant_matmul", spy)
    T.forward(tq, torch.tensor([[1, 2, 3]]), tcfg)
    H, Fw = 128, 512
    assert calls == [(H, 3 * H), (H, H), (H, Fw), (Fw, H)] * 2


def test_prepare_params_keeps_quantized_leaves_and_casts_biases(wide):
    _, _, tcfg, tq = wide
    cfg = _cfg(T, hidden_size=128, num_heads=2, dtype="bfloat16")
    p = T.prepare_params(tq, cfg)
    for name in QLEAVES:
        assert p["blocks"][name] is tq["blocks"][name]
    assert p["blocks"]["fc1_b"].dtype == torch.bfloat16
    assert p["wte_cd"].dtype == torch.bfloat16
    lay = T.layer(p, 1)
    assert lay["qkv_w"]["qw"].shape == (128, 3, 128)
    assert lay["qkv_w"]["scale"].shape == (1, 3, 128)


# --------------------------------------------------------------------------
# engine
# --------------------------------------------------------------------------

def _kw(**kw):
    kw.setdefault("slots", 3)
    kw.setdefault("max_len", 32)
    kw.setdefault("page_size", 8)
    kw.setdefault("seq_buckets", (8, 16))
    kw.setdefault("batch_buckets", (1, 2))
    return kw


def _engines(model, **kw):
    """The JAX engine and the port's engine (CPU) on the same weights and
    knobs, both warmed up."""
    jcfg, jp, tcfg, tree = model
    kw = _kw(**kw)
    je = JS.PagedServingEngine((jp, jcfg), **kw)
    te = S.PagedServingEngine((T.params_from_numpy(tree, "cpu"), tcfg),
                              device="cpu", **kw)
    je.warmup()
    te.warmup()
    return je, te


def _pool(eng):
    names = ("_cache_k", "_cache_ks", "_cache_v", "_cache_vs") \
        if getattr(eng, "_kv_quant", False) else ("_cache_k", "_cache_v")
    return [np.asarray(getattr(eng, n)) for n in names]


def _assert_engines_agree(je, te, jreqs, treqs):
    for a, b in zip(jreqs, treqs):
        assert a.done and b.done
        assert a.tokens == b.tokens, (a.tokens, b.tokens)
        if a.logits is not None:
            err = max(float(np.abs(x - y).max())
                      for x, y in zip(a.logits, b.logits))
            assert err <= ENGINE_LOGIT_TOL, err
    for got, want in zip(_pool(te), _pool(je)):
        if got.dtype == np.int8:
            _assert_codes_close(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    js, ts = je.stats(), te.stats()
    for k in ("quant_matmuls", "kv_quant_bytes_saved", "kv_bytes_total",
              "prefix_page_hits", "prefix_page_misses", "cow_copies",
              "preemptions", "decode_steps", "prefill_calls", "quant",
              "kv_dtype", "pages_in_use"):
        assert ts[k] == js[k], (k, ts[k], js[k])


def test_engine_churn_matches_jax(model):
    je, te = _engines(model, slots=2, quant="int8", kv_dtype="int8",
                      capture_logits=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 256, (5 if i % 2 else 11,)).astype(np.int32)
               for i in range(6)]
    jr = [je.submit(p, 6) for p in prompts]
    tr = [te.submit(p, 6) for p in prompts]
    je.run()
    te.run()
    _assert_engines_agree(je, te, jr, tr)
    st, js = te.stats(), je.stats()
    assert st["slot_occupancy_peak"] == 2
    assert st["quant_matmuls"] == 4 * 2 * (st["decode_steps"]
                                           + st["prefill_calls"])
    assert st["kv_quant_bytes_saved"] > 0
    assert st["dequant_kernel_calls"] == 0          # CPU: plain versions
    assert st["pages_in_use"] == 0
    assert st["decode_compiles"] == js["decode_compiles"] == 1


def test_engine_prefix_hit_and_cow_match_jax(model):
    je, te = _engines(model, page_size=4, quant="int8", kv_dtype="int8")
    prompt = np.arange(1, 11, dtype=np.int32)      # 10 tokens: 3 pages
    first = [e.submit(prompt, 4) for e in (je, te)]
    je.run()
    te.run()
    s1 = te.stats()
    # a prefix hit allocates no new pages; then two in flight on one
    # prefix copy the shared tail page (codes and scale rows) on write
    jr = [je.submit(prompt, 4), je.submit(prompt, 6), je.submit(prompt, 6)]
    tr = [te.submit(prompt, 4), te.submit(prompt, 6), te.submit(prompt, 6)]
    je.run()
    te.run()
    s2 = te.stats()
    assert s2["prefix_page_hits"] - s1["prefix_page_hits"] >= 3
    assert s2["cow_copies"] >= 1
    assert s2["decode_compiles"] == 1
    assert tr[0].tokens == first[1].tokens == first[0].tokens
    assert tr[1].tokens == tr[2].tokens
    _assert_engines_agree(je, te, [first[0]] + jr, [first[1]] + tr)


def test_engine_preemption_retry_matches_jax(model):
    je, te = _engines(model, slots=2, page_size=4, num_pages=9,
                      seq_buckets=(16,), batch_buckets=(1,),
                      prefix_cache=False, quant="int8", kv_dtype="int8")
    prompts = [np.arange(1, 13, dtype=np.int32),
               np.arange(3, 15, dtype=np.int32)]
    jr = [je.submit(p, 16) for p in prompts]
    tr = [te.submit(p, 16) for p in prompts]
    je.run(max_steps=400)
    te.run(max_steps=400)
    assert te.stats()["preemptions"] >= 1
    assert te.stats()["decode_compiles"] == 1
    _assert_engines_agree(je, te, jr, tr)


@pytest.mark.parametrize("knobs", [
    {"quant": "int8"}, {"kv_dtype": "int8"}, {"quant": "int8_dynamic"},
    {"quant": "fp8", "kv_dtype": "int8"}])
def test_each_knob_alone_matches_jax(model, knobs):
    je, te = _engines(model, capture_logits=True, **knobs)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 256, (n,)).astype(np.int32) for n in (4, 13)]
    jr = [je.submit(p, 5) for p in prompts]
    tr = [te.submit(p, 5) for p in prompts]
    je.run()
    te.run()
    _assert_engines_agree(je, te, jr, tr)
    st = te.stats()
    assert (st["quant_matmuls"] > 0) == ("quant" in knobs)
    assert (st["kv_quant_bytes_saved"] > 0) == ("kv_dtype" in knobs)
    assert te._pager.hash_key == je._pager.hash_key == (
        f"quant={knobs.get('quant', 'none')}/kv="
        f"{'int8' if 'kv_dtype' in knobs else 'fp'}")


@pytest.mark.parametrize("quant", ["int8", "int8_dynamic"])
def test_quantized_engine_within_budget_of_fp32_engine(model, quant):
    _, _, tcfg, tree = model
    kw = _kw(capture_logits=True)
    fp = S.PagedServingEngine((T.params_from_numpy(tree, "cpu"), tcfg),
                              device="cpu", **kw)
    q = S.PagedServingEngine((T.params_from_numpy(tree, "cpu"), tcfg),
                             device="cpu", quant=quant, kv_dtype="int8",
                             **kw)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 256, (n,)).astype(np.int32)
               for n in (3, 7, 12, 16, 5)]
    rf = [fp.submit(p, 6) for p in prompts]
    rq = [q.submit(p, 6) for p in prompts]
    fp.run()
    q.run()
    err = 0.0
    for a, b in zip(rf, rq):
        assert a.tokens == b.tokens
        err = max(err, max(float(np.abs(x - y).max())
                           for x, y in zip(a.logits, b.logits)))
    assert 0 < err <= LOGIT_BUDGET, err


def test_failed_step_rebuilds_the_int8_pool_and_its_scales(model,
                                                           monkeypatch):
    _, _, tcfg, tree = model
    eng = S.PagedServingEngine((T.params_from_numpy(tree, "cpu"), tcfg),
                               device="cpu", quant="int8", kv_dtype="int8",
                               **_kw())
    eng.warmup()
    saved = eng.stats()["kv_quant_bytes_saved"]
    prompt = np.arange(5, 12, dtype=np.int32)
    clean = eng.submit(prompt, 5)
    eng.run()
    req = eng.submit(prompt, 5)
    real = eng._decode
    calls = {"n": 0}

    def flaky(*a):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected decode failure")
        return real(*a)
    monkeypatch.setattr(eng, "_decode", flaky)
    pools = eng._cache_operands()
    ptrs = [t.data_ptr() for t in pools]
    assert any(bool(t.any()) for t in pools)
    with pytest.raises(RuntimeError, match="injected"):
        eng.run()
    assert eng.take_aborted() == [req]
    # zeroed in place: the decode step keeps reading and writing the same
    # storage
    assert [t.data_ptr() for t in eng._cache_operands()] == ptrs
    assert all(a is b for a, b in zip(eng._cache_operands(), pools))
    assert not eng._cache_ks.any() and not eng._cache_k.any()
    assert eng._cache_vs.dtype == torch.float32 and not eng._cache_vs.any()
    assert eng.stats()["kv_quant_bytes_saved"] == saved   # counted once
    eng.submit(req.reset_for_retry())
    eng.run()
    assert req.tokens == clean.tokens
    assert eng.stats()["decode_compiles"] == 1


def test_kv_accounting_counts_codes_and_scales(model):
    _, _, tcfg, tree = model
    eng = S.PagedServingEngine((T.params_from_numpy(tree, "cpu"), tcfg),
                               device="cpu", kv_dtype="int8", **_kw())
    st = eng.stats()
    L, P, ps, nh, hd = 2, eng._num_pages, 8, 2, 16
    codes, scales = 2 * L * P * ps * nh * hd, 2 * L * P * ps * nh * 4
    assert st["kv_bytes_total"] == codes + scales
    assert st["kv_quant_bytes_saved"] == 4 * codes - (codes + scales)
    assert st["kv_dtype"] == "int8" and st["quant"] is None


def test_engine_keeps_no_float_copy_of_quantized_weights(model):
    _, _, tcfg, tree = model
    eng = S.PagedServingEngine((T.params_from_numpy(tree, "cpu"), tcfg),
                               device="cpu", quant="int8", **_kw())
    for name in QLEAVES:
        leaf = eng.params["blocks"][name]
        assert leaf["qw"].dtype == torch.int8
        assert leaf["scale"].dtype == torch.float32
    assert eng.stats()["quant"] == "int8"


def test_npz_of_a_jax_quantized_tree_serves_like_port_quantization(
        model, tmp_path):
    _, jp, tcfg, tree = model
    path = J.save_params_npz(str(tmp_path / "q.npz"),
                             J.quantize_params(jp, "int8"))
    loaded = T.load_params_npz(path, "cpu")
    assert loaded["blocks"]["fc2_w"]["qw"].dtype == torch.int8
    assert loaded["blocks"]["fc2_w"]["scale"].dtype == torch.float32
    bf = T.params_from_numpy({"blocks": {"w": {
        "qw": np.ones((2, 2), np.int8), "scale": np.ones((2,), np.float32)},
        "b": np.ones(2, np.float32)}}, "cpu", dtype="bfloat16")
    assert bf["blocks"]["w"]["scale"].dtype == torch.float32
    assert bf["blocks"]["b"].dtype == torch.bfloat16
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, 256, (n,)).astype(np.int32) for n in (6, 11)]
    outs = []
    for params in (loaded, T.params_from_numpy(tree, "cpu")):
        eng = S.PagedServingEngine((params, tcfg), device="cpu",
                                   quant="int8", kv_dtype="int8", **_kw())
        outs.append(eng.generate(prompts, 6))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("kw,exc,match", [
    ({"quant": "int4"}, ValueError, "unknown quant mode"),
    ({"kv_dtype": "fp8"}, ValueError, "kv_dtype"),
    ({"kv_dtype": "int8", "cache_dtype": "float32"}, ValueError,
     "mutually exclusive"),
])
def test_quant_refusals_by_name(model, kw, exc, match):
    _, _, tcfg, tree = model
    with pytest.raises(exc, match=match):
        S.PagedServingEngine((T.params_from_numpy(tree, "cpu"), tcfg),
                             device="cpu", **_kw(**kw))


def test_quantize_params_refusals_by_name(model):
    _, _, tcfg, tree = model
    p = T.params_from_numpy(tree, "cpu")
    q8 = T.quantize_params(p, "int8")
    for mode in ("fp8", "int8_dynamic"):
        with pytest.raises(ValueError, match="quantized for 'int8'"):
            T.quantize_params(q8, mode)
    with pytest.raises(ValueError, match="cannot serve quant='fp8'"):
        S.PagedServingEngine((q8, tcfg), device="cpu", quant="fp8", **_kw())
    with pytest.raises(ValueError, match="unknown quant mode"):
        T.quantize_params(p, "int2")
    moe = dict(p)
    moe["blocks"] = dict(p["blocks"], moe_w1=torch.zeros(1))
    with pytest.raises(ValueError, match="MoE"):
        T.quantize_params(moe, "int8")


def test_quantized_ffn_bypasses_the_unported_fused_ffn(wide, monkeypatch):
    """``use_fused_ffn`` with quantized FFN weights runs the dequant
    matmuls, as the reference does, and never the fused FFN; with float
    weights it takes the fused FFN, whose CPU path is the plain FFN."""
    _, _, tcfg, tq = wide
    cfg = _cfg(T, hidden_size=128, num_heads=2, use_fused_ffn=True)
    x = torch.randn(1, 3, 128)
    calls = []
    real = T.fused_ffn
    monkeypatch.setattr(T, "fused_ffn",
                        lambda *a: calls.append(1) or real(*a))
    torch.testing.assert_close(T.block_apply(cfg, x, T.layer(tq, 0)),
                               T.block_apply(tcfg, x, T.layer(tq, 0)),
                               rtol=0, atol=0)
    assert not calls
    flt = T.layer(T.params_from_numpy(numpy_params(tcfg, 1), "cpu"), 0)
    torch.testing.assert_close(T.block_apply(cfg, x, flt),
                               T.block_apply(tcfg, x, flt), rtol=0, atol=0)
    assert len(calls) == 1


def test_norm_launches_unchanged_on_cpu_quant_path(model):
    """CPU tensors: the LayerNorm and quantized-path wrappers all take
    their plain versions."""
    _, _, tcfg, tree = model
    eng = S.PagedServingEngine((T.params_from_numpy(tree, "cpu"), tcfg),
                               device="cpu", quant="int8", kv_dtype="int8",
                               **_kw())
    before = (norms.launches, dqmm.launches, paged_attn.quant_launches)
    eng.generate([np.arange(1, 6, dtype=np.int32)], 3)
    assert (norms.launches, dqmm.launches,
            paged_attn.quant_launches) == before
