"""The row product with its LayerNorm prologue (``paddle_tpu_torch/ops/
cuda/row_matmul.py`` ``ln_matmul``) on the CPU, and its routing in
``models.gpt.block_apply``.

The kernels run only on a card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` (c)); here the parts that decide what they compute:

* the CPU path is the plain LayerNorm (``norms._ref_layer_norm``) then
  ``x @ w`` bit for bit, in float32 and bfloat16, with g and b in float32
  and bfloat16, and launches nothing; in float32 it is within 1e-5 of
  max|ref| of the reference's ``layer_norm`` (Pallas in interpret mode,
  as ``tests/test_pallas_kernels.py`` runs it, where the shape tiles; its
  plain formula where not) followed by the reference's einsum;
* the order of each row's moment sums (``_ln_order``, K's alone) and
  the fused launch's route and plan never read M;
* ``block_apply`` takes the fused op exactly for ln1 -> qkv and ln2 ->
  fc1 of the paged decode and the fp verify with ``use_pallas_norm``,
  and not for int8 weights, the fused FFN, lnf, prefill or the plain
  LayerNorm (counting monkeypatches);
* the refusals, by name, on every device.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from paddle_tpu.ops.pallas import norms as jax_norms
from paddle_tpu_torch.models import gpt as T
from paddle_tpu_torch.ops.cuda import row_matmul
from paddle_tpu_torch.ops.cuda.norms import _ref_layer_norm
from test_torch_gpt import numpy_params

FP32_TOL = 1e-5
EPS = 1e-5
DTYPES = (torch.float32, torch.bfloat16)
PROPS = settings(max_examples=200, deadline=None, derandomize=True,
                 database=None)


def _operands(lead, K, N, dt, gdt, seed):
    rng = np.random.default_rng(seed)
    xn = (rng.standard_normal((*lead, K)) * 2 + 0.5).astype(np.float32)
    gn = (1 + 0.1 * rng.standard_normal(K)).astype(np.float32)
    bn = (0.1 * rng.standard_normal(K)).astype(np.float32)
    wn = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    x, w = torch.from_numpy(xn).to(dt), torch.from_numpy(wn).to(dt)
    g, b = torch.from_numpy(gn).to(gdt), torch.from_numpy(bn).to(gdt)
    return (xn, gn, bn, wn), (x, g, b, w)


@pytest.mark.parametrize("gdt", DTYPES)
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("lead,K,N", [((8,), 128, 96), ((8, 5), 64, 192),
                                      ((3, 1), 96, 40), ((2,), 13, 10)])
def test_cpu_path_is_plain_layer_norm_then_matmul(lead, K, N, dt, gdt):
    """Bit for bit ``_ref_layer_norm(x, g, b, eps) @ w``, x's dtype and
    [..., N] shape out, no launch counted."""
    _, (x, g, b, w) = _operands(lead, K, N, dt, gdt, K * N + len(lead))
    before = (row_matmul.launches, row_matmul.ln_launches)
    got = row_matmul.ln_matmul(x, g, b, EPS, w)
    assert (row_matmul.launches, row_matmul.ln_launches) == before
    assert got.dtype == dt and got.shape == (*lead, N)
    assert torch.equal(got, _ref_layer_norm(x, g, b, EPS) @ w)
    assert torch.equal(got, row_matmul._ref_ln_matmul(x, g, b, EPS, w))


@pytest.mark.parametrize("lead,K,N", [((8,), 256, 96), ((5,), 128, 64),
                                      ((8, 5), 128, 384), ((2,), 13, 10)])
def test_fp32_matches_reference_layer_norm_and_einsum(lead, K, N):
    """In float32 within 1e-5 of max|ref| of the reference's
    ``layer_norm`` (interpret mode) then ``jnp.einsum``."""
    (xn, gn, bn, wn), (x, g, b, w) = _operands(lead, K, N, torch.float32,
                                               torch.float32, K + N)
    h = jax_norms.layer_norm(jnp.asarray(xn), jnp.asarray(gn),
                             jnp.asarray(bn), EPS, True)
    ref = np.asarray(jnp.einsum("...k,kn->...n", h, jnp.asarray(wn)))
    got = row_matmul.ln_matmul(x, g, b, EPS, w).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=FP32_TOL * np.abs(ref).max())


def test_order_functions_take_no_row_count():
    for fn in (row_matmul._ln_order, row_matmul._ln_route,
               row_matmul._tc_ln_bytes, row_matmul._plan):
        assert "M" not in inspect.signature(fn).parameters, fn.__name__


@PROPS
@given(K=st.integers(0, 9000))
def test_ln_order_covers_each_k_once_in_a_fixed_order(K):
    """Each lane's 8-element groups in k order (group j on lane j % 32);
    together every k once; the same listing every time."""
    order = row_matmul._ln_order(K)
    ks = [k for _, k0, k1 in order for k in range(k0, k1)]
    assert sorted(ks) == list(range(K)) and len(ks) == K
    for lane, k0, k1 in order:
        assert k0 % 8 == 0 and (k0 // 8) % 32 == lane and 0 < k1 - k0 <= 8
    lanes = [lane for lane, _, _ in order]
    assert lanes == sorted(lanes)
    for lane in set(lanes):
        starts = [k0 for ln, k0, _ in order if ln == lane]
        assert starts == sorted(starts)
    assert order == row_matmul._ln_order(K)


@PROPS
@given(m1=st.integers(1, 400), m2=st.integers(1, 400),
       K=st.integers(1, 9000), N=st.integers(1, 6000),
       dt=st.sampled_from(DTYPES), w_offset=st.integers(0, 7))
def test_fused_route_and_plan_never_read_m(m1, m2, K, N, dt, w_offset):
    """Two row counts on one W give the fused launch one route and the
    same integers but M (and the moments' order is K's alone); the
    tensor route only where a block's rows fit whole in shared memory."""
    x = torch.zeros((1, 1), dtype=dt).expand(max(m1, m2), K)
    w = torch.zeros(8, dtype=dt)[w_offset:w_offset + 1].reshape(
        1, 1).expand(K, N)
    (r1, a1), (r2, a2) = (row_matmul._args(x[:m], w, ln=True)
                          for m in (m1, m2))
    assert r1 == r2 and a1[1:] == a2[1:] and (a1[0], a2[0]) == (m1, m2)
    if r1 == "tensor":
        assert row_matmul._args(x[:m1], w)[0] == "tensor"
        assert row_matmul._tc_ln_bytes(K, N) <= row_matmul._TC_SMEM


@pytest.mark.parametrize("K,N,want", [
    (1024, 3072, "tensor"), (1024, 4096, "tensor"),      # gpt_345m
    (1032, 1000, "tensor"), (1152, 3456, "tensor"),
    (1216, 3648, "cuda_core"), (2048, 6144, "cuda_core"),  # rows too wide
    (1030, 1001, "cuda_core")])                           # TMA cannot
def test_fused_route_keeps_the_tensor_cores_where_rows_fit(K, N, want):
    x = torch.zeros((1, 1), dtype=torch.bfloat16).expand(8, K)
    w = torch.zeros((1, 1), dtype=torch.bfloat16).expand(K, N)
    assert row_matmul._args(x, w, ln=True)[0] == want


# --------------------------------------------------------------------------
# routing in block_apply
# --------------------------------------------------------------------------

L = 2


def _cfg(**kw):
    return T.GPTConfig(vocab_size=256, hidden_size=32, num_layers=L,
                       num_heads=2, max_seq_len=64, dtype="float32",
                       use_flash=False, remat=False, **kw)


@pytest.fixture(scope="module")
def tree():
    return numpy_params(_cfg(), 0)


def _decode_inputs(seed):
    rng = np.random.default_rng(seed)
    pool = [torch.from_numpy(rng.standard_normal((L, 12, 8, 2, 16))
                             .astype(np.float32)) for _ in range(2)]
    table = torch.tensor([[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 9]],
                         dtype=torch.int32)
    lens = torch.tensor([20, 9, 12], dtype=torch.int32)
    toks = torch.from_numpy(rng.integers(0, 256, (3, 4)).astype(np.int32))
    return pool, table, lens, toks


def _counted(monkeypatch):
    """Count ``row_matmul.ln_matmul`` calls (by the weight's width) and
    the LayerNorm wrapper's calls that ``block_apply`` and ``_head``
    make."""
    calls = {"ln_matmul": [], "layer_norm": 0}
    fused, ln = row_matmul.ln_matmul, T._kernel_layer_norm

    def count_fused(x, g, b, eps, w):
        calls["ln_matmul"].append(w.shape[1])
        return fused(x, g, b, eps, w)

    def count_ln(*a):
        calls["layer_norm"] += 1
        return ln(*a)
    monkeypatch.setattr(row_matmul, "ln_matmul", count_fused)
    monkeypatch.setattr(T, "_kernel_layer_norm", count_ln)
    return calls


def _run(cfg, params, path):
    """One call of ``path`` ("decode", "verify" or "prefill")."""
    (k, v), table, lens, toks = _decode_inputs(3)
    with torch.inference_mode():
        if path == "decode":
            wp = table[torch.arange(3), (lens // 8).long()]
            return T.decode_step_paged(params, toks[:, 0], cfg, k, v, table,
                                       wp, lens % 8, lens)[0]
        if path == "verify":
            return T.decode_step_paged_verify(params, toks, cfg, k, v, table,
                                              lens)[0]
        return T.forward(params, toks.long(), cfg)


H = 32
# (config, quantized, path) -> the fused calls (by N) and LayerNorm calls
ROUTES = [
    (dict(use_pallas_norm=True), False, "decode", [3 * H, 4 * H] * L, 1),
    (dict(use_pallas_norm=True), False, "verify", [3 * H, 4 * H] * L, 1),
    (dict(use_pallas_norm=True), False, "prefill", [], 2 * L + 1),
    (dict(use_pallas_norm=True), True, "decode", [], 2 * L + 1),
    (dict(use_pallas_norm=True, use_fused_ffn=True), False, "decode",
     [3 * H] * L, L + 1),
    (dict(use_pallas_norm=False), False, "decode", [], 0),
    (dict(use_pallas_norm=False), False, "verify", [], 0),
]


@pytest.mark.parametrize("kw,quant,path,fused,lns", ROUTES)
def test_block_apply_fuses_ln1_qkv_and_ln2_fc1_only(monkeypatch, tree, kw,
                                                    quant, path, fused, lns):
    """The fused op replaces ln1 -> qkv and ln2 -> fc1 on the paged decode
    and the fp verify with ``use_pallas_norm``; lnf, prefill, int8
    weights, the fused FFN's ln2 and the plain LayerNorm keep the
    LayerNorm wrapper or the plain formula."""
    cfg = _cfg(**kw)
    params = T.params_from_numpy(tree, "cpu")
    if quant:
        params = T.quantize_params(params, "int8")
    params = T.prepare_params(params, cfg)
    calls = _counted(monkeypatch)
    _run(cfg, params, path)
    assert calls["ln_matmul"] == fused
    assert calls["layer_norm"] == lns


@pytest.mark.parametrize("path", ["decode", "verify"])
def test_fused_route_is_the_two_launch_route_bit_for_bit(monkeypatch, tree,
                                                         path):
    """On the CPU the decode and the verify give the same logits bit for
    bit whether ln1 / ln2 go through the fused op or through the
    LayerNorm wrapper and ``row_matmul.matmul``."""
    cfg = _cfg(use_pallas_norm=True)
    params = T.prepare_params(T.params_from_numpy(tree, "cpu"), cfg)
    fused = _run(cfg, params, path)
    monkeypatch.setattr(row_matmul, "ln_matmul",
                        lambda x, g, b, eps, w: row_matmul.matmul(
                            T._kernel_layer_norm(x, g, b, eps), w))
    assert torch.equal(fused, _run(cfg, params, path))


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------

def _good(K=16, N=8):
    return (torch.zeros(3, K), torch.ones(K), torch.zeros(K),
            torch.zeros(K, N))


def _refusal(case):
    x, g, b, w = _good()
    if case == "grad x":
        x.requires_grad_()
    elif case == "grad w":
        w.requires_grad_()
    elif case == "w dtype":
        w = w.bfloat16()
    elif case == "x dtype":
        x = x.double()
    elif case == "g b dtypes":
        b = b.bfloat16()
    elif case == "g dtype":
        g, b = g.half(), b.half()
    elif case == "w device":
        w = w.to("meta")
    elif case == "g device":
        g = g.to("meta")
    elif case == "device":
        x, g, b, w = (t.to("meta") for t in (x, g, b, w))
    elif case == "k":
        w = torch.zeros(17, 8)
    elif case == "w rank":
        w = torch.zeros(16, 2, 4)
    elif case == "g shape":
        g = torch.ones(15)
    elif case == "b shape":
        b = torch.zeros(1, 16)
    return x, g, b, w


@pytest.mark.parametrize("case,exc,match", [
    ("grad x", RuntimeError, "forward only"),
    ("grad w", RuntimeError, "forward only"),
    ("w dtype", TypeError, "w torch.bfloat16"),
    ("x dtype", TypeError, "x torch.float64"),
    ("g b dtypes", TypeError, "b torch.bfloat16"),
    ("g dtype", TypeError, "g torch.float16"),
    ("w device", ValueError, "w on meta"),
    ("g device", ValueError, "g on meta"),
    ("device", ValueError, "unsupported device meta"),
    ("k", ValueError, "do not multiply"),
    ("w rank", ValueError, "do not multiply"),
    ("g shape", ValueError, "do not multiply"),
    ("b shape", ValueError, "do not multiply"),
])
def test_refusals_by_name(case, exc, match):
    with pytest.raises(exc, match=f"ln_matmul: .*{match}"):
        row_matmul.ln_matmul(*_refusal(case)[:3], EPS, _refusal(case)[3])


def test_gradient_allowed_under_no_grad():
    x, g, b, w = _good()
    x.requires_grad_()
    with torch.no_grad():
        assert row_matmul.ln_matmul(x, g, b, EPS, w).shape == (3, 8)
