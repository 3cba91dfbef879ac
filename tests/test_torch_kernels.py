"""paddle_tpu_torch kernels against the JAX package.

The same numpy-seeded inputs go through the JAX functions (the plain
reference and the Pallas kernel in interpret mode) and through the port's
plain PyTorch versions on the CPU.  Tolerances: 1e-5 absolute in float32
(only the order of fp32 sums differs); one bf16 rounding step (2**-7
relative) in bfloat16, where the two frameworks round at the same places
but may land on either side of a tie after reordered fp32 sums.

The CUDA kernels themselves are held against these plain versions on a
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import norms as jax_norms
from paddle_tpu.ops.pallas import paged_attn as jax_paged
from paddle_tpu_torch import device as port_device
from paddle_tpu_torch.ops.cuda import build, norms, paged_attn

FP32_TOL = 1e-5
BF16_RTOL = 2.0 ** -7


def _paged_inputs(rng, S=3, nh=2, hd=64, ps=16, maxP=4, P=9,
                  lens=(0, 17, 63)):
    """Ragged lanes: len 0 (only position 0), a lane one past a page
    boundary, a full table; each lane's unused table entries on scratch
    page 0."""
    q = rng.standard_normal((S, 1, nh, hd)).astype(np.float32)
    k = rng.standard_normal((P, ps, nh, hd)).astype(np.float32)
    v = rng.standard_normal((P, ps, nh, hd)).astype(np.float32)
    table = np.zeros((S, maxP), np.int32)
    pages = rng.permutation(np.arange(1, P))
    used = 0
    for s, ln in enumerate(lens):
        n = ln // ps + 1
        table[s, :n] = pages[used:used + n]
        used += n
    return q, k, v, table, np.asarray(lens, np.int32)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _check_plan_pages(plan, maxP, ps, lens):
    """A plan's invariants: whole pages, at most ``_MAX_SPLITS`` splits
    covering the table; for each slot the blocks with work take every
    filled page (positions 0..lens[s]) exactly once and none past it, in
    split order 0, 1, ..."""
    pps, splits = plan
    assert 1 <= splits <= paged_attn._MAX_SPLITS
    assert (splits - 1) * pps < maxP <= splits * pps
    for ln, blocks in zip(lens, paged_attn._split_pages(lens, ps, maxP,
                                                        pps)):
        assert [j for j, _ in blocks] == list(range(len(blocks)))
        assert len(blocks) <= splits
        pages = [p for _, ps_ in blocks for p in ps_]
        assert pages == list(range(ln // ps + 1))
        assert all(len(ps_) <= pps for _, ps_ in blocks)


@pytest.mark.parametrize("S,nh,maxP,ps,splits", [
    (8, 16, 32, 16, 1), (1, 16, 512, 16, None), (16, 16, 64, 16, 1),
    (4, 4, 4, 8, None), (2, 2, 2, 16, None), (3, 4, 6, 8, None),
    (4, 16, 8, 16, 1), (1, 1, 1024, 16, 32), (1, 1, 100, 3, None),
    (2, 4, 33, 2, None)])
def test_paged_grid_plan_reads_every_filled_page_once(S, nh, maxP, ps,
                                                       splits):
    """paged_decode_q8's plan, sized from the grid (132 SMs, an H100's):
    one split a slot where S * nh blocks reach the SMs (the serving decode
    shape, 128 blocks, pays no merge) or the table is short (a split takes
    at least 512 positions), else at most one block an SM; the page
    invariants of the table-sized plan."""
    lens = [0, ps - 1, ps, maxP * ps - 1, maxP * ps // 2][:max(S, 2)]
    plan = paged_attn._grid_plan(S, nh, maxP, ps, 132)
    if splits is not None:
        assert plan[1] == splits
    assert S * nh * plan[1] <= max(S * nh, 132)
    _check_plan_pages(plan, maxP, ps, lens)


@pytest.mark.parametrize("maxP,ps,lens", [
    (32, 16, [17, 331, 200, 64, 95, 300, 18, 120]),
    (64, 16, [0, 15, 16, 1023, 511, 512, 700]),
    (512, 16, [8191, 0]), (4, 8, [0, 7, 8, 31]), (6, 8, [47, 3, 12]),
    (2, 16, [0, 31]), (1, 1, [0]), (100, 3, [299, 0, 150, 2]),
    (33, 2, [65, 1, 64]), (64, 16, [0, 1023, 100])])
def test_paged_split_plan_reads_every_filled_page_once(maxP, ps, lens):
    """paged_decode's plan, sized from the table: whole pages, at most 32
    splits covering the table; for each slot the blocks with work take
    every filled page exactly once and none past it, in split order."""
    _check_plan_pages(paged_attn._split_plan(maxP, ps), maxP, ps, lens)


def test_int8_split_partials_merged_in_order_match_references():
    """The int8 kernel's arithmetic on a plan of several splits, in plain
    PyTorch: each split's (m, l, unnormalised acc) over its pages, merged
    in split order with one weight exp(m_j - max m) a split, matches the
    port's and the JAX package's ``_ref_paged_attention_quant`` in fp32."""
    rng = np.random.default_rng(10)
    S, nh, hd, ps, maxP = 3, 2, 32, 8, 192
    P = S * maxP + 1
    q = rng.standard_normal((S, 1, nh, hd)).astype(np.float32)
    kq = rng.integers(-127, 128, (P, ps, nh, hd)).astype(np.int8)
    vq = rng.integers(-127, 128, (P, ps, nh, hd)).astype(np.int8)
    ks = ((rng.random((P, ps, nh)) + 0.05) / 64).astype(np.float32)
    vs = ((rng.random((P, ps, nh)) + 0.05) / 64).astype(np.float32)
    table = rng.integers(0, P, (S, maxP)).astype(np.int32)
    lens = np.asarray([0, 700, maxP * ps - 1], np.int32)
    pps, splits = paged_attn._grid_plan(S, nh, maxP, ps, 132)
    assert splits == 3
    args = [_t(a) for a in (q, kq, ks, vq, vs, table, lens)]
    k = args[1].float() * args[2][..., None]          # [P, ps, nh, hd]
    v = args[3].float() * args[4][..., None]
    out = torch.zeros(S, 1, nh, hd)
    split_pages = paged_attn._split_pages(lens, ps, maxP, pps)
    for s, blocks in enumerate(split_pages):
        parts = []
        for _, pages in blocks:
            pos = [p * ps + i for p in pages for i in range(ps)
                   if p * ps + i <= lens[s]]
            rows = args[5][s].long()[[p // ps for p in pos]]
            kk = k[rows, torch.tensor(pos) % ps]       # [n, nh, hd]
            vv = v[rows, torch.tensor(pos) % ps]
            sc = torch.einsum("hd,nhd->hn", args[0][s, 0], kk) / hd ** 0.5
            m = sc.max(-1).values
            p = torch.exp(sc - m[:, None])
            parts.append((m, p.sum(-1), torch.einsum("hn,nhd->hd", p, vv)))
        M = torch.stack([m for m, _, _ in parts]).max(0).values
        L = torch.zeros(nh)
        A = torch.zeros(nh, hd)
        for m, l, acc in parts:                       # in split order
            w = torch.exp(m - M)
            L = L + l * w
            A = A + acc * w[:, None]
        out[s, 0] = A / L.clamp(min=1e-30)[:, None]
    port = paged_attn._ref_paged_attention_quant(*args)
    ref = np.asarray(jax_paged._ref_paged_attention_quant(
        *(jnp.asarray(a) for a in (q, kq, ks, vq, vs, table, lens))))
    np.testing.assert_allclose(out.numpy(), port.numpy(), atol=FP32_TOL,
                               rtol=0)
    np.testing.assert_allclose(out.numpy(), ref, atol=FP32_TOL, rtol=0)


class TestPagedAttentionParity:
    def test_plain_matches_jax_reference_and_interpret_kernel_fp32(self):
        q, k, v, table, lens = _paged_inputs(np.random.default_rng(0))
        port = paged_attn._ref_paged_attention(
            _t(q), _t(k), _t(v), _t(table), _t(lens)).numpy()
        ja = [jnp.asarray(a) for a in (q, k, v, table, lens)]
        ref = np.asarray(jax_paged._ref_paged_attention(*ja))
        kern = np.asarray(jax_paged._paged_attention_tpu(*ja,
                                                         interpret=True))
        assert port.shape == (3, 1, 2, 64)
        np.testing.assert_allclose(port, ref, atol=FP32_TOL, rtol=0)
        np.testing.assert_allclose(port, kern, atol=FP32_TOL, rtol=0)

    def test_plain_matches_jax_reference_bf16(self):
        q, k, v, table, lens = _paged_inputs(np.random.default_rng(1),
                                             lens=(15, 16, 40))
        bf = torch.bfloat16
        port = paged_attn._ref_paged_attention(
            _t(q, bf), _t(k, bf), _t(v, bf), _t(table), _t(lens))
        ref = jax_paged._ref_paged_attention(
            jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
            jnp.asarray(v, jnp.bfloat16), jnp.asarray(table),
            jnp.asarray(lens))
        ref = np.asarray(ref.astype(jnp.float32))
        np.testing.assert_allclose(port.float().numpy(), ref,
                                   rtol=BF16_RTOL, atol=BF16_RTOL)

    @pytest.mark.parametrize("hd", [24, 80])
    def test_plain_matches_jax_at_widths_the_kernel_masks(self, hd):
        """Head widths that leave lanes of the CUDA kernels' last 16-byte
        slice past hd (the reference falls back to its plain version
        there)."""
        q, k, v, table, lens = _paged_inputs(np.random.default_rng(hd),
                                             hd=hd)
        port = paged_attn._ref_paged_attention(
            _t(q), _t(k), _t(v), _t(table), _t(lens)).numpy()
        ref = np.asarray(jax_paged.paged_attention(
            *(jnp.asarray(a) for a in (q, k, v, table, lens))))
        assert port.shape == (3, 1, 2, hd)
        np.testing.assert_allclose(port, ref, atol=FP32_TOL, rtol=0)

    def test_table_entries_outside_the_pool_read_the_reference_pages(self):
        """Entries -1, -5, -P-3, P and P+40 in filled pages read the page
        the reference's gather reads (a negative entry wraps once, then
        the index is clamped to [0, P - 1]), through both plain versions,
        against the JAX ``_ref_paged_attention`` and
        ``_ref_paged_attention_quant``."""
        rng = np.random.default_rng(11)
        q, k, v, table, lens = _paged_inputs(rng, S=3, maxP=6, P=16,
                                             lens=(90, 40, 70))
        P = k.shape[0]
        table[0, 1:6] = [-1, -5, -P - 3, P, P + 40]
        table[1, 2] = -P
        table[2, 3] = P - 1
        idx = paged_attn._table_pages(_t(table), P).numpy()
        assert idx[0, 1:6].tolist() == [P - 1, P - 5, 0, P - 1, P - 1]
        assert idx[1, 2] == 0 and idx[2, 3] == P - 1
        ja = [jnp.asarray(a) for a in (q, k, v, table, lens)]
        port = paged_attn.paged_attention(*(_t(a) for a in (q, k, v, table,
                                                            lens)))
        ref = np.asarray(jax_paged._ref_paged_attention(*ja))
        np.testing.assert_allclose(port.numpy(), ref, atol=FP32_TOL, rtol=0)
        kq = rng.integers(-127, 128, k.shape).astype(np.int8)
        vq = rng.integers(-127, 128, v.shape).astype(np.int8)
        ks = ((rng.random(k.shape[:3]) + 0.05) / 64).astype(np.float32)
        vs = ((rng.random(k.shape[:3]) + 0.05) / 64).astype(np.float32)
        qargs = (q, kq, ks, vq, vs, table, lens)
        port = paged_attn.paged_attention_quant(*(_t(a) for a in qargs))
        ref = np.asarray(jax_paged._ref_paged_attention_quant(
            *(jnp.asarray(a) for a in qargs)))
        np.testing.assert_allclose(port.numpy(), ref, atol=FP32_TOL, rtol=0)

    @pytest.mark.parametrize("S", [1, 65535, 65536, 65537, 200000])
    def test_slot_chunks_cover_every_slot_once(self, S):
        """Slots go to the kernels in launches of at most 65,535 (the
        grid's y extent): in order, each slot in exactly one."""
        chunks = paged_attn._slot_chunks(S)
        assert all(1 <= n <= 65535 for _, n in chunks)
        assert [s0 for s0, _ in chunks] == [
            sum(n for _, n in chunks[:i]) for i in range(len(chunks))]
        assert sum(n for _, n in chunks) == S
        assert len(chunks) == -(-S // 65535)

    @pytest.mark.parametrize("hd,per,want", [
        (64, 8, (1, 64)), (256, 8, (1, 256)), (320, 8, (2, 256)),
        (160, 4, (2, 128)), (128, 4, (1, 128)), (640, 16, (2, 512)),
        (24, 4, (1, 24)), (1100, 16, (3, 512))])
    def test_head_groups_of_wide_heads(self, hd, per, want):
        """Up to 32 16-byte slices a head is one group; wider heads are cut
        into groups of 32 slices whose partials are that wide."""
        assert paged_attn._head_groups(hd, per) == want

    def test_wrapper_on_cpu_runs_plain_and_counts_nothing(self):
        q, k, v, table, lens = _paged_inputs(np.random.default_rng(2))
        args = (_t(q), _t(k), _t(v), _t(table), _t(lens))
        before = paged_attn.launches
        out = paged_attn.paged_attention(*args)
        assert paged_attn.launches == before
        assert torch.equal(out, paged_attn._ref_paged_attention(*args))


class TestLayerNormParity:
    def _inputs(self, rng, rows=16, H=128):
        x = (rng.standard_normal((rows, H)) * 3 + 1.5).astype(np.float32)
        g = rng.standard_normal(H).astype(np.float32)
        b = rng.standard_normal(H).astype(np.float32)
        return x, g, b

    def test_plain_matches_jax_reference_and_interpret_kernel_fp32(self):
        x, g, b = self._inputs(np.random.default_rng(3))
        port = norms._ref_layer_norm(_t(x), _t(g), _t(b), 1e-5).numpy()
        ja = [jnp.asarray(a) for a in (x, g, b)]
        ref = np.asarray(jax_norms._ref_layer_norm(*ja, 1e-5))
        kern = np.asarray(jax_norms.layer_norm(*ja, 1e-5, True))
        np.testing.assert_allclose(port, ref, atol=FP32_TOL, rtol=0)
        np.testing.assert_allclose(port, kern, atol=FP32_TOL, rtol=0)

    def test_plain_matches_jax_reference_bf16_rows_fp32_weights(self):
        x, g, b = self._inputs(np.random.default_rng(4))
        port = norms._ref_layer_norm(_t(x, torch.bfloat16), _t(g), _t(b),
                                     1e-5)
        assert port.dtype == torch.bfloat16
        ref = jax_norms._ref_layer_norm(jnp.asarray(x, jnp.bfloat16),
                                        jnp.asarray(g), jnp.asarray(b),
                                        1e-5)
        np.testing.assert_allclose(port.float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   rtol=BF16_RTOL, atol=BF16_RTOL)

    @pytest.mark.parametrize("H", [6, 7, 1001])
    def test_plain_matches_jax_at_widths_the_kernel_loads_by_element(self,
                                                                      H):
        """Widths whose rows are not 16-byte aligned (the CUDA kernel's
        one-element loads; the reference's ``_tileable`` sends them to its
        plain version)."""
        x, g, b = self._inputs(np.random.default_rng(H), rows=5, H=H)
        port = norms._ref_layer_norm(_t(x), _t(g), _t(b), 1e-5).numpy()
        ref = np.asarray(jax_norms.layer_norm(
            *(jnp.asarray(a) for a in (x, g, b)), 1e-5, True))
        np.testing.assert_allclose(port, ref, atol=FP32_TOL, rtol=0)

    def test_wrapper_on_cpu_takes_a_transposed_view(self):
        """A transposed x through the wrapper against the JAX reference on
        the same rows (the card copies such a view to rows first)."""
        x, g, b = self._inputs(np.random.default_rng(6), rows=64, H=64)
        xt = _t(x).t()
        assert not xt.is_contiguous()
        out = norms.layer_norm(xt, _t(g), _t(b))
        ref = np.asarray(jax_norms._ref_layer_norm(
            jnp.asarray(x.T), jnp.asarray(g), jnp.asarray(b), 1e-5))
        np.testing.assert_allclose(out.numpy(), ref, atol=FP32_TOL, rtol=0)

    @pytest.mark.parametrize("shape", [(2, 3, 128), (128,)])
    def test_wrapper_on_cpu_runs_plain_and_counts_nothing(self, shape):
        rng = np.random.default_rng(5)
        x = _t(rng.standard_normal(shape).astype(np.float32))
        g = _t(rng.standard_normal(shape[-1]).astype(np.float32))
        b = torch.zeros(shape[-1])
        before = norms.launches
        out = norms.layer_norm(x, g, b)
        assert norms.launches == before
        assert out.shape == x.shape
        assert torch.equal(out, norms._ref_layer_norm(x, g, b, 1e-5))


class TestRMSNormParity:
    """``_ref_rms_norm`` against the reference's ``rms_norm`` with
    ``interpret=True`` (the Pallas kernel in interpret mode where its
    ``_tileable`` gate admits the shape, its plain version where not) and
    against ``_ref_rms_norm``; the backward against ``jax.grad``."""

    def _inputs(self, rng, shape):
        x = (rng.standard_normal(shape) * 3 + 0.5).astype(np.float32)
        g = rng.standard_normal(shape[-1]).astype(np.float32)
        return x, g

    @pytest.mark.parametrize("shape", [(8, 128), (4, 8, 256)])
    def test_plain_matches_jax_reference_and_interpret_kernel_fp32(
            self, shape):
        x, g = self._inputs(np.random.default_rng(11), shape)
        port = norms._ref_rms_norm(_t(x), _t(g), 1e-6).numpy()
        ja = [jnp.asarray(a) for a in (x, g)]
        ref = np.asarray(jax_norms._ref_rms_norm(*ja, 1e-6))
        kern = np.asarray(jax_norms.rms_norm(*ja, 1e-6, True))
        np.testing.assert_allclose(port, ref, atol=FP32_TOL, rtol=0)
        np.testing.assert_allclose(port, kern, atol=FP32_TOL, rtol=0)

    @pytest.mark.parametrize("shape", [(8, 128), (4, 8, 256)])
    @pytest.mark.parametrize("g_bf16", [False, True])
    def test_plain_matches_jax_kernel_bf16(self, shape, g_bf16):
        x, g = self._inputs(np.random.default_rng(12), shape)
        bf = torch.bfloat16
        gt = _t(g, bf) if g_bf16 else _t(g)
        port = norms._ref_rms_norm(_t(x, bf), gt, 1e-6)
        assert port.dtype == bf
        jg = jnp.asarray(g, jnp.bfloat16) if g_bf16 else jnp.asarray(g)
        ref = jax_norms.rms_norm(jnp.asarray(x, jnp.bfloat16), jg, 1e-6,
                                 True)
        np.testing.assert_allclose(port.float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   rtol=BF16_RTOL, atol=BF16_RTOL)

    @pytest.mark.parametrize("shape", [(8, 128), (4, 8, 256)])
    def test_gradients_match_jax_grad(self, shape):
        import jax
        rng = np.random.default_rng(13)
        x, g = self._inputs(rng, shape)
        dy = rng.standard_normal(shape).astype(np.float32)
        xt, gt = _t(x).requires_grad_(), _t(g).requires_grad_()
        got = torch.autograd.grad(norms.rms_norm(xt, gt), (xt, gt), _t(dy))
        want = jax.grad(lambda a, b: jnp.sum(
            jax_norms.rms_norm(a, b, 1e-6, True) * jnp.asarray(dy)),
            argnums=(0, 1))(jnp.asarray(x), jnp.asarray(g))
        for a, w in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(w),
                                       atol=FP32_TOL, rtol=FP32_TOL)

    @pytest.mark.parametrize("shape", [(2, 3, 128), (5, 7), (8,), (0, 16)])
    def test_wrapper_on_cpu_runs_plain_and_counts_nothing(self, shape):
        rng = np.random.default_rng(14)
        x = _t(rng.standard_normal(shape).astype(np.float32))
        g = _t(rng.standard_normal(shape[-1]).astype(np.float32))
        before = (norms.launches, norms.rms_launches)
        out = norms.rms_norm(x, g)
        assert (norms.launches, norms.rms_launches) == before
        assert out.shape == x.shape
        assert torch.equal(out, norms._ref_rms_norm(x, g, 1e-6))


# --------------------------------------------------------------------------
# package boundary
# --------------------------------------------------------------------------

def test_build_without_nvcc_raises_naming_it(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build.os.path, "isfile",
                        lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc_path()


def test_library_digest_covers_included_headers(tmp_path, monkeypatch):
    """``build.lib_path``'s digest covers each header a source includes
    from ``csrc/``: editing the shared Hopper header renames (so rebuilds)
    the four libraries that include it and no other."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {n: build.lib_path(n) for n in build.SOURCES}
    assert build.source_files("flash_attn") == ["flash_attn.cu",
                                                "hopper.cuh"]
    assert build.source_files("fused_ffn") == ["fused_ffn.cu", "hopper.cuh"]
    assert build.source_files("dequant_matmul") == ["dequant_matmul.cu",
                                                    "hopper.cuh"]
    assert build.source_files("paged_attn") == ["paged_attn.cu"]
    assert build.source_files("row_matmul") == ["row_matmul.cu",
                                                "hopper.cuh"]
    assert build.lib_path("flash_attn") == before["flash_attn"]
    with open(csrc / "hopper.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: build.lib_path(n) for n in build.SOURCES}
    changed = {n for n in build.SOURCES if after[n] != before[n]}
    assert changed == {"flash_attn", "fused_ffn", "dequant_matmul",
                       "row_matmul"}


def test_resolve_device_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_device.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_device.resolve_device("cuda:0")
    assert port_device.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        port_device.resolve_device("meta")


def test_port_imports_neither_jax_nor_paddle_tpu():
    """Every module of the port, imported in a fresh interpreter (the
    quantized path's ``quantization`` and ``ops.cuda.dequant_matmul``,
    the nn API's ``nn``, ``framework``, ``tensor`` and ``autograd``, the
    pretraining path's ``models.bert`` and ``models.common``, and eager
    training's ``optimizer``, ``amp``, ``regularizer``, ``nn.clip`` and
    the losses, and the high-level API's ``io``, ``runtime``, ``metric``,
    ``hapi``, ``jit`` and ``static``, and speculative serving's
    ``inference.speculative``, the static graph's ``static.graph``,
    ``static.backward`` and ``static.nn``, the conv and pooling modules,
    ``vision`` and the row-invariant matmul among them), leaves ``jax`` and
    ``paddle_tpu`` out of ``sys.modules``
    (exact keys: the port's own name starts with ``paddle_tpu``)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import importlib, pkgutil, sys\n"
        "import paddle_tpu_torch\n"
        "for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,\n"
        "                               'paddle_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in ('jax', 'jaxlib', 'paddle_tpu') if k in sys.modules]\n"
        "bad += [k for k in sys.modules if k.startswith(('jax.', 'paddle_tpu.'))]\n"
        "need = ('paddle_tpu_torch.quantization',\n"
        "        'paddle_tpu_torch.ops.cuda.dequant_matmul',\n"
        "        'paddle_tpu_torch.ops.cuda.paged_attn',\n"
        "        'paddle_tpu_torch.nn', 'paddle_tpu_torch.nn.functional',\n"
        "        'paddle_tpu_torch.nn.layer.transformer',\n"
        "        'paddle_tpu_torch.framework', 'paddle_tpu_torch.tensor',\n"
        "        'paddle_tpu_torch.autograd', 'paddle_tpu_torch.ops.dispatch',\n"
        "        'paddle_tpu_torch.models.bert',\n"
        "        'paddle_tpu_torch.models.common',\n"
        "        'paddle_tpu_torch.optimizer',\n"
        "        'paddle_tpu_torch.optimizer.optimizer',\n"
        "        'paddle_tpu_torch.optimizer.optimizers',\n"
        "        'paddle_tpu_torch.optimizer.lr',\n"
        "        'paddle_tpu_torch.amp', 'paddle_tpu_torch.amp.grad_scaler',\n"
        "        'paddle_tpu_torch.autograd.py_layer',\n"
        "        'paddle_tpu_torch.regularizer', 'paddle_tpu_torch.nn.clip',\n"
        "        'paddle_tpu_torch.nn.functional.loss',\n"
        "        'paddle_tpu_torch.nn.layer.loss',\n"
        "        'paddle_tpu_torch.io', 'paddle_tpu_torch.io.dataloader',\n"
        "        'paddle_tpu_torch.io.dataset',\n"
        "        'paddle_tpu_torch.io.serialization',\n"
        "        'paddle_tpu_torch.runtime', 'paddle_tpu_torch.runtime.build',\n"
        "        'paddle_tpu_torch.metric', 'paddle_tpu_torch.hapi',\n"
        "        'paddle_tpu_torch.hapi.model',\n"
        "        'paddle_tpu_torch.hapi.callbacks',\n"
        "        'paddle_tpu_torch.hapi.model_summary',\n"
        "        'paddle_tpu_torch.jit', 'paddle_tpu_torch.jit.api',\n"
        "        'paddle_tpu_torch.static',\n"
        "        'paddle_tpu_torch.inference.speculative',\n"
        "        'paddle_tpu_torch.static.graph',\n"
        "        'paddle_tpu_torch.static.backward',\n"
        "        'paddle_tpu_torch.static.nn',\n"
        "        'paddle_tpu_torch.nn.functional.conv',\n"
        "        'paddle_tpu_torch.nn.functional.pooling',\n"
        "        'paddle_tpu_torch.nn.layer.conv',\n"
        "        'paddle_tpu_torch.nn.layer.pooling',\n"
        "        'paddle_tpu_torch.vision',\n"
        "        'paddle_tpu_torch.vision.models.resnet',\n"
        "        'paddle_tpu_torch.vision.models.lenet',\n"
        "        'paddle_tpu_torch.vision.datasets.mnist',\n"
        "        'paddle_tpu_torch.ops.cuda.row_matmul')\n"
        "bad += [k for k in need if k not in sys.modules]\n"
        "print(len([k for k in sys.modules if k.startswith('paddle_tpu_torch')]))\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    p = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
    assert int(p.stdout.strip().splitlines()[-1]) >= 30
