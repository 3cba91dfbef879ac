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
    both libraries that include it and no other."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {n: build.lib_path(n) for n in build.SOURCES}
    assert build.source_files("flash_attn") == ["flash_attn.cu",
                                                "hopper.cuh"]
    assert build.source_files("fused_ffn") == ["fused_ffn.cu", "hopper.cuh"]
    assert build.lib_path("flash_attn") == before["flash_attn"]
    with open(csrc / "hopper.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: build.lib_path(n) for n in build.SOURCES}
    changed = {n for n in build.SOURCES if after[n] != before[n]}
    assert changed == {"flash_attn", "fused_ffn"}


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
    quantized path's ``quantization`` and ``ops.cuda.dequant_matmul``
    and the nn API's ``nn``, ``framework``, ``tensor`` and ``autograd``
    among them), leaves ``jax`` and ``paddle_tpu`` out of ``sys.modules``
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
        "        'paddle_tpu_torch.autograd', 'paddle_tpu_torch.ops.dispatch')\n"
        "bad += [k for k in need if k not in sys.modules]\n"
        "print(len([k for k in sys.modules if k.startswith('paddle_tpu_torch')]))\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    p = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
    assert int(p.stdout.strip().splitlines()[-1]) >= 18
