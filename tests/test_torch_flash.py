"""paddle_tpu_torch flash attention against the JAX package, on the CPU.

The same numpy-seeded q/k/v/dO go through the port's plain versions of
the flash kernels and through the JAX reference: ``_ref_attention``, the
Pallas forward and split backward kernels in interpret mode, and
``jax.vjp`` of ``flash_attention``.  Tolerances are the JAX package's own
flash test's (tests/test_pallas_kernels.py): 1e-5 absolute on the forward
(out and lse), 2e-4 absolute on the gradients.

The CUDA kernels are held against these plain versions on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attn as J
from paddle_tpu_torch.ops.cuda import flash_attn as T

FWD_TOL = 1e-5
BWD_TOL = 2e-4

# (B, N, Nk, nh, hd, causal, JAX block size or None for its defaults)
CASES = [
    (1, 128, 128, 2, 64, True, None),
    (1, 128, 128, 2, 64, False, None),
    (1, 128, 320, 2, 64, True, None),       # cross length, bottom-right
    (1, 384, 384, 1, 64, True, 256),        # uneven tail on the JAX side
    (1, 128, 128, 1, 128, True, None),      # hd 128
]
IDS = [f"B{c[0]}-N{c[1]}-Nk{c[2]}-nh{c[3]}-hd{c[4]}-"
       f"{'causal' if c[5] else 'full'}" + (f"-blk{c[6]}" if c[6] else "")
       for c in CASES]


def _inputs(case, seed):
    B, N, Nk, nh, hd, _, _ = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, N, nh, hd)).astype(np.float32)
    k = rng.standard_normal((B, Nk, nh, hd)).astype(np.float32)
    v = rng.standard_normal((B, Nk, nh, hd)).astype(np.float32)
    do = rng.standard_normal((B, N, nh, hd)).astype(np.float32)
    return q, k, v, do


def _blocks(case):
    blk = case[6]
    return {} if blk is None else {"block_q": blk, "block_k": blk}


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_ref_flash_fwd_matches_reference_and_interpret_kernel(case):
    causal = case[5]
    q, k, v, _ = _inputs(case, 0)
    out, lse = T._ref_flash_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                                causal)
    assert lse.shape == (case[0], case[3], case[1])
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    ref = np.asarray(J._ref_attention(jq, jk, jv, causal))
    kout, klse = J._flash_attention_tpu(jq, jk, jv, causal, interpret=True,
                                        return_lse=True, **_blocks(case))
    np.testing.assert_allclose(out.numpy(), ref, atol=FWD_TOL, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(kout), atol=FWD_TOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(klse)[..., 0],
                               atol=FWD_TOL, rtol=0)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_ref_flash_bwd_matches_interpret_split_kernels(case):
    causal = case[5]
    q, k, v, do = _inputs(case, 1)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = T._ref_flash_fwd(tq, tk, tv, causal)
    got = T._ref_flash_bwd(tq, tk, tv, out, lse, tdo, causal)
    lse_lanes = jnp.broadcast_to(jnp.asarray(lse.numpy())[..., None],
                                 lse.shape + (128,))
    want = J._flash_attention_bwd_tpu(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(out.numpy()), lse_lanes, jnp.asarray(do), causal,
        interpret=True, fused=False, **_blocks(case))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=BWD_TOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cpu_autograd_matches_jax_vjp(case):
    causal = case[5]
    q, k, v, do = _inputs(case, 2)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = T.flash_attention(*ts, causal=causal)
    got = torch.autograd.grad(out, ts, torch.from_numpy(do))
    jout, vjp = jax.vjp(lambda a, b, c: J.flash_attention(a, b, c, causal),
                        *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=FWD_TOL, rtol=0)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=BWD_TOL,
                                   rtol=0, err_msg=name)


def test_wrapper_on_cpu_counts_nothing_and_refuses_fused_backward():
    """On the CPU neither backward strategy launches a kernel; the
    ``bwd_fused`` flag is set and cleared as the reference's is, and the
    tilings it does not port are still refused."""
    q, k, v, _ = _inputs(CASES[0], 3)
    counters = ("fwd_launches", "dq_launches", "dkv_launches",
                "fused_launches")
    before = [getattr(T, c) for c in counters]
    try:
        for fused in (False, True):
            T.set_default_blocks(bwd_fused=fused)
            assert T._BWD_FUSED is fused
            T.set_default_blocks()                  # None keeps it
            assert T._BWD_FUSED is fused
            ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
            T.flash_attention(*ts, causal=True).sum().backward()
            assert [getattr(T, c) for c in counters] == before
        with pytest.raises(NotImplementedError, match="fixed"):
            T.set_default_blocks(fwd=(128, 128))
        with pytest.raises(NotImplementedError, match="fixed"):
            T.set_default_blocks(bwd=(128, 128), bwd_fused=False)
    finally:
        T.set_default_blocks(bwd_fused=False)
    assert T._BWD_FUSED is False
