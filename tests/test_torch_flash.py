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
    (1, 128, 128, 1, 384, True, None),      # hd 384: a Pallas width past
                                            # 256 (the kernels' groups)
    (1, 128, 128, 1, 256, True, None),      # hd 256: the bf16 backward
                                            # kernels' group route
    (2, 128, 128, 3, 64, False, None),      # the encoder's route: no mask,
                                            # B and nh > 1
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


# (B, N, Nk, nh, hd, causal): head widths the CUDA kernels take only after
# the wrapper zero-pads them (32 -> 64, 96 -> 128, 200 -> 256, 300 -> 320),
# and widths past 256, which run on the kernels' 64-column head-width
# groups (320, 384, 512, 640: the kernel width is hd itself)
PAD_CASES = [(1, 64, 64, 2, 32, True), (2, 48, 80, 2, 96, True),
             (1, 40, 40, 2, 200, False), (1, 24, 24, 2, 300, True),
             (1, 40, 40, 2, 320, True), (1, 24, 56, 1, 384, True),
             (2, 16, 16, 1, 512, False), (1, 32, 32, 1, 640, True)]


@pytest.mark.parametrize("case", PAD_CASES,
                         ids=[f"hd{c[4]}" for c in PAD_CASES])
def test_padded_head_width_matches_reference(case):
    """The wrapper's padding (``_padded_fwd`` / ``_padded_bwd``) around the
    kernels' plain versions, at a width the kernels are not built for:
    out, lse and the vjp against the JAX ``flash_attention`` (which runs
    ``_ref_attention`` at these widths) at the forward's 1e-5 in fp32."""
    B, N, Nk, nh, hd, causal = case
    D = T._kernel_width(hd)
    assert D >= hd and (D in T._HEAD_DIMS or (D > 256 and D % 64 == 0
                                               and D - hd < 64))
    q, k, v, do = _inputs(case + (None,), 21)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = T._padded_fwd(T._ref_flash_fwd, tq, tk, tv, causal)
    assert out.shape == (B, N, nh, hd) and lse.shape == (B, nh, N)
    got = T._padded_bwd(T._ref_flash_bwd, tq, tk, tv, out, lse, tdo, causal)
    jout, vjp = jax.vjp(lambda a, b, c: J.flash_attention(a, b, c, causal),
                        *(jnp.asarray(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=FWD_TOL,
                               rtol=0)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(J._ref_attention(
            *(jnp.asarray(a) for a in (q, k, v)), causal)),
        atol=FWD_TOL, rtol=0)
    # the row logsumexp at the true width's scale
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd)
    if causal:
        s = np.where(np.tril(np.ones((N, Nk), bool), Nk - N), s, -1e30)
    want_lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
        + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=FWD_TOL, rtol=0)
    for name, g, w in zip(("dq", "dk", "dv"), got, vjp(jnp.asarray(do))):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FWD_TOL,
                                   rtol=0, err_msg=name)


def test_kernel_operand_copies_only_rows_the_kernels_cannot_load():
    """``_kernel_operand``: the model's q/k/v, strided views of its fused
    [B, N, 3, nh*hd] projection, reach the kernels without a copy; a bf16
    view whose rows start off 16 bytes is copied to contiguous rows; a
    view with a non-unit last stride is made contiguous; fp32 views with a
    unit last stride pass as they are."""
    B, N, nh, hd = 2, 8, 2, 64
    for dt in (torch.bfloat16, torch.float32):
        qkv = torch.zeros(B, N, 3, nh * hd, dtype=dt)
        for i in range(3):
            view = qkv[:, :, i].reshape(B, N, nh, hd)
            got = T._kernel_operand(view)
            assert got.data_ptr() == view.data_ptr()
            assert got.stride() == view.stride()
    # rows 4 elements (8 bytes) off 16-byte alignment, row stride 132
    base = torch.zeros(B, N, nh * hd + 4, dtype=torch.bfloat16)
    off = base[:, :, 4:].view(B, N, nh, hd)
    got = T._kernel_operand(off)
    assert got.data_ptr() != off.data_ptr() and got.is_contiguous()
    assert torch.equal(got, off)
    f32 = torch.zeros(B, N, nh * hd + 4)[:, :, 4:].view(B, N, nh, hd)
    assert T._kernel_operand(f32).data_ptr() == f32.data_ptr()
    # the head axis last: a non-unit last stride
    tr = torch.zeros(B, N, hd, nh, dtype=torch.bfloat16).transpose(-1, -2)
    got = T._kernel_operand(tr)
    assert got.stride(-1) == 1 and torch.equal(got, tr)
