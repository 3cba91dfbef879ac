"""The row-invariant product's wrapper (``paddle_tpu_torch/ops/cuda/
row_matmul.py``) on the CPU.

The kernels run only on a card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` (c)); here the parts that decide a launch: the route and
the K split come from the dtype, K, N and W's alignment and never from M
(property tests over M, K and N), the split covers each k once in a fixed
order and within the kernels' limits, and the CPU path is ``x @ w`` bit
for bit (and, in float32, within 1e-5 of max|ref| of the reference's
``jnp.matmul`` on the same numpy inputs: only the order of fp32 sums
differs).
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from paddle_tpu_torch.ops.cuda import row_matmul

FP32_TOL = 1e-5
# gpt_345m's four block products (K, N): qkv, proj, fc1, fc2
SERVING = ((1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024))
DTYPES = (torch.float32, torch.bfloat16)
PROPS = settings(max_examples=200, deadline=None, derandomize=True,
                 database=None)


def _operands(dt, M, K, N, w_offset=0):
    """x [M, K] and w [K, N] of dtype ``dt`` as broadcast views of one
    element (no [M, K] storage: only shapes, dtype and W's address are
    read); W starts ``w_offset`` elements past an aligned allocation."""
    x = torch.zeros((1, 1), dtype=dt).expand(M, K)
    w = torch.zeros(8, dtype=dt)[w_offset:w_offset + 1].reshape(
        1, 1).expand(K, N)
    return x, w


def test_plan_functions_take_no_row_count():
    for fn in (row_matmul._route, row_matmul._plan, row_matmul._k_steps):
        assert "M" not in inspect.signature(fn).parameters, fn.__name__


@PROPS
@given(m1=st.integers(1, 400), m2=st.integers(1, 400),
       K=st.integers(0, 20000), N=st.integers(1, 6000),
       dt=st.sampled_from(DTYPES), w_offset=st.integers(0, 7))
def test_route_and_plan_never_read_m(m1, m2, K, N, dt, w_offset):
    """Two row counts on the same W give the same route and the same
    launch integers but M: the order of every output's sum."""
    x, w = _operands(dt, max(m1, m2), K, N, w_offset)
    r1, a1 = row_matmul._args(x[:m1], w)
    r2, a2 = row_matmul._args(x[:m2], w)
    assert r1 == r2
    assert (a1[0], a2[0]) == (m1, m2)
    assert a1[1:] == a2[1:]
    assert a1[1:3] == (K, N)


@PROPS
@given(K=st.integers(0, 20000), N=st.integers(1, 6000),
       route=st.sampled_from(("tensor", "cuda_core")))
def test_k_steps_cover_each_k_once_in_a_fixed_order(K, N, route):
    """The k ranges, in the order the kernel adds them, cover 0 .. K - 1,
    each k once, rank by rank and unit by unit (in k order within a unit,
    in k order outright on the CUDA cores); the same order every time;
    the split stays within what the C entry takes."""
    if route == "tensor" and not 0 < K <= row_matmul._TC_MAX_K:
        return      # the tensor route never takes these K
    steps = row_matmul._k_steps(route, K, N)
    ks = [k for _, _, k0, k1 in steps for k in range(k0, k1)]
    assert sorted(ks) == list(range(K)) and len(ks) == K
    if route == "cuda_core":
        assert ks == list(range(K))
    keys = [(q, u) for q, u, _, _ in steps]
    assert keys == sorted(keys)
    for key in set(keys):
        unit = [k for q, u, k0, k1 in steps if (q, u) == key
                for k in range(k0, k1)]
        assert unit == sorted(unit)
    assert steps == row_matmul._k_steps(route, K, N)
    cs, kb = row_matmul._plan(route, K, N)
    assert sorted({q for q, _, _, _ in steps}) == list(range(cs))
    if route == "tensor":
        assert kb % 64 == 0 and 64 <= kb <= 512 and 1 <= cs <= 16
        assert (cs - 1) * kb < K <= cs * kb
        # each rank's steps are whole 64-row boxes of 4 k16 steps
        for q in range(cs):
            n = sum(1 for s in steps if s[0] == q)
            assert n % 4 == 0 and 16 * n >= min(K, q * kb + kb) - q * kb
    else:
        assert cs in (1, 2, 4, 8) and cs * 16 * kb >= K


@pytest.mark.parametrize("dt,K,N,w_offset,want", [
    *[(torch.bfloat16, K, N, 0, "tensor") for K, N in SERVING],
    (torch.bfloat16, 1032, 1000, 0, "tensor"),
    (torch.bfloat16, row_matmul._TC_MAX_K, 8, 0, "tensor"),
    (torch.bfloat16, 1030, 1000, 0, "cuda_core"),     # K % 8 != 0
    (torch.bfloat16, 1030, 1001, 0, "cuda_core"),     # N % 8 != 0
    (torch.bfloat16, 13, 10, 0, "cuda_core"),
    (torch.bfloat16, 1024, 1024, 1, "cuda_core"),     # W off 16 bytes
    (torch.bfloat16, row_matmul._TC_MAX_K + 1, 8, 0, "cuda_core"),
    (torch.bfloat16, 0, 8, 0, "cuda_core"),
    *[(torch.float32, K, N, 0, "cuda_core") for K, N in SERVING],
])
def test_route_from_dtype_n_and_alignment(dt, K, N, w_offset, want):
    x, w = _operands(dt, 8, K, N, w_offset)
    assert row_matmul._args(x, w)[0] == want


def test_serving_products_read_w_once_per_64_rows():
    """At gpt_345m's products the tensor route's blocks hold their whole
    k range (at most 8 boxes, all loaded at once), so W leaves device
    memory once for up to 64 rows, and the cluster gives the card at
    least 64 blocks."""
    for K, N in SERVING:
        cs, kb = row_matmul._plan("tensor", K, N)
        assert kb // 64 <= 8, (K, N)
        assert cs * -(-N // 64) >= row_matmul._TC_BLOCKS, (K, N)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("lead,K,N", [((8,), 64, 96), ((2, 5), 128, 64),
                                      ((40,), 96, 200), ((3,), 13, 10)])
def test_cpu_path_is_x_at_w(dt, lead, K, N):
    """On the CPU the wrapper is ``x @ w``, bit for bit, launches nothing,
    and in float32 agrees with the reference's ``jnp.matmul`` on the same
    numpy inputs."""
    rng = np.random.default_rng(K * N + len(lead))
    xn = rng.standard_normal((*lead, K)).astype(np.float32)
    wn = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    x, w = torch.from_numpy(xn).to(dt), torch.from_numpy(wn).to(dt)
    before = row_matmul.launches
    got = row_matmul.matmul(x, w)
    assert row_matmul.launches == before
    assert got.dtype == dt and got.shape == (*lead, N)
    assert torch.equal(got, x @ w)
    if dt == torch.float32:
        ref = np.asarray(jnp.matmul(xn, wn))
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=FP32_TOL * np.abs(ref).max())


def test_cpu_rows_match_single_row_products():
    """The CPU path's rows, as the decode (M = S) and the verify (M = S W)
    take them, are the single-row products' in float32 within 1e-5 (the
    plain path makes no bit promise across M: the card's kernels do)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((40, 256)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((256, 384)) * 0.02)
                         .astype(np.float32))
    full = row_matmul.matmul(x, w)
    ones = torch.cat([row_matmul.matmul(x[r:r + 1], w) for r in range(40)])
    torch.testing.assert_close(full, ones, rtol=0,
                               atol=FP32_TOL * float(ones.abs().max()))
