"""The reference bench's fused routes in paddle_tpu_torch against the JAX
package, on the CPU: the fused FFN, the fused flash backward, the train
step with both on, and the serving engine with ``use_fused_ffn``.

Inputs are drawn from numpy seeds and handed to both packages.  The JAX
Pallas kernels run in interpret mode, as ``tests/test_pallas_kernels.py``
runs them.  Tolerances:

* ``_ref_ffn`` against the interpret-mode ``fused_ffn`` kernel in fp32:
  2e-4 absolute and 1e-4 relative, the JAX test's own; its gradients 2e-3
  and 1e-3, the JAX gradient test's own.
* ``_ref_fused_ffn`` (the CUDA kernel's function) against the
  interpret-mode kernel in bf16: per element 2^-8 + 2^-6 |ref|, the bf16
  gate of ``chip_smoke.py`` (both round h once and the output once, from
  fp32 sums taken in another order).
* ``_ref_flash_bwd`` against the JAX fused backward kernel: 1e-5 absolute,
  the JAX test's bound between its fused and split kernels.
* The train step with every fused route on, fp32: loss and every gradient
  within 1e-5, three steps of params within 1e-5.  fp32 compute over bf16
  params and bf16 AdamW moments (the flagship's storage): three steps,
  each from the reference's state, each loss within 1e-5 of the
  reference's ``gpt.loss_fn`` on that state, and each param leaf
  within one bf16 step of the JAX value (the same update computed in fp32
  in another order may round to the neighbouring bf16), but for at most
  0.1% of the elements, whose gradients sit at bf16 rounding level (see
  the test).  That test checks the storage; the fp32 one checks the
  update.
* The engine: greedy tokens exact against the JAX ``generate``.

The flags ``set_default_blocks(bwd_fused=...)`` of both packages are
reset in a ``finally``.
"""
import contextlib
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import gpt as J
from paddle_tpu.models import gpt_hybrid as JH
from paddle_tpu.ops.pallas import flash_attn as JFA
from paddle_tpu.ops.pallas import fused_ffn as JFF
from paddle_tpu.parallel.mesh import create_mesh
from paddle_tpu_torch.inference import serving as S
from paddle_tpu_torch.models import gpt as T
from paddle_tpu_torch.models import gpt_hybrid as TH
from paddle_tpu_torch.ops.cuda import flash_attn as TFA
from paddle_tpu_torch.ops.cuda import fused_ffn as TFF
from test_torch_gpt import _wide_cfg, numpy_params

FFN_ATOL, FFN_RTOL = 2e-4, 1e-4
FFN_GRAD_ATOL, FFN_GRAD_RTOL = 2e-3, 1e-3
BF16_ATOL, BF16_RTOL = 2.0 ** -8, 2.0 ** -6
BWD_TOL = 1e-5
TOL = 1e-5
CPU = "cpu"


@contextlib.contextmanager
def fused_backward():
    """``bwd_fused=True`` on both packages, reset to False after."""
    try:
        JFA.set_default_blocks(bwd_fused=True)
        TFA.set_default_blocks(bwd_fused=True)
        yield
    finally:
        JFA.set_default_blocks(bwd_fused=False)
        TFA.set_default_blocks(bwd_fused=False)


def _ffn_inputs(seed, lead, H, F, bias=0.01):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*lead, H) * 0.5).astype(np.float32),
            (rng.randn(H, F) * 0.05).astype(np.float32),
            (rng.randn(F) * bias).astype(np.float32),
            (rng.randn(F, H) * 0.05).astype(np.float32),
            (rng.randn(H) * bias).astype(np.float32)]


# --------------------------------------------------------------------------
# fused FFN
# --------------------------------------------------------------------------

@pytest.mark.parametrize("M,H,F", [(128, 128, 256), (256, 256, 512)])
def test_ref_ffn_matches_interpret_kernel(M, H, F):
    args = _ffn_inputs(3, (M,), H, F)
    before = TFF.launches
    got = TFF.fused_ffn(*(torch.from_numpy(a) for a in args))
    assert TFF.launches == before                 # CPU: the plain version
    kernel = JFF.fused_ffn(*(jnp.asarray(a) for a in args), True)
    ref = JFF._ref_ffn(*(jnp.asarray(a) for a in args))
    for want in (kernel, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=FFN_ATOL, rtol=FFN_RTOL)
    # in fp32 the kernel's function is the reference's
    np.testing.assert_allclose(
        TFF._ref_fused_ffn(*(torch.from_numpy(a) for a in args)).numpy(),
        got.numpy(), atol=TOL, rtol=0)


def test_fused_ffn_batched_grads_match_interpret_kernel():
    x, w1, _, w2, _ = _ffn_inputs(4, (2, 64), 128, 256)
    b1, b2 = np.zeros(256, np.float32), np.zeros(128, np.float32)
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w1, w2)]
    out = TFF.fused_ffn(ts[0], ts[1], torch.from_numpy(b1), ts[2],
                        torch.from_numpy(b2))
    assert out.shape == x.shape
    got = torch.autograd.grad((out ** 2).sum(), ts)

    def f(a, c, d):
        return jnp.sum(JFF.fused_ffn(a, c, jnp.asarray(b1), d,
                                     jnp.asarray(b2), True) ** 2)
    want = jax.grad(f, (0, 1, 2))(*(jnp.asarray(a) for a in (x, w1, w2)))
    for name, g, w in zip(("dx", "dw1", "dw2"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=FFN_GRAD_ATOL, rtol=FFN_GRAD_RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("M,H,F", [(128, 128, 256), (32, 256, 512)])
def test_kernel_function_matches_interpret_kernel_bf16(M, H, F):
    """The CUDA kernel's plain version in bf16 against the Pallas kernel in
    interpret mode: both round h to bf16 once and the output once."""
    args = _ffn_inputs(5, (M,), H, F, bias=0.1)
    got = TFF._ref_fused_ffn(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in args)).float()
    want = JFF.fused_ffn(*(jnp.asarray(a, jnp.bfloat16) for a in args),
                         True)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    bound = BF16_ATOL + BF16_RTOL * np.abs(want)
    assert np.all(np.abs(got.numpy() - want) <= bound)


def test_fused_ffn_autograd_matches_plain_and_refuses_tilings():
    """The CPU path is autograd of ``_ref_ffn`` for every input, biases
    included; the reference's tiling override is refused by name."""
    args = [torch.from_numpy(a).requires_grad_()
            for a in _ffn_inputs(6, (3, 5), 64, 96, bias=0.1)]
    g = torch.from_numpy(np.random.RandomState(7).randn(3, 5, 64)
                         .astype(np.float32))
    got = torch.autograd.grad(TFF.fused_ffn(*args), args, g)
    want = torch.autograd.grad(TFF._ref_ffn(*args), args, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    TFF.set_default_blocks(None)
    with pytest.raises(NotImplementedError, match="fixed"):
        TFF.set_default_blocks((128, 512))


@pytest.mark.parametrize("M,H,F", [(7, 6, 10), (33, 20, 36)])
def test_padded_ffn_matches_reference(M, H, F):
    """The wrapper's padding (``_padded``: H and F zero-padded to multiples
    of 8, the output sliced back) around the kernel's plain version, at
    widths the kernel does not take as they are, against the reference's
    ``_ref_ffn`` at 1e-5 in fp32."""
    args = _ffn_inputs(14, (M,), H, F, bias=0.1)
    got = TFF._padded(TFF._ref_fused_ffn,
                      *(torch.from_numpy(a) for a in args))
    assert got.shape == (M, H) and got.is_contiguous()
    want = np.asarray(JFF._ref_ffn(*(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


# --------------------------------------------------------------------------
# fused flash backward
# --------------------------------------------------------------------------

FUSED_BWD_CASES = [
    (2, 256, 256, 2, 64, False),
    (2, 256, 256, 2, 64, True),
    (1, 384, 384, 2, 64, True),      # uneven tail blocks
    (1, 128, 320, 2, 64, True),      # cross length
    (1, 512, 512, 1, 128, False),
    (1, 128, 128, 1, 384, True),     # hd 384: past the kernels' 256
]


@pytest.mark.parametrize("B,N,Nk,nh,hd,causal", FUSED_BWD_CASES)
def test_ref_flash_bwd_matches_interpret_fused_kernel(B, N, Nk, nh, hd,
                                                      causal):
    rng = np.random.RandomState(12)
    q = rng.randn(B, N, nh, hd).astype(np.float32)
    k = rng.randn(B, Nk, nh, hd).astype(np.float32)
    v = rng.randn(B, Nk, nh, hd).astype(np.float32)
    do = rng.randn(B, N, nh, hd).astype(np.float32)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    out, lse = JFA._flash_attention_tpu(jq, jk, jv, causal, interpret=True,
                                        return_lse=True)
    want = JFA._flash_attention_bwd_tpu(jq, jk, jv, out, lse, jdo, causal,
                                        interpret=True, fused=True)
    got = TFA._ref_flash_bwd(
        *(torch.from_numpy(a) for a in (q, k, v)),
        torch.from_numpy(np.array(out)),
        torch.from_numpy(np.array(lse)[..., 0]), torch.from_numpy(do),
        causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=BWD_TOL,
                                   rtol=0, err_msg=name)


def test_flash_attention_with_fused_flag_matches_jax_vjp():
    """The wrapper's autograd with ``bwd_fused=True`` on both sides: the
    port's CPU path against ``jax.vjp`` of the JAX ``flash_attention``."""
    rng = np.random.RandomState(13)
    q, k, v, do = (rng.randn(1, 128, 2, 64).astype(np.float32)
                   for _ in range(4))
    with fused_backward():
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = TFA.flash_attention(*ts, causal=True)
        got = torch.autograd.grad(out, ts, torch.from_numpy(do))
        jout, vjp = jax.vjp(
            lambda a, b, c: JFA.flash_attention(a, b, c, True),
            *(jnp.asarray(a) for a in (q, k, v)))
        want = vjp(jnp.asarray(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=TOL, rtol=0)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4,
                                   rtol=0, err_msg=name)


# --------------------------------------------------------------------------
# the slice: the train step with both fused routes on
# --------------------------------------------------------------------------

def _cfgs(**kw):
    kw = dict(use_flash=True, use_fused_ffn=True, use_pallas_norm=True,
              remat=True, **kw)
    return (dataclasses.replace(_wide_cfg(J), **kw),
            dataclasses.replace(_wide_cfg(T), **kw))


def _tokens(seed, V=256, B=2, N=16):
    t = np.random.default_rng(seed).integers(0, V, (B, N)).astype(np.int32)
    labels = t.copy()
    labels[0, -3:] = -100
    return t, labels


def _jax_step(jcfg, **kw):
    return JH.make_train_step(
        jcfg, create_mesh(dp=1, tp=1, pp=1, sp=1,
                          devices=[jax.devices()[0]]), **kw)


def test_fused_slice_loss_and_grads_match_reference():
    jcfg, tcfg = _cfgs()
    tree = numpy_params(jcfg, 0)
    toks, labels = _tokens(1)
    with fused_backward():
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p, t, lab: J.loss_fn(p, t, lab, jcfg)))(
                jax.tree_util.tree_map(jnp.asarray, tree),
                jnp.asarray(toks), jnp.asarray(labels))
        loss, grads = TH.loss_and_grads(
            T.params_from_numpy(tree, CPU), torch.from_numpy(toks),
            torch.from_numpy(labels), tcfg)
    assert abs(float(loss) - float(jloss)) <= TOL
    for path, g in TH._leaves(grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(TH._at(jgrads, path)),
                                   atol=TOL, rtol=0, err_msg=str(path))


def test_fused_slice_three_steps_match_reference_fp32():
    """As ``test_torch_train``'s three-step test (Adam eps 1e-6 on both
    sides), with every fused route on."""
    jcfg, tcfg = _cfgs()
    tree = numpy_params(jcfg, 0)
    toks, labels = _tokens(3)
    with fused_backward():
        jstep = _jax_step(jcfg, eps=1e-6)
        jp = jax.tree_util.tree_map(jnp.asarray, tree)
        jm = jax.tree_util.tree_map(jnp.zeros_like, jp)
        jv = jax.tree_util.tree_map(jnp.zeros_like, jp)
        tp = T.params_from_numpy(copy.deepcopy(tree), CPU)
        tm, tv = TH.init_train_state(tp)
        tstep = TH.make_train_step(tcfg, eps=1e-6)
        tt, tl = torch.from_numpy(toks), torch.from_numpy(labels)
        for t in (1, 2, 3):
            jp, jm, jv, jloss = jstep(jp, jm, jv, jnp.int32(t),
                                      jnp.asarray(toks), jnp.asarray(labels),
                                      jnp.float32(1e-4))
            tloss = tstep(tp, tm, tv, t, tt, tl, 1e-4)[3]
            assert abs(float(tloss) - float(jloss)) <= TOL, t
    for path, p in TH._leaves(tp):
        np.testing.assert_allclose(p.numpy(), np.asarray(TH._at(jp, path)),
                                   atol=TOL, rtol=0, err_msg=str(path))


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_fused_ffn_runs_once_a_block_under_remat(policy):
    """Under remat, either policy, the recompute in the backward does not
    run the FFN again: L bodies of the fused-FFN op a step (the reference's
    recomputed ``pallas_call`` has no reader and XLA drops it).  The loss
    and gradients still match ``jax.value_and_grad`` of the reference's
    ``loss_fn`` (loss within 1e-5 relative, gradients 1e-5), and three
    steps match ``gpt_hybrid.make_train_step``."""
    jcfg, tcfg = _cfgs(remat_policy=policy)
    L = tcfg.num_layers
    tree = numpy_params(jcfg, 0)
    toks, labels = _tokens(4)
    tt, tl = torch.from_numpy(toks), torch.from_numpy(labels)
    with fused_backward():
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p, t, lab: J.loss_fn(p, t, lab, jcfg)))(
                jax.tree_util.tree_map(jnp.asarray, tree),
                jnp.asarray(toks), jnp.asarray(labels))
        before = TFF.bodies
        loss, grads = TH.loss_and_grads(T.params_from_numpy(tree, CPU), tt,
                                        tl, tcfg)
        assert TFF.bodies - before == L
        assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss))
        for path, g in TH._leaves(grads):
            np.testing.assert_allclose(g.numpy(),
                                       np.asarray(TH._at(jgrads, path)),
                                       atol=TOL, rtol=0, err_msg=str(path))
        jstep = _jax_step(jcfg, eps=1e-6)
        jp = jax.tree_util.tree_map(jnp.asarray, tree)
        jm = jax.tree_util.tree_map(jnp.zeros_like, jp)
        jv = jax.tree_util.tree_map(jnp.zeros_like, jp)
        tp = T.params_from_numpy(copy.deepcopy(tree), CPU)
        tm, tv = TH.init_train_state(tp)
        tstep = TH.make_train_step(tcfg, eps=1e-6)
        before = TFF.bodies
        for t in (1, 2, 3):
            jp, jm, jv, jloss = jstep(jp, jm, jv, jnp.int32(t),
                                      jnp.asarray(toks), jnp.asarray(labels),
                                      jnp.float32(1e-4))
            tloss = tstep(tp, tm, tv, t, tt, tl, 1e-4)[3]
            assert abs(float(tloss) - float(jloss)) <= TOL, t
        assert TFF.bodies - before == 3 * L
    for path, p in TH._leaves(tp):
        np.testing.assert_allclose(p.numpy(), np.asarray(TH._at(jp, path)),
                                   atol=TOL, rtol=0, err_msg=str(path))


def _bf16_step(w):
    """The spacing of bf16 numbers at |w| (normal range)."""
    e = np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -126)))
    return 2.0 ** (e - 7)


LR = 1e-4
NOISE_SHARE = 1e-3


def _to_torch_bf16(tree):
    """A JAX bf16 tree as the port's bf16 tensors (exact: every value is a
    bf16 number)."""
    return T.params_from_numpy(
        jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)),
                               tree), CPU, dtype=torch.bfloat16)


def test_fused_slice_bf16_storage_three_steps_match_reference():
    """fp32 compute over bf16 params and bf16 moments, the reference
    bench's storage.  Three steps, each taken by both packages from the
    same state (the reference's after the step before): the loss equals the
    reference's ``gpt.loss_fn`` on that state, every param leaf is within
    one bf16 step of the JAX step's value, and params and moments stay
    bf16.

    Except for a few elements: AdamW's first steps move an element by about
    lr whatever the size of its gradient, so an element whose gradient sits
    at the rounding level of the bf16 gradient sums can step the other way.
    The reference's own hybrid step and its ``gpt.loss_fn`` disagree on
    such gradients (the port's equal ``gpt.loss_fn``'s).  At most a share
    NOISE_SHARE of all param elements may lie past one bf16 step, and none
    past one bf16 step plus 2 lr.

    At lr 1e-4 one update is about one bf16 step of these weights, so this
    test checks the bf16 storage and rounding, not the update's size: an
    update scaled wrongly by 2 could pass here.  The fp32 three-step test
    above, at 1e-5, is the check on the update.  A larger lr does not make
    this one stronger: the bf16 gradients' rounding moves each update by a
    share of lr, and at lr 1e-3 0.3% of the elements lie past one step."""
    jcfg, tcfg = _cfgs(param_dtype="bfloat16")
    tree = numpy_params(jcfg, 0)
    toks, labels = _tokens(8)
    with fused_backward():
        jstep = _jax_step(jcfg)
        jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                    tree)
        jm = jax.tree_util.tree_map(jnp.zeros_like, jp)
        jv = jax.tree_util.tree_map(jnp.zeros_like, jp)
        tstep = TH.make_train_step(tcfg)
        tt, tl = torch.from_numpy(toks), torch.from_numpy(labels)
        for t in (1, 2, 3):
            tp, tm, tv = (_to_torch_bf16(a) for a in (jp, jm, jv))
            # the loss against the reference's gpt.loss_fn on the same
            # params: its hybrid step's own loss on bf16 params differs
            # from that by up to 2.6e-5 of the loss here
            jloss = J.loss_fn(jp, jnp.asarray(toks), jnp.asarray(labels),
                              jcfg)
            tloss = tstep(tp, tm, tv, t, tt, tl, LR)[3]
            assert abs(float(tloss) - float(jloss)) <= TOL, t
            jp, jm, jv, _ = jstep(jp, jm, jv, jnp.int32(t),
                                  jnp.asarray(toks), jnp.asarray(labels),
                                  jnp.float32(LR))
            past = total = 0
            for path, p in TH._leaves(tp):
                w = np.asarray(TH._at(jp, path).astype(jnp.float32))
                assert p.dtype == torch.bfloat16
                assert TH._at(tm, path).dtype == torch.bfloat16
                assert TH._at(tv, path).dtype == torch.bfloat16
                err = np.abs(p.float().numpy() - w)
                step = _bf16_step(w)
                assert np.all(err <= step + 2 * LR), (t, path)
                past += int((err > step).sum())
                total += err.size
            assert past <= NOISE_SHARE * total, (t, past, total)


# --------------------------------------------------------------------------
# the serving engine with use_fused_ffn
# --------------------------------------------------------------------------

def test_engine_with_fused_ffn_token_exact():
    kw = dict(vocab_size=256, hidden_size=32, num_layers=2, num_heads=2,
              max_seq_len=64, dtype="float32", use_flash=False, remat=False,
              use_pallas_norm=True, use_fused_ffn=True)
    jcfg, tcfg = J.GPTConfig(**kw), T.GPTConfig(**kw)
    tree = numpy_params(jcfg, 0)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    eng = S.PagedServingEngine((T.params_from_numpy(tree, CPU), tcfg),
                               device=CPU, slots=2, max_len=32, page_size=8,
                               seq_buckets=(8, 16), batch_buckets=(1, 2))
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, 256, n).astype(np.int32) for n in (5, 11, 7)]
    before = TFF.launches
    reqs = [eng.submit(p, 6) for p in prompts]
    eng.run()
    assert TFF.launches == before
    for p, r in zip(prompts, reqs):
        want = np.asarray(J.generate(jp, jcfg, jnp.asarray(p[None]), 6))
        assert r.tokens == want[0, len(p):].tolist()
