"""The port's training path against the JAX package, on the CPU.

``paddle_tpu_torch.models.gpt.loss_fn`` and its gradients against
``jax.value_and_grad`` of ``paddle_tpu.models.gpt.loss_fn``; the port's
``adamw_update`` against the reference's; three steps of the port's
``gpt_hybrid.make_train_step`` against the reference's on a one-device
mesh.  Weights are numpy-drawn in the JAX layout (``numpy_params``) on the
wide config of ``tests/test_torch_gpt.py`` (H=128, nh=2, hd=64, L=2) in
float32.  Tolerances: 1e-5 absolute on losses, gradients and parameters
(fp32 sums in another order); 2**-6 relative on a bf16 loss.
"""
import collections
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import gpt as J
from paddle_tpu.models import gpt_hybrid as JH
from paddle_tpu.optimizer import functional as JF
from paddle_tpu.parallel.mesh import create_mesh
from paddle_tpu_torch.models import gpt as T
from paddle_tpu_torch.models import gpt_hybrid as TH
from paddle_tpu_torch.ops.cuda import flash_attn, fused_ffn, norms
from paddle_tpu_torch.optimizer import functional as TF
from torch.utils._python_dispatch import TorchDispatchMode
from test_torch_gpt import _wide_cfg, numpy_params

TOL = 1e-5
BF16_RTOL = 2.0 ** -6
CPU = "cpu"


def _cfgs(**kw):
    return (dataclasses.replace(_wide_cfg(J), **kw),
            dataclasses.replace(_wide_cfg(T), **kw))


def _tokens(seed, V=256, B=2, N=16):
    t = np.random.default_rng(seed).integers(0, V, (B, N)).astype(np.int32)
    labels = t.copy()
    labels[0, -3:] = -100                       # ignored positions
    return t, labels


REMAT = {"off": dict(remat=False), "full": dict(remat=True),
         "dots": dict(remat=True, remat_policy="dots")}


@pytest.mark.parametrize("remat", sorted(REMAT))
@pytest.mark.parametrize("pallas_norm", [True, False],
                         ids=["kernel_norm", "plain_norm"])
@pytest.mark.parametrize("flash", [True, False], ids=["flash", "dense"])
def test_loss_and_grads_match_reference(flash, pallas_norm, remat):
    jcfg, tcfg = _cfgs(use_flash=flash, use_pallas_norm=pallas_norm,
                       **REMAT[remat])
    tree = numpy_params(jcfg, 0)
    toks, labels = _tokens(1)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, t, lab: J.loss_fn(p, t, lab, jcfg)))(
            jp, jnp.asarray(toks), jnp.asarray(labels))
    leaves = {path: p.requires_grad_() for path, p in
              TH._leaves(T.params_from_numpy(tree, CPU))}
    params = TH._build(list(leaves), list(leaves.values()))
    loss = T.loss_fn(params, torch.from_numpy(toks),
                     torch.from_numpy(labels), tcfg)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert abs(float(loss.detach()) - float(jloss)) <= TOL
    for path, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(TH._at(jgrads, path)),
                                   atol=TOL, rtol=0, err_msg=str(path))


@pytest.mark.parametrize("decay", [True, False])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(decay, moments):
    rng = np.random.default_rng(2)
    p, g, m, v = (rng.standard_normal((64, 32)).astype(np.float32)
                  for _ in range(4))
    v = np.abs(v)
    jm, jv = (jnp.asarray(a, moments) for a in (m, v))
    want = JF.adamw_update(jnp.asarray(p), jnp.asarray(g), jm, jv, 1e-3,
                           jnp.float32(3), 0.9, 0.95, 1e-8, 0.1, decay)
    tdt = T.torch_dtype(moments)
    got = TF.adamw_update(torch.from_numpy(p), torch.from_numpy(g),
                          torch.from_numpy(m).to(tdt),
                          torch.from_numpy(v).to(tdt), 1e-3,
                          torch.tensor(3), 0.9, 0.95, 1e-8, 0.1, decay)
    assert got[1].dtype == got[2].dtype == tdt
    tol = TOL if moments == "float32" else 2.0 ** -8
    for name, a, b in zip(("p", "m", "v"), got, want):
        np.testing.assert_allclose(
            a.float().numpy(), np.asarray(b.astype(jnp.float32)),
            atol=TOL, rtol=tol if name != "p" else 0, err_msg=name)


@pytest.mark.parametrize("xent_chunks", [1, 2])
def test_three_train_steps_match_reference(xent_chunks):
    """Per-step loss and the params after 3 steps.  Adam's eps is 1e-6 on
    both sides: with 1e-8 the update of a weight whose gradient is ~1e-7
    (a few of 2^15 per matrix) is a ratio of rounding noise, which the two
    frameworks' fp32 sums do not share."""
    jcfg, tcfg = _cfgs(use_flash=True, remat=True)
    tree = numpy_params(jcfg, 0)
    toks, labels = _tokens(3)
    kw = dict(eps=1e-6, xent_chunks=xent_chunks)
    jstep = JH.make_train_step(
        jcfg, create_mesh(dp=1, tp=1, pp=1, sp=1,
                          devices=[jax.devices()[0]]), **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jm = jax.tree_util.tree_map(jnp.zeros_like, jp)
    jv = jax.tree_util.tree_map(jnp.zeros_like, jp)
    tp = T.params_from_numpy(copy.deepcopy(tree), CPU)
    tm, tv = TH.init_train_state(tp)
    tstep = TH.make_train_step(tcfg, **kw)
    tt, tl = torch.from_numpy(toks), torch.from_numpy(labels)
    for t in (1, 2, 3):
        jp, jm, jv, jloss = jstep(jp, jm, jv, jnp.int32(t),
                                  jnp.asarray(toks), jnp.asarray(labels),
                                  jnp.float32(1e-4))
        out = tstep(tp, tm, tv, t, tt, tl, 1e-4)
        assert out[0] is tp and out[1] is tm and out[2] is tv  # in place
        assert out[3].dim() == 0
        assert abs(float(out[3]) - float(jloss)) <= TOL, t
    for path, p in TH._leaves(tp):
        np.testing.assert_allclose(p.numpy(), np.asarray(TH._at(jp, path)),
                                   atol=TOL, rtol=0, err_msg=str(path))
    assert float(out[3]) < float(TH.loss_and_grads(
        T.params_from_numpy(tree, CPU), tt, tl, tcfg)[0])


def test_bf16_loss_matches_reference():
    jcfg, tcfg = _cfgs(use_flash=True, remat=True, dtype="bfloat16")
    tree = numpy_params(jcfg, 0)
    toks, labels = _tokens(4)
    want = J.loss_fn(jax.tree_util.tree_map(jnp.asarray, tree),
                     jnp.asarray(toks), jnp.asarray(labels), jcfg)
    got = T.loss_fn(T.params_from_numpy(tree, CPU), torch.from_numpy(toks),
                    torch.from_numpy(labels), tcfg)
    assert abs(float(got) - float(want)) <= BF16_RTOL * abs(float(want))


def test_train_state_and_refusals():
    _, tcfg = _cfgs()
    params = T.params_from_numpy(numpy_params(tcfg, 0), CPU)
    m, v = TH.init_train_state(params, moment_dtype=torch.bfloat16)
    for (path, p), (_, mm) in zip(TH._leaves(params), TH._leaves(m)):
        assert mm.shape == p.shape and mm.dtype == torch.bfloat16
        assert not mm.any()
    for kw in ({"dp": 2}, {"tp": 2}, {"pp": 4}, {"sp": 2},
               {"n_microbatch": 2}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TH.make_train_step(tcfg, **kw)
    # the fused routes of the reference bench's recipe are taken, not
    # refused: the flag is set and cleared, use_fused_ffn builds a step
    try:
        flash_attn.set_default_blocks(bwd_fused=True)
        assert flash_attn._BWD_FUSED
        _, fcfg = _cfgs(use_fused_ffn=True)
        assert callable(TH.make_train_step(fcfg))
    finally:
        flash_attn.set_default_blocks(bwd_fused=False)
    assert not flash_attn._BWD_FUSED


@pytest.mark.parametrize("bwd_fused", [False, True],
                         ids=["split_bwd", "fused_bwd"])
def test_cpu_train_step_launches_no_kernel(bwd_fused):
    _, tcfg = _cfgs(use_flash=True, use_pallas_norm=True, remat=True,
                    use_fused_ffn=bwd_fused)
    params = T.params_from_numpy(numpy_params(tcfg, 0), CPU)
    m, v = TH.init_train_state(params)
    toks, labels = (torch.from_numpy(a) for a in _tokens(5))

    def counts():
        return (flash_attn.fwd_launches, flash_attn.dq_launches,
                flash_attn.dkv_launches, flash_attn.fused_launches,
                fused_ffn.launches, norms.launches)
    before = counts()
    try:
        flash_attn.set_default_blocks(bwd_fused=bwd_fused)
        TH.make_train_step(tcfg)(params, m, v, 1, toks, labels, 1e-4)
    finally:
        flash_attn.set_default_blocks(bwd_fused=False)
    assert counts() == before


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] += 1
        return func(*args, **(kwargs or {}))


def test_remat_policies_recompute_what_they_should():
    """The backward of ``remat_policy="dots"`` runs the weight matmuls
    (``aten.mm``) no more often than no remat at all, since their outputs
    are saved; ``"full"`` recomputes them."""
    _, tcfg = _cfgs(use_flash=True)
    tree = numpy_params(tcfg, 0)
    toks = torch.from_numpy(_tokens(6)[0])
    mm = {}
    for name, kw in REMAT.items():
        paths, vals = zip(*TH._leaves(T.params_from_numpy(tree, CPU)))
        leaves = [p.requires_grad_() for p in vals]
        params = TH._build(paths, leaves)
        loss = T.loss_fn(params, toks, toks,
                         dataclasses.replace(tcfg, **kw))
        with _CountOps() as count:
            torch.autograd.grad(loss, leaves)
        mm[name] = count.ops[torch.ops.aten.mm.default]
    assert mm["dots"] == mm["off"] < mm["full"]
