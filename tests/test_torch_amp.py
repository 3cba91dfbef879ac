"""The port's AMP (``auto_cast``, ``decorate``, ``GradScaler``) against the
JAX package's, on the CPU.

Counterparts of ``tests/test_jit_static_amp.py``'s AMP tests (the bf16
dtype flow, the scaler stepping and skipping on an inf grad, fp32 master
grads under ``auto_cast``), run on the same numpy inputs in both
packages, plus the list semantics (white, black, neither, custom lists,
nesting), the scaler's counters, ``minimize``, ``unscale_`` before a clip,
its state and ``decorate``.  bf16 results are held at one bf16 rounding
step (2**-7 relative) where both sides round at the same places; fp32 at
1e-6.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.optimizer.optimizers as PO
import paddle_tpu_torch as pt
import paddle_tpu_torch.optimizer as TO
from paddle_tpu_torch.framework import core

BF16_RTOL = 2.0 ** -7
TOL = 1e-6


@pytest.fixture(autouse=True)
def cpu_place():
    prev = core._state.expected_place
    pt.set_device("cpu")
    yield
    core._state.expected_place = prev
    assert core._state.amp_state is None


def _np(t):
    return np.asarray(t.astype("float32").numpy())


def _linear(m, i, o, seed=0):
    lin = m.nn.Linear(i, o)
    rng = np.random.default_rng(seed)
    lin.set_state_dict({"weight": rng.standard_normal((i, o))
                        .astype(np.float32) * 0.5,
                        "bias": rng.standard_normal(o).astype(np.float32)})
    return lin


def _dt(t):
    return str(t.dtype).split(".")[-1]


def test_auto_cast_bf16_dtype_flow():
    x = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    out = {}
    for m in (P, pt):
        lin = _linear(m, 8, 8)
        tx = m.to_tensor(x)
        with m.amp.auto_cast(level="O1", dtype="bfloat16"):
            y = m.matmul(tx, lin.weight)
        assert _dt(y) == "bfloat16"
        assert _dt(lin.weight) == "float32"       # fp32 masters
        y2 = m.matmul(tx, lin.weight)
        assert _dt(y2) == "float32"
        out[m] = (_np(y), _np(y2))
    np.testing.assert_allclose(out[pt][0], out[P][0], rtol=BF16_RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(out[pt][1], out[P][1], rtol=TOL, atol=TOL)


def test_lists_white_black_neither_custom_and_nesting():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 6)).astype(np.float32)
    got = {}
    for m in (P, pt):
        F = m.nn.functional
        xb = m.to_tensor(x).astype("bfloat16")
        xf = m.to_tensor(x)
        w, b = m.to_tensor(np.ones(6, np.float32)), m.to_tensor(
            np.zeros(6, np.float32))
        with m.amp.auto_cast(dtype="bfloat16"):
            ln = F.layer_norm(xb, 6, w, b)            # black: fp32
            s = m.sum(xb)                             # black: fp32
            mu = m.mean(xb)                           # black: fp32
            g = F.gelu(xf)                            # neither: as given
            g2 = F.gelu(xb)
            lin = F.linear(xf, m.to_tensor(np.eye(6, dtype=np.float32)))
            with m.amp.auto_cast(enable=False):
                off = F.linear(xf, m.to_tensor(np.eye(6, dtype=np.float32)))
            after = F.linear(xf, m.to_tensor(np.eye(6, dtype=np.float32)))
        with m.amp.auto_cast(dtype="bfloat16", custom_white_list={"gelu"},
                             custom_black_list={"relu", "linear"}):
            cg = F.gelu(xf)                           # now white
            cl = F.relu(xb)                           # now black
            cw = F.linear(xb, m.to_tensor(np.eye(6, dtype=np.float32)))
        got[m] = [(_dt(t), _np(t)) for t in
                  (ln, s, mu, g, g2, lin, off, after, cg, cl, cw)]
    # the white list is read first: "linear" stays white
    want = ["float32", "float32", "float32", "float32", "bfloat16",
            "bfloat16", "float32", "bfloat16", "bfloat16", "float32",
            "bfloat16"]
    assert [d for d, _ in got[pt]] == want == [d for d, _ in got[P]]
    for (d, a), (_, b) in zip(got[pt], got[P]):
        tol = BF16_RTOL if d == "bfloat16" else 1e-5
        np.testing.assert_allclose(a, b, rtol=tol, atol=1e-5)


def test_auto_cast_backward_keeps_fp32_master_grads():
    x = np.random.RandomState(2).randn(4, 8).astype(np.float32)
    grads = {}
    for m in (P, pt):
        lin = _linear(m, 8, 4, seed=3)
        with m.amp.auto_cast(dtype="bfloat16"):
            y = m.nn.functional.linear(m.to_tensor(x), lin.weight, lin.bias)
            assert _dt(y) == "bfloat16"
            loss = m.sum(y.astype("float32") ** 2)
        loss.backward()
        assert _dt(lin.weight.grad) == "float32"       # not bf16
        assert _dt(lin.bias.grad) == "float32"
        grads[m] = (_np(lin.weight.grad), _np(lin.bias.grad))
        assert np.abs(grads[m][0]).sum() > 0
    for a, b in zip(grads[pt], grads[P]):
        np.testing.assert_allclose(a, b, rtol=2 * BF16_RTOL,
                                   atol=2 * BF16_RTOL * np.abs(b).max())


def test_grad_scaler_steps_and_skips():
    out = {}
    for m, mod in ((P, PO), (pt, TO)):
        lin = _linear(m, 2, 1, seed=4)
        opt = mod.SGD(learning_rate=0.1, parameters=lin.parameters())
        scaler = m.amp.GradScaler(init_loss_scaling=1024.0)
        x = m.to_tensor(np.ones((4, 2), np.float32))
        y = m.to_tensor(np.zeros((4, 1), np.float32))
        w0 = _np(lin.weight)
        loss = m.nn.functional.mse_loss(lin(x), y)
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        w1 = _np(lin.weight)
        assert not np.allclose(w0, w1)          # finite grads: stepped
        inf_loss = m.sum(lin(x)) * m.to_tensor(np.float32(np.inf))
        scaler.scale(inf_loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        w2 = _np(lin.weight)
        np.testing.assert_array_equal(w1, w2)   # skipped
        out[m] = (w1, scaler.state_dict())
    np.testing.assert_allclose(out[pt][0], out[P][0], rtol=TOL)
    assert out[pt][1] == out[P][1]


def test_grad_scaler_counters_match_reference():
    """A sequence of finite and inf steps: the scale, good and bad counts
    follow the reference's (decrease after 2 bad steps, increase after 3
    good ones), and the found-inf flag stays on the device until
    ``step`` reads it."""
    pattern = [1, 1, 1, 0, 0, 1, 0, 1, 1, 1, 1, 0, 0, 0]   # 1: finite
    states = {}
    for m, mod in ((P, PO), (pt, TO)):
        lin = _linear(m, 2, 1, seed=5)
        opt = mod.SGD(learning_rate=0.01, parameters=lin.parameters())
        scaler = m.amp.GradScaler(init_loss_scaling=64.0, incr_every_n_steps=3,
                                  decr_every_n_nan_or_inf=2)
        x = m.to_tensor(np.ones((2, 2), np.float32))
        seq = []
        for ok in pattern:
            k = m.to_tensor(np.float32(1.0 if ok else np.inf))
            scaler.scale(m.sum(lin(x)) * k).backward()
            if m is pt:
                scaler.unscale_(opt)
                assert isinstance(scaler._found_inf, torch.Tensor)
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
            seq.append(dict(scaler.state_dict()))
        states[m] = (seq, _np(lin.weight))
    assert states[pt][0] == states[P][0]
    np.testing.assert_allclose(states[pt][1], states[P][1], rtol=TOL)


def test_unscale_then_clip_unscales_once_and_minimize():
    out = {}
    for m, mod in ((P, PO), (pt, TO)):
        lin = _linear(m, 3, 2, seed=6)
        opt = mod.SGD(learning_rate=0.1, parameters=lin.parameters())
        scaler = m.amp.GradScaler(init_loss_scaling=256.0)
        x = m.to_tensor(np.random.default_rng(7).standard_normal((4, 3))
                        .astype(np.float32))
        scaler.scale(m.sum(lin(x) ** 2)).backward()
        scaler.unscale_(opt)
        g = _np(lin.weight.grad)
        scaler.step(opt)                         # must not unscale again
        scaler.update()
        opt.clear_grad()
        scaler.minimize(opt, scaler.scale(m.sum(lin(x) ** 2)))
        out[m] = (g, _np(lin.weight), scaler.state_dict())
    np.testing.assert_allclose(out[pt][0], out[P][0], rtol=1e-5)
    np.testing.assert_allclose(out[pt][1], out[P][1], rtol=1e-5)
    assert out[pt][2] == out[P][2]


def test_scaler_state_round_trip_and_disabled():
    s = pt.amp.GradScaler(init_loss_scaling=8.0)
    s.load_state_dict({"scale": 2.0, "good_steps": 3, "bad_steps": 1})
    assert s.state_dict() == {"scale": 2.0, "good_steps": 3, "bad_steps": 1}
    assert s.get_init_loss_scaling() == 2.0 and s.is_enable()
    off = pt.amp.GradScaler(enable=False)
    t = pt.to_tensor([1.0])
    assert off.scale(t) is t and off.get_init_loss_scaling() == 1.0


def test_decorate_o2_casts_params():
    for m in (P, pt):
        lin = _linear(m, 4, 4)
        assert m.amp.decorate(lin, level="O1") is lin
        assert _dt(lin.weight) == "float32"
        model, opt = m.amp.decorate(lin, optimizers="opt", level="O2",
                                    dtype="bfloat16")
        assert model is lin and opt == "opt"
        assert _dt(lin.weight) == "bfloat16"
