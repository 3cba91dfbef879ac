"""The port's ``quantization`` (fake quantization with its straight-through
gradient, the calibrated int8 product, ``QAT`` wrap / train / convert,
``QuantedLinear``, ``PostTrainingQuantization`` and its ``torch.export``
artifact) against the JAX package on the CPU, on the same numpy weights
and inputs.  The int8 products are exact integers on both sides.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as pt
from paddle_tpu import quantization as RQ
from paddle_tpu_torch import quantization as Q
from paddle_tpu_torch.framework import core

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    prev = core._state.expected_place
    pt.set_device("cpu")
    yield
    core._state.expected_place = prev


def _np(t):
    return np.asarray(t.numpy())


# -- the functional core (mirrors tests/test_quantization.py) -----------------

def test_fake_quantize_roundtrip_error_bounded():
    rng = np.random.RandomState(0)
    xa = rng.randn(64, 32).astype(np.float32)
    x = pt.to_tensor(xa)
    scale = pt.to_tensor(Q.quant_absmax_scale(x.value))
    y = Q.fake_quantize(x, scale)
    err = np.abs(y.numpy() - x.numpy()).max()
    assert err <= float(scale.numpy()) / 2 + 1e-7
    np.testing.assert_allclose(Q.fake_quantize(y, scale).numpy(),
                               y.numpy(), atol=1e-7)
    ref = RQ.fake_quantize(P.to_tensor(xa),
                           P.to_tensor(RQ.quant_absmax_scale(xa)))
    np.testing.assert_array_equal(y.numpy(), _np(ref))


def test_fake_quantize_ste_gradient_matches_reference():
    """The gradient passes inside the clip range and is 0 outside; the
    scale gets zero, as the reference's custom_vjp."""
    grads = []
    for lib, mod in ((pt, Q), (P, RQ)):
        x = lib.to_tensor(np.array([0.1, -0.4, 5.0, 0.5], np.float32),
                          stop_gradient=False)
        scale = lib.to_tensor(np.float32(0.5 / 127), stop_gradient=False)
        y = (mod.fake_quantize(x, scale) * lib.to_tensor(
            np.array([1.0, 2.0, 3.0, 4.0], np.float32))).sum()
        y.backward()
        g = _np(x.grad)
        sg = scale.grad
        grads.append((g, 0.0 if sg is None else float(_np(sg))))
    (g, sg), (rg, rsg) = grads
    np.testing.assert_array_equal(g, [1.0, 2.0, 0.0, 4.0])
    np.testing.assert_array_equal(g, rg)
    assert sg == rsg == 0.0


def test_fake_quantize_promotes_as_the_reference():
    """A bf16 x over an fp32 scale quantizes in fp32 (jnp promotes two
    arrays; torch would keep a 0-d scale's bf16)."""
    rng = np.random.RandomState(4)
    xa = rng.randn(8, 16).astype(np.float32)
    x = pt.to_tensor(xa).astype("bfloat16")
    s = pt.to_tensor(np.float32(0.013))
    y = Q.fake_quantize(x, s)
    r = RQ.fake_quantize(P.to_tensor(xa).astype("bfloat16"),
                         P.to_tensor(np.float32(0.013)))
    assert y.dtype == pt.float32 and str(r.dtype) == "float32"
    np.testing.assert_array_equal(y.numpy(), _np(r))


def test_int8_matmul_matches_reference():
    rng = np.random.RandomState(1)
    x = rng.randn(16, 64).astype(np.float32)
    w = rng.randn(64, 32).astype(np.float32) * 0.1
    ws = Q.quant_absmax_scale(torch.from_numpy(w), axis=1)
    w_int8 = torch.clamp(torch.round(torch.from_numpy(w) / ws[None, :]),
                         -127, 127).to(torch.int8)
    xs = np.float32(np.abs(x).max() / 127)
    out = Q.int8_matmul(pt.to_tensor(x), pt.to_tensor(w_int8),
                        pt.to_tensor(xs), pt.to_tensor(ws))
    want = x @ w
    rel = np.abs(out.numpy() - want) / (np.abs(want).max() + 1e-6)
    assert rel.max() < 0.03, rel.max()
    import jax.numpy as jnp
    ref = RQ.int8_matmul(P.to_tensor(x),
                         P.to_tensor(jnp.asarray(w_int8.numpy())),
                         P.to_tensor(xs), P.to_tensor(ws.numpy()))
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("M,K,N", [(3, 13, 2), (17, 768, 2), (40, 256, 59),
                                   (5, 8, 8), (64, 30, 1000)])
def test_padded_int8_product_is_exact(M, K, N):
    """The padding the card's ``torch._int_mm`` needs (M to 32 under 17
    rows, K and N to multiples of 8) changes no result: the padded product
    sliced back equals the product, integer for integer."""
    g = torch.Generator().manual_seed(M * K + N)
    a = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8)
    got = Q._padded_int_mm(a, b)
    assert got.shape == (M, N) and got.dtype == torch.int32
    want = a.to(torch.int64) @ b.to(torch.int64)
    assert torch.equal(got.to(torch.int64), want)


def test_observer_is_a_device_scalar_ema():
    obs = Q.AbsmaxObserver(momentum=0.9)
    ref = RQ.AbsmaxObserver(momentum=0.9)
    rng = np.random.RandomState(5)
    for _ in range(3):
        x = rng.randn(4, 8).astype(np.float32)
        s = obs.observe(torch.from_numpy(x).requires_grad_())
        r = ref.observe(x)
    assert isinstance(s, torch.Tensor) and s.dim() == 0
    assert not s.requires_grad
    np.testing.assert_allclose(float(s), float(r), rtol=1e-6)


# -- QAT ---------------------------------------------------------------------

def _mlp(lib):
    return lib.nn.Sequential(lib.nn.Linear(8, 16), lib.nn.ReLU(),
                             lib.nn.Linear(16, 4))


def _weights(net, seed):
    rng = np.random.RandomState(seed)
    return {k: (0.5 * rng.randn(*v.shape)).astype(np.float32)
            for k, v in net.state_dict().items()}


def test_qat_wrap_train_convert():
    pt.seed(0)
    rng = np.random.RandomState(2)
    net = _mlp(pt)
    qat = Q.QAT(Q.QuantConfig())
    qat.quantize(net)
    assert isinstance(net[0], Q._QATWrapper)
    x = rng.randn(32, 8).astype(np.float32)
    y = x @ rng.randn(8, 4).astype(np.float32)
    opt = pt.optimizer.Adam(learning_rate=1e-2, parameters=net.parameters())
    losses = []
    for _ in range(60):
        out = net(pt.to_tensor(x))
        loss = ((out - pt.to_tensor(y)) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.2, (losses[0], losses[-1])
    float_out = net(pt.to_tensor(x)).numpy()
    qat.convert(net)
    assert isinstance(net[0], Q.QuantedLinear)
    assert net[0].w_int8.dtype == torch.int8
    q_out = net(pt.to_tensor(x)).numpy()
    rel = np.abs(q_out - float_out).max() / (np.abs(float_out).max() + 1e-6)
    assert rel < 0.1, rel


def _qat_run(lib, mod, weights, x, y, steps):
    net = _mlp(lib)
    net.set_state_dict(weights)
    qat = mod.QAT(mod.QuantConfig())
    qat.quantize(net)
    keys = [list(net.state_dict())]
    opt = lib.optimizer.Adam(learning_rate=1e-2, parameters=net.parameters())
    losses = []
    for _ in range(steps):
        loss = ((net(lib.to_tensor(x)) - lib.to_tensor(y)) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    keys.append(list(net.state_dict()))
    keys.append([tuple(p.shape) for p in net.parameters()])
    params = {k: _np(v) for k, v in net.state_dict().items()}
    scales = [float(np.asarray(net[i]._obs.scale)) for i in (0, 2)]
    qat.convert(net)
    out = _np(net(lib.to_tensor(x)))
    return losses, params, keys, scales, out


def test_qat_three_steps_match_reference():
    """Three QAT steps (Adam) on the same numpy weights: losses within
    1e-5 relative, every parameter within 1e-5 of its leaf's max, the
    observers' scales within 1e-5; ``state_dict`` keys and
    ``parameters()`` in the reference's order before and after a step
    (the weight swap re-registers ``weight`` after ``bias`` in both);
    the converted int8 outputs within 1e-5 of max|ref|."""
    rng = np.random.RandomState(6)
    x = rng.randn(16, 8).astype(np.float32)
    y = rng.randn(16, 4).astype(np.float32)
    weights = _weights(_mlp(pt), 7)
    got = _qat_run(pt, Q, weights, x, y, 3)
    want = _qat_run(P, RQ, weights, x, y, 3)
    (lg, pg, kg, sg, og), (lw, pw, kw, sw, ow) = got, want
    np.testing.assert_allclose(lg, lw, rtol=TOL)
    assert lg[-1] < lg[0]
    assert kg == kw
    assert kg[0] != kg[1]           # the reference's reorder, kept
    for k, w in pw.items():
        np.testing.assert_allclose(pg[k], w, rtol=0,
                                   atol=TOL * np.abs(w).max())
    np.testing.assert_allclose(sg, sw, rtol=TOL)
    np.testing.assert_allclose(og, ow, rtol=0, atol=TOL * np.abs(ow).max())


def test_qat_conv2d_matches_reference():
    """A Conv2D is wrapped with per-output-channel weight scales on axis
    0; one step's loss and gradients, and ``convert``'s baked
    fake-quantised weights, equal the reference's."""
    rng = np.random.RandomState(8)
    x = rng.randn(2, 3, 6, 6).astype(np.float32)
    res = []
    for lib, mod in ((pt, Q), (P, RQ)):
        net = lib.nn.Sequential(lib.nn.Conv2D(3, 4, 3), lib.nn.ReLU(),
                                lib.nn.Flatten(), lib.nn.Linear(64, 2))
        net.set_state_dict({k: (0.3 * np.random.RandomState(9).randn(
            *v.shape)).astype(np.float32) for k, v in
            net.state_dict().items()})
        qat = mod.QAT()
        qat.quantize(net)
        loss = (net(lib.to_tensor(x)) ** 2).mean()
        loss.backward()
        grads = [_np(p.grad) for p in net.parameters()]
        qat.convert(net)
        res.append((float(loss), grads, _np(net[0].weight),
                    _np(net(lib.to_tensor(x)))))
    (lg, gg, wg, og), (lw, gw, ww, ow) = res
    np.testing.assert_allclose(lg, lw, rtol=TOL)
    for g, w in zip(gg, gw):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL * np.abs(w).max())
    np.testing.assert_allclose(wg, ww, rtol=0, atol=1e-7)
    np.testing.assert_allclose(og, ow, rtol=0, atol=TOL * np.abs(ow).max())


def test_convert_before_calibration_raises():
    net = _mlp(pt)
    qat = Q.QAT()
    qat.quantize(net)
    with pytest.raises(ValueError, match="calibration"):
        qat.convert(net)


# -- post-training quantization ----------------------------------------------

def _ptq(lib, mod, weights, x):
    net = lib.nn.Sequential(lib.nn.Linear(6, 12), lib.nn.Tanh(),
                            lib.nn.Linear(12, 3))
    net.set_state_dict(weights)
    ref = _np(net(lib.to_tensor(x)))
    ptq = mod.PostTrainingQuantization(net, mod.QuantConfig())
    qnet = ptq.quantize([lib.to_tensor(x[i:i + 8]) for i in range(0, 40, 8)])
    layers = [(np.asarray(qnet[i].w_int8), np.asarray(qnet[i].w_scale),
               float(qnet[i].a_scale)) for i in (0, 2)]
    return ref, _np(qnet(lib.to_tensor(x))), layers


def test_post_training_quantization_matches_reference():
    """PTQ's calibrated activation scales, int8 weights and weight scales
    equal the reference's (int8 weights exactly, scales within 1e-6),
    and the int8 outputs agree within 1e-5 of max|ref|, both within 0.1 of
    the float model as the reference test asks."""
    rng = np.random.RandomState(3)
    x = rng.randn(40, 6).astype(np.float32)
    net = pt.nn.Sequential(pt.nn.Linear(6, 12), pt.nn.Tanh(),
                           pt.nn.Linear(12, 3))
    weights = {k: (0.4 * rng.randn(*v.shape)).astype(np.float32)
               for k, v in net.state_dict().items()}
    (fg, qg, lg), (fw, qw, lw) = (_ptq(pt, Q, weights, x),
                                  _ptq(P, RQ, weights, x))
    for (wi, ws, a), (rwi, rws, ra) in zip(lg, lw):
        assert wi.dtype == np.int8
        np.testing.assert_array_equal(wi, rwi)
        np.testing.assert_allclose(ws, rws, rtol=1e-6)
        np.testing.assert_allclose(a, ra, rtol=1e-6)
    np.testing.assert_allclose(qg, qw, rtol=0, atol=TOL * np.abs(qw).max())
    for f, q in ((fg, qg), (fw, qw)):
        assert np.abs(q - f).max() / (np.abs(f).max() + 1e-6) < 0.1


def test_ptq_save_quantized_model_serves_through_the_predictor(tmp_path):
    """``save_quantized_model`` writes the port's ``torch.export`` artifact
    (the reference's is StableHLO); a Predictor made from it on the CPU
    gives the in-process int8 model's outputs."""
    from paddle_tpu_torch.inference import Config, create_predictor
    pt.seed(0)
    net = pt.nn.Sequential(pt.nn.Linear(4, 12), pt.nn.ReLU(),
                           pt.nn.Linear(12, 2))
    ptq = Q.PostTrainingQuantization(net)
    x = np.random.RandomState(10).randn(3, 4).astype(np.float32)
    ptq.quantize([pt.to_tensor(x)])
    meta = ptq.save_quantized_model(str(tmp_path / "q"),
                                    input_spec=[((3, 4), "float32")])
    assert meta["format"] == "torch.export"
    want = net(pt.to_tensor(x)).numpy()
    cfg = Config(str(tmp_path / "q"))
    cfg.disable_gpu()
    pred = create_predictor(cfg)
    h = pred.get_input_handle(pred.get_input_names()[0])
    h.copy_from_cpu(x)
    pred.run()
    got = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        ptq.save_quantized_model(str(tmp_path / "r"))
