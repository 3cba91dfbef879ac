"""The port's activations (``nn.functional`` and their layers) against the
JAX package's, on the CPU.

Inputs come from a numpy ``RandomState`` seeded by the case's name; the
outputs must have the reference's shapes and dtypes and agree within
1e-5 of max|ref|, and the gradient of sum(out * w) within 1e-5 of
max|ref grad|, against ``paddle_tpu.grad`` (the reference's cases
batched as ``tests/op_reference.py`` runs them).  The layers carry the
reference's parameters (``PReLU``) through ``set_state_dict``.  The
noisy ops (``rrelu`` in training, ``gumbel_softmax``) are held in their
evaluation form and in their distributions.  The coverage guards hold
every function and layer of the reference's activation files against
the port.
"""
import inspect

import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu_torch as pt
from paddle_tpu.nn.functional import activation as r_act
from paddle_tpu.nn.layer import activation as r_act_layers
from paddle_tpu_torch.framework import core
from tools.op_sweep import (ACT_CASES, TOL, R, _seed, arrays, check,
                            check_grads, flat, grads, run)

import op_reference


@pytest.fixture(autouse=True)
def _cpu():
    prev = core._state.expected_place
    pt.set_device("cpu")
    yield
    core._state.expected_place = prev


def _x(name, shape, scale=3.0):
    return (R(_seed(name)).standard_normal(shape) * scale).astype(np.float32)


_act_reference = op_reference.lazy(ACT_CASES)


@pytest.mark.parametrize("case", ACT_CASES, ids=[c.name for c in ACT_CASES])
def test_activation_matches_reference(case):
    arr = arrays(case)
    ref, ref_g = _act_reference(case)
    _, got = run(pt, case, arr)
    check(ref, flat(got), case.tol, case.name)
    check_grads(ref_g, grads(pt, case, arr), case.tol, case.name)


LAYERS = [
    ("ReLU", ()), ("ReLU6", ()), ("Sigmoid", ()), ("Tanh", ()),
    ("Silu", ()), ("Swish", ()), ("Mish", ()), ("Hardswish", ()),
    ("LogSigmoid", ()), ("Softsign", ()), ("Tanhshrink", ()), ("GLU", ()),
    ("ELU", (0.4,)), ("SELU", ()), ("GELU", (True,)), ("LeakyReLU", (0.3,)),
    ("PReLU", (6, 0.2)), ("RReLU", ()), ("Hardshrink", (0.8,)),
    ("Hardsigmoid", ()), ("Hardtanh", (-0.5, 0.5)), ("Softplus", (1.5,)),
    ("Softshrink", (0.2,)), ("ThresholdedReLU", (0.9,)), ("Maxout", (3, 1)),
    ("Softmax", (1,)), ("LogSoftmax", (0,)),
]


@pytest.mark.parametrize("name,args", LAYERS, ids=[a[0] for a in LAYERS])
def test_activation_layer_matches_reference(name, args):
    arr = _x(name, (2, 6, 4, 6))
    ref = getattr(P.nn, name)(*args)
    net = getattr(pt.nn, name)(*args)
    ref.eval()
    net.eval()
    if ref.state_dict():
        w = R(_seed(name) + 3).uniform(0.1, 0.5, ref.weight.shape)
        ref.set_state_dict({"weight": w.astype(np.float32)})
        net.set_state_dict({"weight": w.astype(np.float32)})
    r = np.asarray(ref(P.to_tensor(arr)).numpy())
    g = net(pt.to_tensor(arr)).numpy()
    assert g.shape == r.shape
    np.testing.assert_allclose(g, r, rtol=0, atol=TOL * np.abs(r).max())


def test_prelu_default_weight():
    for mod in (P, pt):
        layer = mod.nn.PReLU(3, 0.25)
        np.testing.assert_allclose(layer.weight.numpy(), [0.25] * 3)


def test_rrelu_training_draws_slopes_in_range():
    arr = -np.ones((200, 100), np.float32)
    pt.seed(1)
    out = pt.nn.functional.rrelu(pt.to_tensor(arr), 0.1, 0.3,
                                 training=True).numpy()
    slopes = -out
    assert slopes.min() >= 0.1 and slopes.max() <= 0.3
    assert abs(slopes.mean() - 0.2) < 5 * np.sqrt((0.2 ** 2 / 12) / 20000)
    layer = pt.nn.RReLU(0.1, 0.3)
    layer.train()
    assert not np.allclose(layer(pt.to_tensor(arr)).numpy(), -0.2)
    layer.eval()
    np.testing.assert_allclose(layer(pt.to_tensor(arr)).numpy(), -0.2,
                               rtol=1e-6)


def test_gumbel_softmax_distribution():
    logits = np.log(np.array([[0.1, 0.2, 0.7]], np.float32)).repeat(4000, 0)
    pt.seed(2)
    F = pt.nn.functional
    x = pt.to_tensor(logits, stop_gradient=False)
    soft = F.gumbel_softmax(x, 1.0)
    np.testing.assert_allclose(soft.numpy().sum(-1), 1.0, rtol=1e-5)
    hard = F.gumbel_softmax(x, 0.5, hard=True)
    h = hard.numpy()
    assert set(np.unique(h)) == {0.0, 1.0}
    np.testing.assert_array_equal(h.sum(-1), 1.0)
    freq = h.mean(0)
    # the argmax of logits + Gumbel noise is a draw from softmax(logits)
    assert np.abs(freq - [0.1, 0.2, 0.7]).max() < 0.03, freq
    # the hard form carries the soft gradient
    g = pt.grad([pt.sum(hard * pt.to_tensor(np.arange(3, dtype=np.float32)))],
                [x])[0].numpy()
    assert np.abs(g).sum() > 0
    ref = P.nn.functional.gumbel_softmax(P.to_tensor(logits[:5]), 1.0)
    assert list(ref.shape) == soft[:5].shape
    assert str(ref.dtype) == str(soft.dtype).replace("torch.", "")


# names the reference's modules import rather than define
_IMPORTED = {"call", "Layer", "Constant", "XavierUniform", "Tensor"}


def _public(mod, classes):
    return sorted(n for n, v in vars(mod).items()
                  if not n.startswith("_") and n not in _IMPORTED
                  and inspect.isclass(v) == classes
                  and callable(v)
                  and getattr(v, "__module__", "").startswith("paddle_tpu.")
                  and not (classes and not issubclass(v, P.nn.Layer)))


def test_every_reference_activation_is_ported():
    funcs = _public(r_act, False)
    missing = [n for n in funcs if not callable(
        getattr(pt.nn.functional, n, None))]
    assert not missing, missing
    assert len(funcs) >= 31
    # gumbel_softmax draws: held in its distribution above
    held = {c.name.split(":")[0] for c in ACT_CASES} | {"gumbel_softmax"}
    assert not [n for n in funcs if n not in held]


def test_every_reference_activation_layer_is_ported():
    layers = _public(r_act_layers, True)
    missing = [n for n in layers if not hasattr(pt.nn, n)]
    assert not missing, missing
    assert len(layers) >= 27
    assert not [n for n in layers if n not in {a[0] for a in LAYERS}]
