"""The port's eager tape against the JAX package's, on the CPU.

One counterpart of each test of ``tests/test_autograd.py``: the same
numpy inputs go through ``paddle_tpu`` and ``paddle_tpu_torch``, and the
port's grads (``.grad``, ``autograd.grad``, hooks, ``PyLayer``) must
equal the reference's within 1e-6, and the values the reference's test
asserts.  Also the tape's end-of-backward callbacks and a subprocess
check that the new modules import neither ``jax`` nor ``paddle_tpu``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu_torch as pt
from paddle_tpu_torch.autograd import tape
from paddle_tpu_torch.framework import core

TOL = 1e-6


@pytest.fixture(autouse=True)
def cpu_place():
    prev = core._state.expected_place
    pt.set_device("cpu")
    yield
    core._state.expected_place = prev


def _g(t):
    return np.asarray(t.numpy())


def _close(got, ref, expect=None):
    np.testing.assert_allclose(_g(got), _g(ref), rtol=TOL, atol=TOL)
    if expect is not None:
        np.testing.assert_allclose(_g(got), expect, rtol=TOL, atol=TOL)


def _run_pair(loss_fn, *arrays):
    """``loss_fn(module, *tensors).backward()`` in each package; returns
    the (reference, port) leaves (one pair per array, flattened when
    there is one)."""
    ref = [P.to_tensor(np.asarray(a, np.float32), stop_gradient=False)
           for a in arrays]
    port = [pt.to_tensor(np.asarray(a, np.float32), stop_gradient=False)
            for a in arrays]
    loss_fn(P, *ref).backward()
    loss_fn(pt, *port).backward()
    if len(arrays) == 1:
        return ref[0], port[0]
    return ref, port


def test_simple_chain():
    rx, tx = _run_pair(lambda m, x: (x * x).sum(), [1.0, 2.0, 3.0])
    _close(tx.grad, rx.grad, [2, 4, 6])


def test_matmul_grad():
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((3, 4)), rng.standard_normal((4, 2))
    (ra, rb), (ta, tb) = _run_pair(lambda m, x, y: m.matmul(x, y).sum(), a, b)
    _close(ta.grad, ra.grad)
    _close(tb.grad, rb.grad)


def test_grad_accumulation():
    for m in (P, pt):
        x = m.to_tensor([1.0, 2.0], stop_gradient=False)
        (x * 2).sum().backward()
        (x * 3).sum().backward()
        np.testing.assert_allclose(_g(x.grad), [5, 5])
        x.clear_grad()
        assert x.grad is None


def test_stop_gradient():
    for m in (P, pt):
        x = m.to_tensor([1.0], stop_gradient=False)
        y = m.to_tensor([2.0], stop_gradient=True)
        (x * y).sum().backward()
        np.testing.assert_allclose(_g(x.grad), [2.0])
        assert y.grad is None


def test_detach_breaks_graph():
    rx, tx = _run_pair(lambda m, x: ((x * x).detach() * x).sum(), [3.0])
    _close(tx.grad, rx.grad, [9.0])


def test_diamond_graph():
    rx, tx = _run_pair(lambda m, x: ((x * 3) * (x * 4)).sum(), [2.0])
    _close(tx.grad, rx.grad, [48.0])


def test_non_scalar_backward_with_grad():
    out = []
    for m in (P, pt):
        x = m.to_tensor([[1.0, 2.0]], stop_gradient=False)
        (x * 2).backward(m.to_tensor([[1.0, 0.5]]))
        out.append(x.grad)
    _close(out[1], out[0], [[2.0, 1.0]])


def test_paddle_grad_api():
    out = []
    for m in (P, pt):
        x = m.to_tensor([1.0, 2.0], stop_gradient=False)
        (g,) = m.grad((x ** 3).sum(), x)
        assert x.grad is None           # grad must not pollute .grad
        out.append(g)
    _close(out[1], out[0], [3, 12])


def test_no_grad_context():
    x = pt.to_tensor([1.0], stop_gradient=False)
    with pt.no_grad():
        y = x * 2
    assert y.is_leaf and y.stop_gradient   # the reference: y._node is None
    z = x * 2
    assert not z.is_leaf and not z.stop_gradient


def test_retain_graph():
    out = []
    for m in (P, pt):
        x = m.to_tensor([2.0], stop_gradient=False)
        y = (x * x).sum()
        y.backward(retain_graph=True)
        y.backward()
        out.append(x.grad)
    _close(out[1], out[0], [8.0])


def test_multi_output_grad():
    a = np.random.default_rng(1).standard_normal((4, 3))
    rx, tx = _run_pair(
        lambda m, x: (lambda p: p[0].sum() * 2 + p[1].sum())(
            m.split(x, 2, axis=0)), a)
    expect = np.concatenate([np.full((2, 3), 2.0), np.full((2, 3), 1.0)])
    _close(tx.grad, rx.grad, expect)


def test_softmax_ce_grad_matches_reference():
    logits = np.random.default_rng(2).standard_normal((4, 5))
    labels = np.array([0, 2, 1, 4])
    rx, tx = _run_pair(lambda m, x: m.nn.functional.cross_entropy(
        x, m.to_tensor(labels)), logits)
    _close(tx.grad, rx.grad)


def _double(m):
    class Double(m.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * 2

        @staticmethod
        def backward(ctx, grad):
            return grad * 2
    return Double


def test_pylayer():
    rx, tx = _run_pair(lambda m, x: _double(m).apply(x).sum(), [3.0])
    _close(tx.grad, rx.grad, [2.0])


def test_pylayer_mixed_inputs_and_short_form():
    """A stop-gradient Tensor before the trainable one: the full form
    (one grad a Tensor input) and the short form (one a trainable input)
    map to the same parameter, in both packages."""
    def layer(m, short):
        class Scale(m.autograd.PyLayer):
            @staticmethod
            def forward(ctx, c, x):
                ctx.save_for_backward(c)
                return c * x

            @staticmethod
            def backward(ctx, g):
                (c,) = ctx.saved_tensor()
                return (g * c,) if short else (None, g * c)
        return Scale

    for short in (False, True):
        out = []
        for m in (P, pt):
            c = m.to_tensor(np.float32([5.0]))
            x = m.to_tensor(np.float32([3.0]), stop_gradient=False)
            layer(m, short).apply(c, x).sum().backward()
            out.append(x.grad)
        _close(out[1], out[0], [5.0])


def test_grad_wrt_intermediate():
    out = []
    for m in (P, pt):
        x = m.to_tensor([1.0], stop_gradient=False)
        y = x * 2
        z = y * 3
        (g,) = m.grad(z, y)
        (gx,) = m.grad(z, x)
        out.append((g, gx))
    _close(out[1][0], out[0][0], [3.0])
    _close(out[1][1], out[0][1], [6.0])


def test_selu_large_input_grad_finite():
    rx, tx = _run_pair(lambda m, x: m.nn.functional.selu(x).sum(),
                       [100.0, -100.0, 0.5])
    assert np.all(np.isfinite(_g(tx.grad)))
    _close(tx.grad, rx.grad)


def test_double_backward_error_message():
    for m in (P, pt):
        x = m.to_tensor([2.0], stop_gradient=False)
        loss = (x * x).sum()
        loss.backward()
        with pytest.raises(RuntimeError, match="retain_graph"):
            loss.backward()
    # a graph that saves no tensor is refused the same way
    y = (pt.to_tensor([2.0], stop_gradient=False) * 2).sum()
    y.backward()
    with pytest.raises(RuntimeError, match="retain_graph"):
        y.backward()


def test_backward_without_graph():
    for m in (P, pt):
        with pytest.raises(RuntimeError, match="stop_gradient=True"):
            m.to_tensor([1.0]).backward()
        x = m.to_tensor([1.0], stop_gradient=False)
        x.backward()                    # a leaf that trains: no-op
        assert x.grad is None


def test_register_hook_observes_and_rewrites_grad():
    got = {}
    for m in (P, pt):
        w = m.to_tensor(np.float32([2.0, 3.0]), stop_gradient=False)
        seen = []
        handle = w.register_hook(
            lambda g: seen.append(_g(g).copy()) or g * 10)
        (w * w).sum().backward()
        first = _g(w.grad).copy()
        handle.remove()
        w.clear_grad()
        (w * w).sum().backward()
        got[m] = (seen, first, _g(w.grad))
    for k in range(3):
        np.testing.assert_allclose(np.asarray(got[pt][k]),
                                   np.asarray(got[P][k]), rtol=TOL)
    np.testing.assert_allclose(got[pt][0][0], [4.0, 6.0])
    np.testing.assert_allclose(got[pt][1], [40.0, 60.0])
    np.testing.assert_allclose(got[pt][2], [4.0, 6.0])


def test_register_hook_on_intermediate_tensor():
    got = {}
    for m in (P, pt):
        w = m.to_tensor(np.float32([3.0]), stop_gradient=False)
        y = w * w
        seen = []
        y.register_hook(lambda g: seen.append(_g(g).copy()) or g * 2)
        (y * 5).sum().backward()
        got[m] = (seen, _g(w.grad))
    np.testing.assert_allclose(got[pt][0], got[P][0])
    np.testing.assert_allclose(got[pt][0][0], [5.0])
    np.testing.assert_allclose(got[pt][1], got[P][1], rtol=TOL)
    np.testing.assert_allclose(got[pt][1], [60.0])


def test_register_hook_self_removal_does_not_skip_next():
    for m in (P, pt):
        w = m.to_tensor(np.float32([1.0]), stop_gradient=False)
        fired = []
        handle1 = w.register_hook(lambda g: (fired.append("h1"),
                                             handle1.remove())[0])
        w.register_hook(lambda g: fired.append("h2"))
        (w * 2).sum().backward()
        assert fired == ["h1", "h2"]


def test_register_hook_fires_once_under_paddle_grad():
    got = {}
    for m in (P, pt):
        w = m.to_tensor(np.float32([3.0]), stop_gradient=False)
        y = w * w
        calls = []
        y.register_hook(lambda g: calls.append(_g(g).copy()) or g * 2)
        (gy,) = m.grad((y * 5).sum(), [y], retain_graph=False)
        assert len(calls) == 1, calls
        got[m] = (calls[0], _g(gy))
    np.testing.assert_allclose(got[pt][0], got[P][0])
    np.testing.assert_allclose(got[pt][1], [10.0])
    np.testing.assert_allclose(got[pt][1], got[P][1])


def test_grad_unused_input_and_create_graph():
    x = pt.to_tensor([2.0], stop_gradient=False)
    u = pt.to_tensor([1.0], stop_gradient=False)
    with pytest.raises(RuntimeError, match="allow_unused"):
        pt.grad((x * x).sum(), [x, u])
    gx, gu = pt.grad((x * x).sum(), [x, u], allow_unused=True)
    assert gu is None and float(gx) == 4.0
    # create_graph: the first derivative carries a graph (d2/dx2 x^3 = 6x)
    (g1,) = pt.grad((x ** 3).sum(), x, create_graph=True)
    assert not g1.stop_gradient
    (g2,) = pt.grad(g1.sum(), x)
    rx = P.to_tensor([2.0], stop_gradient=False)
    (r1,) = P.grad((rx ** 3).sum(), rx, create_graph=True)
    (r2,) = P.grad(r1.sum(), rx)
    _close(g2, r2, [12.0])


def test_backward_end_callbacks_run_once_at_the_outermost_end():
    ran = []

    def hook(g):
        ran.append(("hook", tape.in_watch_backward()))
        tape.queue_backward_end_callback(lambda: ran.append("end"))

    x = pt.to_tensor([2.0], stop_gradient=False)
    x.register_hook(hook)
    (x * x).sum().backward()
    assert ran == [("hook", False), "end"]
    pt.grad((x * x).sum(), x)
    assert ran[2:] == [("hook", True), "end"]
    # an aborted pass drops its callbacks unrun
    bad = pt.to_tensor([1.0], stop_gradient=False)
    bad.register_hook(lambda g: tape.queue_backward_end_callback(
        lambda: ran.append("late")) or 1 / 0)
    with pytest.raises(ZeroDivisionError):
        (bad * 2).sum().backward()
    assert "late" not in ran and not tape._backward_end_callbacks


def test_grad_setter_and_gradient():
    x = pt.to_tensor([1.0, 2.0], stop_gradient=False)
    assert x.gradient() is None
    x.grad = np.float32([0.5, 0.25])
    np.testing.assert_array_equal(x.gradient(), [0.5, 0.25])
    (x * 2).sum().backward()
    np.testing.assert_array_equal(x.gradient(), [2.5, 2.25])
    x.clear_gradient()
    assert x.grad is None


def test_new_modules_import_neither_jax_nor_paddle_tpu():
    """``paddle_tpu_torch`` and its ``optimizer``, ``amp``, ``autograd``,
    ``regularizer``, ``distribution`` and ``nn`` modules (and the loss,
    clip, decode, rnn, transformer, sequence, vision and norm-hook
    modules, ``static.nn``, ``fluid.layers``, ``runtime`` and ``vision``
    with its models, transforms, datasets, ops, detection and mask
    labels),
    imported in a fresh interpreter, leave ``jax`` and ``paddle_tpu`` out
    of ``sys.modules``."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "import paddle_tpu_torch\n"
        "from paddle_tpu_torch import amp, autograd, nn, optimizer, "
        "regularizer\n"
        "from paddle_tpu_torch.optimizer import lr, optimizers\n"
        "from paddle_tpu_torch.amp import auto_cast, grad_scaler\n"
        "from paddle_tpu_torch.autograd import py_layer, tape\n"
        "from paddle_tpu_torch.nn import clip\n"
        "from paddle_tpu_torch.nn.functional import loss\n"
        "from paddle_tpu_torch.nn.layer import loss as loss_layers\n"
        "from paddle_tpu_torch import distribution\n"
        "from paddle_tpu_torch.nn import decode, utils\n"
        "from paddle_tpu_torch.nn.utils import spectral_norm_hook, "
        "weight_norm_hook\n"
        "from paddle_tpu_torch.nn.functional import extension, sequence, "
        "vision\n"
        "from paddle_tpu_torch.nn.layer import rnn, transformer\n"
        "from paddle_tpu_torch.static import nn as static_nn\n"
        "from paddle_tpu_torch import fluid, runtime, vision\n"
        "from paddle_tpu_torch.vision import detection, mask_labels, ops\n"
        "from paddle_tpu_torch.vision.models import mobilenetv1, "
        "mobilenetv2, vgg\n"
        "from paddle_tpu_torch.vision.transforms import functional, "
        "transforms\n"
        "from paddle_tpu_torch.vision.datasets import cifar, flowers, "
        "folder, voc2012\n"
        "from paddle_tpu_torch.fluid import layers\n"
        "bad = [k for k in ('jax', 'jaxlib', 'paddle_tpu') if k in sys.modules]\n"
        "bad += [k for k in sys.modules if k.startswith(('jax.', 'paddle_tpu.'))]\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    p = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
