"""The port's static graph (``Program``, ``Executor``, ``ParallelExecutor``,
``append_backward`` / ``gradients``, ``static.nn``) against the JAX
package, on the CPU.

Both packages build the same program from the same weights (the
reference's ``state_dict()``, batch norm's buffers included, as numpy into
``set_state_dict``) and run it on the same numpy feeds.

* ResNet18 and ResNet50 (``num_classes=10``) at 32 x 32, batch 4, static
  Momentum steps (lr 0.002, momentum 0.9, weight decay 1e-4): losses at
  rtol 1e-4, every parameter and batch-norm buffer after the steps at
  rtol 1e-4, atol 1e-5.  ResNet18 takes one step in fp32 and three in
  float64, ResNet50 one in float64; the reference's float64 runs are in
  a fresh interpreter with JAX's x64 on.  In fp32 these steps are
  ill-conditioned (layer4's batch statistics are over 4 values a
  channel): the reference's own fp32 parameters after ResNet18's three
  steps are 166 times that tolerance from a float64 evaluation of the
  same steps, and after ResNet50's one step 5,465 times, with its loss
  4.3e-4 off (``tools/resnet_fp32_conditioning.py``); float64 is where
  the two implementations can be told apart from their roundings.
* A ``static.nn`` program (``conv2d``, ``batch_norm``, ``pool2d``,
  ``fc``): train steps, the ``clone(for_test=True)`` eval, fetches of
  ``append_backward`` and ``gradients`` ids, ``ParallelExecutor``'s
  positional run, at rtol 1e-5, atol 1e-5; a program built under
  ``amp.auto_cast`` keeps its casts when replayed (the reference's output
  dtypes, values within one bf16 step of its); the Executor builds once per key and
  never on a repeated run.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu import static as JS
from paddle_tpu.vision import models as JM
from paddle_tpu_torch import static as TS
from paddle_tpu_torch import vision
from paddle_tpu_torch.framework import core

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu():
    """The CPU as the default place; static mode off in both packages and
    every generator (both packages', numpy's) restored after."""
    prev = core._state.expected_place
    ref, np_state = P.get_rng_state(), np.random.get_state()
    port = core.default_generator().torch.get_state()
    pt.set_device("cpu")
    P.seed(3)
    core.default_generator().torch.manual_seed(3)
    try:
        yield
    finally:
        P.disable_static()
        pt.disable_static()
        P.set_rng_state(ref)
        np.random.set_state(np_state)
        core.default_generator().torch.set_state(port)
        core._state.expected_place = prev


def _np(t):
    return np.asarray(t.numpy())


def _state(net):
    return {k: _np(v) for k, v in net.state_dict().items()}


def _resnet_program(mod, S, F, ctor, size=32):
    mod.enable_static()
    main, startup = S.Program(), S.Program()
    with S.program_guard(main, startup):
        img = S.data("image", [None, 3, size, size], "float32")
        label = S.data("label", [None, 1], "int64")
        net = ctor(num_classes=10)
        loss = F.cross_entropy(net(img), label).mean()
        opt = mod.optimizer.Momentum(learning_rate=0.002, momentum=0.9,
                                     weight_decay=1e-4)
        opt.minimize(loss)
    mod.disable_static()
    return main, startup, net, loss, opt


def _assert_state(got, want, step):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=f"step {step}: {k}")


def test_resnet18_static_step_matches_reference():
    """One fp32 static step from the same weights: the loss and every
    parameter and batch-norm buffer after it."""
    jm, js, jnet, jloss, jopt = _resnet_program(P, JS, JF, JM.resnet18)
    tm, ts, tnet, tloss, topt = _resnet_program(pt, TS, TF,
                                                vision.models.resnet18)
    assert list(jnet.state_dict()) == list(tnet.state_dict())
    tnet.set_state_dict(_state(jnet))
    rng = np.random.RandomState(0)
    feed = {"image": rng.randn(4, 3, 32, 32).astype(np.float32),
            "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}
    je, te = JS.Executor(), TS.Executor()
    assert je.run(js) == [] and te.run(ts) == []
    P.enable_static()
    jl = float(je.run(jm, feed=feed, fetch_list=[jloss])[0])
    P.disable_static()
    pt.enable_static()
    tl = float(te.run(tm, feed=feed, fetch_list=[tloss])[0])
    pt.disable_static()
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    _assert_state(_state(tnet), _state(jnet), 0)
    assert len(topt._parameters) == len(jopt._parameters) == 62


_REF64 = """
import sys
import numpy as np, jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import paddle_tpu as P
import paddle_tpu.nn.functional as F
from paddle_tpu import static
from paddle_tpu.vision import models
for name, steps in (("resnet18", 3), ("resnet50", 1)):
    P.seed(3)
    P.enable_static()
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        img = static.data("image", [None, 3, 32, 32], "float64")
        label = static.data("label", [None, 1], "int64")
        net = getattr(models, name)(num_classes=10)
        for v in net.state_dict().values():
            v.value = v.value.astype(jnp.float64)
        init = {k: np.asarray(v.numpy()) for k, v in
                net.state_dict().items()}
        loss = F.cross_entropy(net(img), label).mean()
        P.optimizer.Momentum(learning_rate=0.002, momentum=0.9,
                             weight_decay=1e-4).minimize(loss)
    rng = np.random.RandomState(0)
    x = rng.randn(4, 3, 32, 32)
    y = rng.randint(0, 10, (4, 1))
    exe = static.Executor()
    losses = [exe.run(main, feed={"image": x, "label": y},
                      fetch_list=[loss])[0] for _ in range(steps)]
    P.disable_static()
    after = {k: np.asarray(v.numpy()) for k, v in net.state_dict().items()}
    np.savez(sys.argv[1] + name + ".npz", x=x, y=y, loss=np.stack(losses),
             **{"init/" + k: v for k, v in init.items()},
             **{"after/" + k: v for k, v in after.items()})
"""


@pytest.fixture(scope="module")
def ref64(tmp_path_factory):
    """The reference's float64 ResNet18 (three steps) and ResNet50 (one
    step) static runs, in a fresh interpreter with JAX's x64 on (one
    process for both)."""
    out = str(tmp_path_factory.mktemp("ref64")) + os.sep
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", _REF64, out], env=env, check=True,
                   timeout=900, cwd=ROOT, capture_output=True)
    return lambda name: np.load(out + name + ".npz")


@pytest.mark.parametrize("name,steps", [("resnet18", 3), ("resnet50", 1)])
def test_resnet_static_steps_match_reference_in_float64(ref64, name, steps):
    ref = ref64(name)
    tm, ts, tnet, tloss, _ = _resnet_program(
        pt, TS, TF, getattr(vision.models, name))
    tnet.set_state_dict({k[5:]: ref[k] for k in ref.files
                         if k.startswith("init/")})
    for t in tnet.state_dict().values():       # the program in float64
        t.value = t.value.detach().double()
        if isinstance(t, pt.tensor.Parameter):
            t._mark()
    exe = TS.Executor()
    feed = {"image": pt.Tensor(torch.from_numpy(ref["x"])),
            "label": ref["y"].astype(np.int64)}
    pt.enable_static()
    losses = [exe.run(tm, feed=feed, fetch_list=[tloss])[0]
              for _ in range(steps)]
    pt.disable_static()
    assert all(v.dtype == np.float64 for v in losses)
    np.testing.assert_allclose(np.stack(losses), ref["loss"], rtol=1e-4)
    _assert_state(_state(tnet), {k[6:]: ref[k] for k in ref.files
                                 if k.startswith("after/")}, steps)


# --------------------------------------------------------------------------
# a static.nn program
# --------------------------------------------------------------------------

def _nn_program(mod, S, F, amp=False):
    """image [None, 3, 8, 8] -> conv2d(4, 3, padding 1) -> batch_norm(relu)
    -> pool2d(max 2) -> fc(5) -> cross entropy; Momentum with weight
    decay; plus the test clone."""
    mod.enable_static()
    main, startup = S.Program(), S.Program()
    with S.program_guard(main, startup):
        img = S.data("image", [None, 3, 8, 8], "float32")
        label = S.data("label", [None, 1], "int64")
        ctx = mod.amp.auto_cast() if amp else _null()
        with ctx:
            h = S.nn.conv2d(img, 4, 3, padding=1)
            h = S.nn.batch_norm(h, act="relu")
            h = S.nn.pool2d(h, 2, "max", 2)
            logits = S.nn.fc(h, 5)
            loss = F.cross_entropy(logits, label).mean()
        test = main.clone(for_test=True)
        opt = mod.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                     weight_decay=1e-3)
        opt.minimize(loss)
    mod.disable_static()
    return main, test, img, h, logits, loss


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _same_weights(jm, tm):
    """The port program's parameters and captured buffers set to the
    reference program's, matched by creation order."""
    for a, b in zip(jm.all_parameters(), tm.all_parameters()):
        assert list(a.shape) == b.shape
        b.set_value(_np(a))
    jb = [t for t in jm.captured.values() if getattr(t, "persistable", 0)]
    tb = [t for t in tm.captured.values() if t.persistable]
    for a, b in zip(jb, tb):
        b.set_value(_np(a))


def _feed(n=8, seed=1):
    r = np.random.RandomState(seed)
    return {"image": r.randn(n, 3, 8, 8).astype(np.float32),
            "label": r.randint(0, 5, (n, 1)).astype(np.int64)}


def test_static_nn_program_train_and_test_clone_match_reference():
    J = _nn_program(P, JS, JF)
    T = _nn_program(pt, TS, TF)
    _same_weights(J[0], T[0])
    je, te = JS.Executor(), TS.Executor()
    feed = _feed()
    for step in range(3):
        outs = []
        for mod, exe, prog in ((P, je, J), (pt, te, T)):
            mod.enable_static()
            outs.append(exe.run(prog[0], feed=feed,
                                fetch_list=[prog[5], prog[4]]))
            mod.disable_static()
        for a, b in zip(*outs):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5,
                                       err_msg=f"step {step}")
    for a, b in zip(J[0].all_parameters(), T[0].all_parameters()):
        np.testing.assert_allclose(_np(b), _np(a), rtol=1e-5, atol=1e-5)
    # the test clone: running statistics (written back by the three
    # steps), no update of them, no optimizer step
    stats = [_np(t) for t in T[0].captured.values() if t.persistable]
    evals = []
    for mod, exe, prog in ((P, je, J), (pt, te, T)):
        mod.enable_static()
        evals.append(exe.run(prog[1], feed=_feed(4, 2),
                             fetch_list=[prog[4]])[0])
        mod.disable_static()
    np.testing.assert_allclose(evals[1], evals[0], rtol=1e-5, atol=1e-5)
    after = [_np(t) for t in T[0].captured.values() if t.persistable]
    assert all(np.array_equal(a, b) for a, b in zip(stats, after))
    assert not any(np.array_equal(s, np.zeros_like(s)) for s in stats[::2])


def test_backward_fetches_and_parallel_executor_match_reference():
    """``append_backward`` and ``gradients`` ids fetched through an
    inference program and ``ParallelExecutor``'s positional
    ``run(program, feed, fetch_list)``."""
    res = []
    for mod, S, F in ((P, JS, JF), (pt, TS, TF)):
        mod.enable_static()
        main, startup = S.Program(), S.Program()
        with S.program_guard(main, startup):
            x = S.data("x", [None, 6], "float32")
            h = S.nn.fc(x, 4, activation="tanh")
            loss = (h * h).mean()
            pg = S.append_backward(loss)
            gx, = S.gradients(loss, [x])
            gh, = S.gradients(h, [x], target_gradients=np.full(
                (3, 4), 0.5, np.float32))
        res.append((mod, S, main, startup, x, h, loss, pg, gx, gh))
        mod.disable_static()
    _same_weights(res[0][2], res[1][2])
    xs = np.random.RandomState(4).randn(3, 6).astype(np.float32)
    outs = []
    for mod, S, main, startup, x, h, loss, pg, gx, gh in res:
        mod.enable_static()
        exe = S.ParallelExecutor(loss_name=loss.name, main_program=main)
        exe.run(startup)
        fetch = [loss, gx, gh] + [g for _, g in pg]
        outs.append(exe.run(main, {"x": xs}, fetch))
        outs.append(S.Executor().run(main, feed={"x": xs},
                                     fetch_list=[h.name]))
        mod.disable_static()
    assert len(outs[0]) == len(outs[2]) == 5
    for a, b in zip(outs[0] + outs[1], outs[2] + outs[3]):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        TS.ParallelExecutor(places=["gpu:0", "gpu:1"])


def test_auto_cast_program_keeps_its_casts_and_builds_once_per_key():
    """A program built under ``amp.auto_cast`` replays its casts (the fc
    output bf16, batch norm's fp32, the loss fp32), within one bf16 step
    (2^-7) of the reference's values; the Executor builds once per (feed signature,
    fetch list) and not on a repeated run, and a fetchless run returns
    nothing."""
    J = _nn_program(P, JS, JF, amp=True)
    T = _nn_program(pt, TS, TF, amp=True)
    _same_weights(J[0], T[0])
    feed = _feed()
    P.enable_static()
    want = JS.Executor().run(J[1], feed=feed, fetch_list=[J[3], J[4]])
    P.disable_static()
    exe = TS.Executor()
    stats = TS.executor_stats
    pt.enable_static()
    b0, h0 = stats["builds"], stats["hits"]
    got = exe.run(T[1], feed=feed, fetch_list=[T[3], T[4]],
                  return_numpy=False)
    # the pool's input is batch norm's output, fp32 under the black list
    assert [g.dtype for g in got] == [torch.float32, torch.bfloat16]
    assert [str(w.dtype) for w in want] == ["float32", "bfloat16"]
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.astype("float32").numpy(), a,
                                   rtol=2 ** -7, atol=1e-2)
    exe.run(T[1], feed=feed, fetch_list=[T[3], T[4]])
    assert (stats["builds"] - b0, stats["hits"] - h0) == (1, 1)
    lv, = exe.run(T[0], feed=feed, fetch_list=[T[5]])
    assert lv.dtype == np.float32
    assert exe.run(T[0], feed=feed, fetch_list=[]) == []
    assert exe.run(T[0], feed=feed, fetch_list=[]) == []
    exe.run(T[0], feed=_feed(4), fetch_list=[])
    pt.disable_static()
    assert (stats["builds"] - b0, stats["hits"] - h0) == (4, 2)
