"""The port's optimizer extras against the JAX package, on the CPU:
``GradientMergeOptimizer`` (``paddle_tpu/optimizer/gradient_merge.py``),
``LookAhead``, ``ModelAverage`` and ``ExponentialMovingAverage``
(``paddle_tpu/incubate/optimizer.py``) over 4 steps of a small MLP from
the same numpy weights and batches, parameters at 1e-5; and
``CheckpointManager`` (``paddle_tpu/utils/checkpoint.py``) held to the
reference's behaviour (its ``tests/test_checkpoint_debug.py`` cases:
resume bitwise, retention, latest, save order over mtimes, the sequence
file's fallback) plus the async snapshot, digests and quarantine.  The
coverage guard holds the public names of the reference's
``inference/{export,predictor}.py``, ``onnx``, ``incubate``, ``utils``,
``distributed/ps_compat.py``, ``fluid/reader_compat.py`` and
``optimizer/gradient_merge.py`` against the port.
"""
import json
import os
import time

import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu_torch as pt
from paddle_tpu_torch.framework import core
from paddle_tpu_torch.utils import checkpoint as ckpt

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    prev = core._state.expected_place
    pt.set_device("cpu")
    yield
    core._state.expected_place = prev


def _mlp(mod):
    return mod.nn.Sequential(mod.nn.Linear(6, 8), mod.nn.Tanh(),
                             mod.nn.Linear(8, 3))


def _weights(net, seed=0):
    rng = np.random.RandomState(seed)
    return {k: (0.3 * rng.standard_normal(tuple(v.shape))).astype(np.float32)
            for k, v in net.state_dict().items()}


def _data(seed=1, n=4, b=8):
    rng = np.random.RandomState(seed)
    return [(rng.randn(b, 6).astype(np.float32),
             rng.randn(b, 3).astype(np.float32)) for _ in range(n)]


def _loss(mod, net, x, y):
    return mod.nn.functional.mse_loss(net(mod.to_tensor(x)),
                                      mod.to_tensor(y))


def _params(net):
    return [np.asarray(p.numpy()).copy() for p in net.parameters()]


def _close(a, b):
    for x, y in zip(a, b):
        scale = max(float(np.abs(y).max()), 1e-30)
        np.testing.assert_allclose(x, y, rtol=0, atol=TOL * scale)


def _run(mod, make_opt, after_step=None, steps=4):
    """4 steps of the MLP under ``make_opt(mod, net)``: backward, the
    optimizer's step, clear_grad; ``after_step(opt)`` after each."""
    net = _mlp(mod)
    net.set_state_dict(_weights(net))
    opt = make_opt(mod, net)
    for x, y in _data(n=steps):
        _loss(mod, net, x, y).backward()
        opt.step()
        opt.clear_grad()
        if after_step is not None:
            after_step(opt)
    return net, opt


def _inc(mod):
    return mod.incubate.optimizer if mod is pt else P.incubate.optimizer


@pytest.mark.parametrize("inner", ["SGD", "Adam"])
@pytest.mark.parametrize("k,avg", [(2, True), (4, False)])
def test_gradient_merge_matches_reference(inner, k, avg):
    def make(mod, net):
        o = getattr(mod.optimizer, inner)(learning_rate=0.05,
                                          parameters=net.parameters())
        return mod.optimizer.GradientMergeOptimizer(o, k_steps=k, avg=avg)
    (tn, topt), (rn, _) = _run(pt, make), _run(P, make)
    _close(_params(tn), _params(rn))
    assert topt._micro == 4 and not topt._acc


def test_gradient_merge_equals_one_big_batch():
    """Two micro-steps of B/2, averaged, are one AdamW step of B."""
    x, y = _data(n=1, b=8)[0]
    nets = []
    for k in (2, 1):
        net = _mlp(pt)
        net.set_state_dict(_weights(net))
        opt = pt.optimizer.GradientMergeOptimizer(pt.optimizer.AdamW(
            learning_rate=0.01, parameters=net.parameters()), k_steps=k)
        for sl in ((slice(0, 4), slice(4, 8)) if k == 2 else (slice(0, 8),)):
            _loss(pt, net, x[sl], y[sl]).backward()
            opt.step()
        nets.append(_params(net))
    _close(nets[0], nets[1])


def test_gradient_merge_harvests_a_tied_parameter_once():
    net = _mlp(pt)
    params = list(net.parameters())
    opt = pt.optimizer.GradientMergeOptimizer(pt.optimizer.SGD(
        learning_rate=0.1, parameters=params + params[:1]), k_steps=2)
    for x, y in _data(n=2):
        _loss(pt, net, x, y).backward()
        opt.step()
    assert not opt._acc and all(p.grad is None for p in params)


def test_gradient_merge_static_minimize_warns():
    pt.enable_static()
    try:
        main = pt.static.Program()
        with pt.static.program_guard(main, pt.static.Program()):
            x = pt.static.data("gm_x", [None, 2], "float32")
            loss = pt.mean(pt.static.nn.fc(x, 1))
            opt = pt.optimizer.GradientMergeOptimizer(
                pt.optimizer.SGD(learning_rate=0.1), k_steps=2)
            with pytest.warns(UserWarning, match="FULL update"):
                opt.minimize(loss)
        assert main.train_spec is not None
    finally:
        pt.disable_static()


def test_lookahead_matches_reference():
    def make(mod, net):
        return _inc(mod).LookAhead(mod.optimizer.SGD(
            learning_rate=0.1, parameters=net.parameters()), alpha=0.5, k=2)
    (tn, topt), (rn, _) = _run(pt, make), _run(P, make)
    _close(_params(tn), _params(rn))
    sd = topt.state_dict()
    assert sd["lookahead_step"] == 4 and len(sd["lookahead_slow"]) == 4


@pytest.mark.parametrize("kind", ["ModelAverage", "EMA"])
def test_averages_match_reference_and_restore_bitwise(kind):
    """The averaged weights under ``apply()`` equal the reference's; after
    ``restore()`` the training weights are back bit for bit."""
    holder = {}

    def make(mod, net):
        inner = mod.optimizer.SGD(learning_rate=0.1,
                                  parameters=net.parameters())
        if kind == "ModelAverage":
            avg = _inc(mod).ModelAverage(0.15, parameters=net.parameters(),
                                         min_average_window=2,
                                         max_average_window=3)
        else:
            avg = _inc(mod).ExponentialMovingAverage(
                0.9, parameters=net.parameters())
        holder[mod.__name__] = avg
        return inner

    outs = {}
    for mod in (pt, P):
        def step_avg(opt, mod=mod):
            a = holder[mod.__name__]
            (a.step if kind == "ModelAverage" else a.update)()
        net, _ = _run(mod, make, after_step=step_avg)
        trained = _params(net)
        with holder[mod.__name__].apply():
            averaged = _params(net)
        outs[mod.__name__] = (trained, averaged, _params(net))
    (tt, ta, tr), (rt, ra, _) = outs["paddle_tpu_torch"], outs["paddle_tpu"]
    _close(ta, ra)
    _close(tt, rt)
    for a, b in zip(tr, tt):
        np.testing.assert_array_equal(a, b)


def test_ema_static_mode_takes_the_program_parameters():
    pt.enable_static()
    try:
        main = pt.static.Program()
        with pt.static.program_guard(main, pt.static.Program()):
            x = pt.static.data("ema_x", [None, 2], "float32")
            pt.static.nn.fc(x, 3)
            ema = pt.incubate.ExponentialMovingAverage(0.99)
        assert len(ema._parameters) == len(main.all_parameters()) == 2
    finally:
        pt.disable_static()


# --------------------------------------------------------------------------
# CheckpointManager
# --------------------------------------------------------------------------

def _train_step(net, opt, x, y):
    loss = pt.nn.functional.mse_loss(net(x), y)
    loss.backward()
    opt.step()
    opt.clear_grad()


def _ckpt_setup():
    pt.seed(7)
    net = pt.nn.Linear(4, 2)
    sched = pt.optimizer.lr.StepDecay(learning_rate=0.1, step_size=3,
                                      gamma=0.5)
    opt = pt.optimizer.Adam(learning_rate=sched, parameters=net.parameters())
    return net, opt, sched


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_resume_bitwise(tmp_path, async_save):
    """Run A saves steps 1-5; run B, fresh objects, restores step 3 and
    replays 4-5: the weights and the next random draw are bit-equal."""
    rng = np.random.RandomState(0)
    x = pt.to_tensor(rng.randn(16, 4).astype(np.float32))
    y = pt.to_tensor(rng.randn(16, 2).astype(np.float32))
    net, opt, sched = _ckpt_setup()
    mgr = ckpt.CheckpointManager(str(tmp_path), keep=5,
                                 async_save=async_save)
    for i in range(1, 6):
        _train_step(net, opt, x, y)
        sched.step()
        mgr.save(i, model=net, optimizer=opt, scheduler=sched)
    mgr.wait()
    wa, ra = net.weight.numpy().copy(), pt.rand([3]).numpy()
    net2, opt2, sched2 = _ckpt_setup()
    mgr2 = ckpt.CheckpointManager(str(tmp_path), keep=5)
    assert mgr2.restore(model=net2, optimizer=opt2, scheduler=sched2,
                        step=3) == 3
    for _ in range(4, 6):
        _train_step(net2, opt2, x, y)
        sched2.step()
    np.testing.assert_array_equal(wa, net2.weight.numpy())
    np.testing.assert_array_equal(ra, pt.rand([3]).numpy())


def test_async_save_writes_the_values_before_the_next_step(tmp_path):
    """An async save followed at once by an optimizer step writes the
    pre-step values."""
    net, opt, _ = _ckpt_setup()
    x = pt.to_tensor(np.ones((2, 4), np.float32))
    y = pt.to_tensor(np.zeros((2, 2), np.float32))
    mgr = ckpt.CheckpointManager(str(tmp_path), async_save=True)
    before = net.weight.numpy().copy()
    mgr.save(1, model=net, optimizer=opt)
    _train_step(net, opt, x, y)
    mgr.wait()
    assert not np.array_equal(before, net.weight.numpy())
    got = pt.load(os.path.join(str(tmp_path), "step_1", "model.pdparams"))
    np.testing.assert_array_equal(got["weight"].numpy(), before)


def test_checkpoint_retention_latest_and_empty(tmp_path):
    net = pt.nn.Linear(2, 2)
    assert ckpt.CheckpointManager(str(tmp_path / "none")).restore(
        model=net) is None
    mgr = ckpt.CheckpointManager(str(tmp_path / "r"), keep=2)
    for i in (1, 2, 3, 4):
        mgr.save(i, model=net)
    assert sorted(os.listdir(str(tmp_path / "r"))) == ["step_3", "step_4"]
    assert mgr.latest_step() == 4 and mgr.restore(model=net) == 4


def test_checkpoint_order_survives_mtime_loss(tmp_path):
    """Retention and latest follow the save sequence, not mtimes: a
    rewound run's lower-numbered checkpoints are the live ones."""
    net = pt.nn.Linear(2, 2)
    d = str(tmp_path)
    mgr = ckpt.CheckpointManager(d, keep=2)
    for s in (10, 20, 5):
        mgr.save(s, model=net)
    assert mgr.latest_step() == 5
    kept = sorted(os.listdir(d))
    assert "step_5" in kept and "step_10" not in kept
    now = time.time()
    for name in os.listdir(d):
        os.utime(os.path.join(d, name), (now, now))
    mgr2 = ckpt.CheckpointManager(d, keep=2)
    assert mgr2.latest_step() == 5 and mgr2.restore(model=net) == 5


def test_checkpoint_seq_falls_back_to_step_number(tmp_path):
    net = pt.nn.Linear(2, 2)
    d = str(tmp_path)
    mgr = ckpt.CheckpointManager(d, keep=10)
    mgr.save(3, model=net)
    mgr.save(7, model=net)
    for s in (3, 7):
        os.remove(os.path.join(d, f"step_{s}", "save_seq"))
    mgr.save(1, model=net)          # seq-stamped: newer than both
    assert mgr.latest_step() == 1
    os.remove(os.path.join(d, "step_1", "save_seq"))
    assert ckpt.CheckpointManager(d).latest_step() == 7


def test_corrupt_checkpoint_is_quarantined_and_restore_falls_back(tmp_path):
    """A torn write (the injected truncation, published) fails its digest:
    ``verify`` raises, ``restore`` renames it ``.corrupt`` and takes the
    previous step; a crash before publishing leaves nothing published."""
    net = pt.nn.Linear(3, 3)
    d = str(tmp_path)
    mgr = ckpt.CheckpointManager(d, keep=5)
    ckpt.reset_checkpoint_stats()
    mgr.save(1, model=net)
    ckpt._truncate_fault = lambda step, name: (
        {"publish": 1} if (step, name) == (2, "model.pdparams") else None)
    try:
        mgr.save(2, model=net)
        ckpt._truncate_fault = lambda step, name: {"publish": 0}
        with pytest.raises(ckpt._InjectedCheckpointCrash):
            mgr.save(3, model=net)
    finally:
        ckpt._truncate_fault = None
    assert not os.path.exists(os.path.join(d, "step_3"))
    with pytest.raises(IOError, match="digest mismatch"):
        mgr.verify(os.path.join(d, "step_2"))
    with pytest.warns(RuntimeWarning, match="quarantined"):
        assert mgr.restore(model=net) == 1
    assert os.path.isdir(os.path.join(d, "step_2.corrupt"))
    st = ckpt.checkpoint_stats()
    assert st["checkpoints_quarantined"] == 1 and st["sync_saves"] == 3
    with open(os.path.join(d, "step_1", "digests.json")) as f:
        assert set(json.load(f)) == {"save_seq", "model.pdparams",
                                     "meta.pdstate"}


# --------------------------------------------------------------------------
# coverage guard
# --------------------------------------------------------------------------

def _public(mod):
    import inspect
    return sorted(n for n, v in vars(mod).items()
                  if not n.startswith("_") and not inspect.ismodule(v)
                  and getattr(v, "__module__", mod.__name__) == mod.__name__)


def test_every_reference_name_is_ported_or_listed():
    """Every public name the reference's modules define exists in the
    port's counterpart, or raises ``NotImplementedError`` naming the
    ROADMAP item that brings it."""
    import importlib
    pairs = [("inference.export", "inference.export"),
             ("inference.predictor", "inference.predictor"),
             ("onnx", "onnx"), ("incubate", "incubate"),
             ("incubate.optimizer", "incubate.optimizer"),
             ("utils.checkpoint", "utils.checkpoint"),
             ("distributed.ps_compat", "distributed.ps_compat"),
             ("fluid.reader_compat", "fluid.reader_compat"),
             ("optimizer.gradient_merge", "optimizer.gradient_merge")]
    missing = []
    for ref, port in pairs:
        r = importlib.import_module("paddle_tpu." + ref)
        p = importlib.import_module("paddle_tpu_torch." + port)
        missing += [f"{port}.{n}" for n in _public(r) if not hasattr(p, n)]
    # the reference's exported files: its own constant differs in name
    assert missing == ["inference.export.HLO_SUFFIX"], missing
    assert pt.inference.export.PT2_SUFFIX == ".pt2"
    listed = {
        "incubate": (["ring_attention", "moe"], ("item 13", "item 9")),
        "utils": (sorted(pt.utils.NOT_PORTED), ("item 4", "network")),
        "distributed": (sorted(pt.distributed.NOT_PORTED), ("item 1",)),
    }
    for name, (names, items) in listed.items():
        mod = getattr(pt, name)
        for n in names:
            with pytest.raises(NotImplementedError) as e:
                f = getattr(mod, n)
                f()
            assert any(i in str(e.value) for i in items), (name, n)
    ref_utils = [n for n in dir(P.utils) if not n.startswith("_")]
    for n in ref_utils:
        assert hasattr(pt.utils, n) if n not in pt.utils.NOT_PORTED else True
    ref_dist = [n for n in dir(P.distributed) if not n.startswith("_")
                and n not in ("annotations",)]
    for n in ref_dist:
        if n not in pt.distributed.NOT_PORTED:
            assert hasattr(pt.distributed, n), n
    ref_fluid = {m: [n for n in dir(getattr(P.fluid, m))
                     if not n.startswith("_")] for m in ("core", "io",
                                                         "layers")}
    for m, names in ref_fluid.items():
        for n in names:
            try:
                getattr(getattr(pt.fluid, m), n)
            except NotImplementedError as e:
                assert "item 4" in str(e)


def test_deployment_modules_import_neither_jax_nor_paddle_tpu():
    """``fluid``, ``distributed``, ``inference`` (export, predictor),
    ``onnx``, ``incubate`` and ``utils``, imported in a fresh interpreter,
    leave ``jax``, ``paddle_tpu`` and ``ml_dtypes`` out of
    ``sys.modules``."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "import paddle_tpu_torch\n"
        "from paddle_tpu_torch import (distributed, fluid, incubate, "
        "inference, onnx, utils)\n"
        "from paddle_tpu_torch.fluid import core, io, layers, reader_compat\n"
        "from paddle_tpu_torch.distributed import fleet, ps_compat\n"
        "from paddle_tpu_torch.inference import export, predictor\n"
        "from paddle_tpu_torch.incubate import optimizer\n"
        "from paddle_tpu_torch.optimizer import gradient_merge\n"
        "from paddle_tpu_torch.utils import checkpoint\n"
        "bad = [k for k in ('jax', 'jaxlib', 'paddle_tpu', 'ml_dtypes')"
        " if k in sys.modules]\n"
        "bad += [k for k in sys.modules if k.startswith(('jax.', "
        "'paddle_tpu.', 'ml_dtypes.'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    p = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
