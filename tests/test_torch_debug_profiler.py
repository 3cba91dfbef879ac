"""The port's ``debug`` (the nan guard, ``check_numerics``,
``finite_mask``) and ``profiler`` against the JAX package's, on the CPU,
and the dispatch hooks that feed them.

A ``Linear``-``GELU``-``Linear`` model gets the same numpy weights in
both packages: with an inf written into one weight, the guard's
``NanInfError`` must name the same op with the same nan and inf counts,
shape and dtype; the profiler's ``summary`` must list the same op names
(the reference adds ``xla_compile`` events from its compile hook, which
the port, with no compile, does not have).  The chrome trace must read
back with one event per dispatched op.  The counter families of
subsystems the port lacks raise, naming their ROADMAP items; the hooks
cost one flag test each when off; and the new modules import neither
JAX nor the JAX package.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu_torch as pt
from paddle_tpu_torch.framework import core
from paddle_tpu_torch.ops import dispatch


@pytest.fixture(autouse=True)
def _cpu():
    prev = core._state.expected_place
    pt.set_device("cpu")
    yield
    core._state.expected_place = prev
    pt.debug.enable_check_nan_inf(False)
    if pt.profiler.is_enabled():
        pt.profiler.stop_profiler()


def _mlp(m, inf_at=None):
    net = m.nn.Sequential(m.nn.Linear(4, 8), m.nn.GELU(), m.nn.Linear(8, 3))
    rng = np.random.RandomState(0)
    w = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
         for k, v in net.state_dict().items()}
    if inf_at is not None:
        k, idx, val = inf_at
        w[k][idx] = val
    net.set_state_dict(w)
    return net


X = np.random.RandomState(1).standard_normal((2, 4)).astype(np.float32)


def _guard_error(m, inf_at):
    net = _mlp(m, inf_at)
    m.debug.enable_check_nan_inf(True)
    try:
        with pytest.raises(m.debug.NanInfError) as e:
            net(m.to_tensor(X))
    finally:
        m.debug.enable_check_nan_inf(False)
    return str(e.value)


@pytest.mark.parametrize("inf_at", [("2.weight", (0, 0), np.inf),
                                    ("0.bias", (3,), np.nan),
                                    ("0.weight", (1, 2), -np.inf)],
                         ids=["inf", "nan", "neg_inf"])
def test_nan_guard_names_the_reference_op(inf_at):
    assert _guard_error(pt, inf_at) == _guard_error(P, inf_at)


def test_nan_guard_scoped_and_off_by_default():
    net = _mlp(pt, ("2.weight", (0, 0), np.inf))
    out = net(pt.to_tensor(X))          # off: no check
    assert not np.isfinite(out.numpy()).all()
    assert not pt.debug.check_nan_inf_enabled() and not dispatch.nan_guard
    with pt.debug.check_nan_inf_guard():
        assert dispatch.nan_guard
        with pytest.raises(pt.debug.NanInfError, match="op 'linear'"):
            net(pt.to_tensor(X))
    assert not dispatch.nan_guard


def test_check_numerics_and_finite_mask_match_reference():
    good = np.array([1.0, 2.0], np.float32)
    bad = np.array([1.0, np.nan], np.float32)
    for m in (P, pt):
        # the reference's take its payloads (jax arrays), the port's
        # Tensors or torch values
        val = (lambda t: t.value) if m is P else (lambda t: t)
        t = val(m.to_tensor(good))
        assert m.debug.check_numerics({"a": t, "b": [t]}) is not None
        assert bool(np.asarray(m.debug.finite_mask([t, t])))
        assert not bool(np.asarray(m.debug.finite_mask(
            [t, val(m.to_tensor(bad))])))
        assert bool(np.asarray(m.debug.finite_mask(
            val(m.to_tensor(np.arange(3))))))
    with pytest.raises(pt.debug.NanInfError, match="mine: non-finite"):
        pt.debug.check_numerics([pt.to_tensor(bad)], "mine")


@pytest.mark.parametrize("outer,inner,raises", [
    (True, True, True), (True, False, False), (False, True, False),
    (None, True, True), (None, False, False)],
    ids=["both", "inner_off", "outer_off", "inner_only", "inner_only_off"])
def test_masked_flags_raise_only_where_the_mask_holds(outer, inner, raises):
    """``cond`` under ``to_static`` on the card computes both branches,
    each in a ``masked_flags`` block: a check in the block (the guard's
    or ``check_numerics``') raises only where every enclosing mask holds,
    when the outermost block ends in an eager run, naming the op."""
    import contextlib
    import torch
    bad = pt.to_tensor(np.array([-1.0, 4.0], np.float32))

    def block(flag):
        return (contextlib.nullcontext() if flag is None else
                pt.debug.masked_flags(torch.tensor(flag)))
    for check in ("guard", "check_numerics"):
        ctx = (pytest.raises(pt.debug.NanInfError,
                             match="op 'log'" if check == "guard"
                             else "branch: non-finite")
               if raises else contextlib.nullcontext())
        with ctx, pt.debug.check_nan_inf_guard() if check == "guard" \
                else contextlib.nullcontext():
            with block(outer):
                with block(inner):
                    y = pt.log(bad)
                    if check == "check_numerics":
                        pt.debug.check_numerics(y, "branch")


# --------------------------------------------------------------------------
# profiler
# --------------------------------------------------------------------------

def _profiled_names(m):
    net = _mlp(m)
    x = m.to_tensor(X)
    net(x)                       # the reference compiles outside the window
    m.profiler.start_profiler()
    net(x)
    rows = m.profiler.stop_profiler()
    return rows


def test_profiler_summary_op_names_match_reference():
    got = _profiled_names(pt)
    ref = _profiled_names(P)
    assert got[0] == ref[0] == ("op", "count", "total_s")
    g = {r[0]: r[1] for r in got[1:]}
    r = {n: c for n, c, _ in ref[1:] if n != "xla_compile"}
    assert g == r == {"linear": 2, "gelu": 1}
    assert all(t >= 0 for _, _, t in got[1:])
    assert not dispatch.profiling


def test_chrome_trace_reads_back_one_event_per_op(tmp_path):
    net = _mlp(pt)
    x = pt.to_tensor(X)
    path = str(tmp_path / "t" / "trace.json")
    with pt.profiler.profiler(profile_path=path):
        net(x)
        net(x)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert [e["name"] for e in events] == ["linear", "gelu", "linear"] * 2
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    assert [e["ts"] for e in events] == sorted(e["ts"] for e in events)


def test_profiler_session_steps_and_events(tmp_path):
    prof = pt.profiler.Profiler(targets=[pt.profiler.ProfilerTarget.CPU,
                                         pt.profiler.ProfilerTarget.GPU])
    with prof:
        with pt.profiler.record_event("load"):
            pass
        with pt.profiler.RecordEvent("step_body"):
            pt.to_tensor(X) * 2
        prof.step()
        prof.step()
    names = {r[0]: r[1] for r in prof.summary()[1:]}
    assert names["profiler_step"] == 2 and prof.step_num() == 2
    assert names["load"] == 1 and names["step_body"] == 1
    assert names["multiply"] == 1
    pt.profiler.reset_profiler()
    assert pt.profiler.summary() == [("op", "count", "total_s")]
    assert prof.export_chrome_tracing(str(tmp_path / "e.json"))


def test_profiler_log_dir_writes_a_device_trace(tmp_path):
    d = str(tmp_path / "dev")
    pt.profiler.start_profiler(log_dir=d)
    _mlp(pt)(pt.to_tensor(X))
    pt.profiler.stop_profiler()
    with open(os.path.join(d, "trace.json")) as f:
        assert "traceEvents" in json.load(f)
    with pt.profiler.trace(str(tmp_path / "dev2")):
        pt.to_tensor(X) + 1
    assert os.path.exists(str(tmp_path / "dev2" / "trace.json"))


def test_counter_families():
    st = pt.profiler.dispatch_cache_stats()
    assert set(st) == {"hits", "misses", "fallbacks", "warming",
                       "evictions", "size", "blacklisted"}
    pt.profiler.reset_dispatch_cache_stats()
    assert set(pt.profiler.fused_step_stats()) == {"calls", "compiles",
                                                   "eager_steps"}
    assert isinstance(pt.profiler.prefetch_stats(), dict)
    assert isinstance(pt.profiler.serving_stats(), dict)
    assert set(pt.profiler.fast_path_summary()) == {
        "dispatch_cache", "fused_step", "prefetch", "serving"}
    items = {"reducer_stats": 13, "sharding_stats": 13, "faults_stats": 11,
             "fleet_stats": 11, "autoscale_stats": 11, "compile_stats": 11,
             "analysis_stats": 15, "reset_reducer_stats": 13}
    for name, item in items.items():
        with pytest.raises(NotImplementedError, match=f"item {item}\\)"):
            getattr(pt.profiler, name)()


def test_serving_stats_sum_live_engines():
    from paddle_tpu_torch.inference import serving
    from paddle_tpu_torch.models import gpt
    import torch
    cfg = gpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=1,
                        num_heads=2, max_seq_len=32, dtype="float32")
    params = gpt.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    eng = serving.PagedServingEngine((params, cfg), device="cpu", slots=2,
                                     max_len=32, page_size=8)
    eng.generate([[1, 2, 3]], 2)
    st = pt.profiler.serving_stats()
    assert st["requests_completed"] >= 1 and st["tokens_generated"] >= 2
    assert st == serving.serving_stats()


def test_hooks_are_flags_on_dispatch():
    assert not dispatch.nan_guard and not dispatch.profiling
    pt.profiler.start_profiler()
    assert dispatch.profiling
    pt.profiler.stop_profiler()
    assert not dispatch.profiling


# --------------------------------------------------------------------------
# coverage guard and imports
# --------------------------------------------------------------------------

def _public(mod):
    import inspect
    return sorted(n for n, v in vars(mod).items()
                  if not n.startswith("_") and not inspect.ismodule(v)
                  and getattr(v, "__module__", mod.__name__) == mod.__name__)


def test_every_reference_debug_and_profiler_name_is_ported():
    missing = [f"debug.{n}" for n in _public(P.debug)
               if not hasattr(pt.debug, n)]
    missing += [f"profiler.{n}" for n in _public(P.profiler)
                if not hasattr(pt.profiler, n)]
    assert not missing, missing
    # the reference's deprecated per-family resets: only those of ported
    # families exist (the rest raise with their family)
    assert callable(pt.profiler.reset_fused_step_stats)


def test_new_modules_import_neither_jax_nor_paddle_tpu():
    """``debug``, ``profiler``, ``jit`` and ``static`` (with the control
    flow and ``misc``), imported in a fresh interpreter, leave ``jax``,
    ``paddle_tpu`` and ``ml_dtypes`` out of ``sys.modules``."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "import paddle_tpu_torch\n"
        "from paddle_tpu_torch import debug, profiler, jit, static\n"
        "from paddle_tpu_torch.jit import api, functional\n"
        "from paddle_tpu_torch.static import control_flow, misc, nn\n"
        "from paddle_tpu_torch.ops.cuda import counters\n"
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
