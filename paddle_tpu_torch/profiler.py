"""Profiler and tracing (counterpart of ``paddle_tpu/profiler.py``).

Host-side eager dispatch is timed op by op through the ``ops.dispatch``
hook: an event is the host time from ``dispatch.call``'s entry to its
return, under the op's name.  Kernels run asynchronously, so these are
host dispatch latencies, as in the reference ("Eager timings measure
host dispatch latency").  A ``jit.to_static`` replay runs no Python per
op: it is one event, under the layer's name.  Device truth comes from a
``torch.profiler`` trace: ``log_dir`` (or :func:`trace`) starts one, the
counterpart of ``jax.profiler.start_trace``, and writes its Chrome trace
there.  The collected host events export to chrome://tracing JSON as the
reference's exporter writes it.

The reference keeps its counters in the ``observability`` registry
(ROADMAP Queue 1 item 12, not ported); until then this module reads
each ported subsystem's own counters.  The counter families of
subsystems the port lacks raise ``NotImplementedError`` naming the item
that brings them.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict

_op_times = defaultdict(float)
_op_counts = defaultdict(int)
_events = []                    # (name, t_start, dur) host-side
_events_lock = threading.Lock()
_enabled = False
_t0 = 0.0
_device_trace = None            # (torch.profiler.profile, log_dir)


def _set_hook(flag):
    from .ops import dispatch
    dispatch.profiling = flag


def reset_profiler():
    """Drop the collected op records."""
    with _events_lock:
        _op_times.clear()
        _op_counts.clear()
        del _events[:]


def start_profiler(state="All", tracer_option="Default", log_dir=None):
    """Start recording host events; with ``log_dir``, also a device trace
    (``torch.profiler``, CPU and CUDA activities where a card is)."""
    global _enabled, _t0, _device_trace
    _enabled = True
    _t0 = time.perf_counter()
    if log_dir:
        _device_trace = (_start_trace(), log_dir)
    reset_profiler()
    _set_hook(True)


def _start_trace():
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


def _stop_trace():
    """Stop the device trace and write it to its ``log_dir`` as
    ``trace.json``; returns that path (None without a trace)."""
    global _device_trace
    if _device_trace is None:
        return None
    prof, log_dir = _device_trace
    _device_trace = None
    prof.__exit__(None, None, None)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


def stop_profiler(sorted_key="total", profile_path=None):
    global _enabled
    _enabled = False
    _set_hook(False)
    _stop_trace()
    if profile_path:
        export_chrome_tracing(profile_path)
    return summary()


def is_enabled():
    return _enabled


def summary():
    """``[("op", "count", "total_s"), (name, count, seconds), ...]``, the
    ops by total host time, largest first."""
    with _events_lock:
        rows = sorted(_op_times.items(), key=lambda kv: -kv[1])
        out = [("op", "count", "total_s")]
        for name, t in rows:
            out.append((name, _op_counts[name], round(t, 6)))
    return out


def record_op(name, seconds, t_start=None):
    if _enabled:
        # DataLoader worker threads dispatch ops concurrently: the totals
        # are updated under the lock too
        with _events_lock:
            _op_times[name] += seconds
            _op_counts[name] += 1
            _events.append((name, (t_start if t_start is not None
                                   else time.perf_counter() - seconds)
                            - _t0, seconds))


def _record_dispatch(name, t0):
    """The dispatch hook: one op's host time since ``t0``; nothing while
    a CUDA graph is being captured (its replays are the events)."""
    from .jit.functional import capturing
    if not capturing():
        record_op(name, time.perf_counter() - t0, t_start=t0)


def export_chrome_tracing(path):
    """Write the collected host events as chrome://tracing 'X' events."""
    with _events_lock:
        events = list(_events)
    trace = {"traceEvents": [
        {"name": name, "ph": "X", "pid": 0, "tid": 0,
         "ts": round(ts * 1e6, 3), "dur": round(dur * 1e6, 3),
         "cat": "op"}
        for name, ts, dur in events]}
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(trace, f)
    return path


@contextlib.contextmanager
def profiler(state="All", sorted_key="total", profile_path=None):
    start_profiler(state)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


@contextlib.contextmanager
def record_event(name):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record_op(name, time.perf_counter() - t0, t_start=t0)


class RecordEvent:
    def __init__(self, name):
        self.name = name
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        record_op(self.name, time.perf_counter() - self._t0,
                  t_start=self._t0)


class ProfilerTarget:
    CPU = "cpu"
    GPU = "gpu"
    TPU = "tpu"       # accepted for parity; maps to the card


class Profiler:
    """A ``paddle.profiler.Profiler``-style session: start / stop / step,
    an optional device trace into ``log_dir`` and chrome-trace export."""

    def __init__(self, targets=(ProfilerTarget.CPU, ProfilerTarget.GPU),
                 scheduler=None, on_trace_ready=None, log_dir=None):
        self.targets = tuple(targets)
        self.scheduler = scheduler
        self.on_trace_ready = on_trace_ready
        self.log_dir = log_dir
        self._step = 0
        self._step_t0 = None

    def start(self):
        start_profiler(log_dir=self.log_dir)
        self._step_t0 = time.perf_counter()
        return self

    def stop(self):
        result = stop_profiler()
        if self.on_trace_ready is not None:
            self.on_trace_ready(self)
        return result

    def step(self):
        """Close the span since the previous step() (or start()) as one
        ``profiler_step`` event and open the next."""
        self._step += 1
        now = time.perf_counter()
        t0 = self._step_t0 if self._step_t0 is not None else now
        record_op("profiler_step", now - t0, t_start=t0)
        self._step_t0 = now

    def step_num(self):
        return self._step

    def summary(self, sorted_by="total", **kwargs):
        return summary()

    def export_chrome_tracing(self, path):
        return export_chrome_tracing(path)

    def __enter__(self):
        return self.start()

    def __exit__(self, *a):
        self.stop()


@contextlib.contextmanager
def trace(log_dir):
    """A device trace (``torch.profiler``) of the block, written to
    ``log_dir/trace.json``."""
    global _device_trace
    prev, _device_trace = _device_trace, (_start_trace(), log_dir)
    try:
        yield
    finally:
        _stop_trace()
        _device_trace = prev


# --------------------------------------------------------------------------
# counter families
# --------------------------------------------------------------------------

def dispatch_cache_stats():
    """The counters of ``jit.to_static``'s CUDA-graph cache
    (``ops.dispatch.cache_stats``: misses are captures, hits replays)."""
    from .ops import dispatch
    return dispatch.cache_stats()


def reset_dispatch_cache_stats():
    from .ops import dispatch
    dispatch.reset_cache_stats()


def fused_step_stats():
    """The optimizer's multi-tensor step counters: ``calls`` (fused
    steps), ``compiles`` (plans built), ``eager_steps`` (per-leaf
    rules)."""
    from .optimizer import optimizer as _opt
    return dict(_opt._fused_stats)


def reset_fused_step_stats():
    from .optimizer import optimizer as _opt
    _opt.reset_fused_stats()


def prefetch_stats():
    """``io.DataLoader``'s ``prefetch_to_device`` counters."""
    from .io import dataloader as _dl
    return _dl.prefetch_stats()


def reset_prefetch_stats():
    from .io import dataloader as _dl
    _dl.reset_prefetch_stats()


def serving_stats():
    """The serving counters of every live engine, summed, and the
    artifacts' ``standalone_compiles`` (``inference/export.py``); empty
    where neither was imported."""
    import sys
    out = {}
    for name in (".inference.serving", ".inference.export"):
        mod = sys.modules.get(__package__ + name)
        if mod is not None:
            out.update(mod.serving_stats())
    return out


def reset_serving_stats():
    """The serving counters live in each engine (``stats()``); there is no
    process-wide family to reset until ROADMAP Queue 1 item 12."""
    raise NotImplementedError(
        "serving counters are per engine; the process-wide registry comes "
        "with observability (ROADMAP Queue 1 item 12)")


def _missing(name, item, what):
    def fn(*a, **k):
        raise NotImplementedError(
            f"profiler.{name}: {what} is not ported (ROADMAP Queue 1 item "
            f"{item})")
    fn.__name__ = name
    return fn


reducer_stats = _missing("reducer_stats", 13, "the bucketed gradient "
                         "reducer")
reset_reducer_stats = _missing("reset_reducer_stats", 13, "the bucketed "
                               "gradient reducer")
sharding_stats = _missing("sharding_stats", 13, "model-parallel training")
faults_stats = _missing("faults_stats", 11, "the fault-tolerance layer")
fleet_stats = _missing("fleet_stats", 11, "the serving fleet")
autoscale_stats = _missing("autoscale_stats", 11, "the fleet autoscaler")
compile_stats = _missing("compile_stats", 11, "the compile-management "
                         "layer")
analysis_stats = _missing("analysis_stats", 15, "the static analyzer")


def fast_path_summary():
    """The ported counter families in one dict."""
    return {"dispatch_cache": dispatch_cache_stats(),
            "fused_step": fused_step_stats(),
            "prefetch": prefetch_stats(),
            "serving": serving_stats()}
