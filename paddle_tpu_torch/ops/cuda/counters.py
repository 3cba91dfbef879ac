"""Every kernel wrapper's launch counter, in one list, and the one
capture protocol of the code that captures CUDA graphs (the serving
steps, ``jit.to_static``).

A capture executes nothing, yet the wrappers count a launch whenever
their Python runs: :func:`capture` takes the capture's increments back
(:func:`count_delta` of :func:`launch_counts` around it, added with
``sign=-1``) and the caller adds them again at each replay, so the counts
read as if every replay had run eagerly.  :func:`held_buffers` lists the
per-call workspaces a captured graph must keep alive.
"""
from __future__ import annotations

import gc

import torch

from . import (dequant_matmul, flash_attn, fused_ffn, norms, paged_attn,
               row_matmul)

# (module, attribute): an int, or a dict of ints (dequant_matmul's by
# row count)
LAUNCH_COUNTERS = (
    (paged_attn, "launches"), (paged_attn, "quant_launches"),
    (norms, "launches"), (norms, "rms_launches"),
    (dequant_matmul, "launches"), (dequant_matmul, "rows_launches"),
    (fused_ffn, "launches"), (fused_ffn, "bodies"),
    (row_matmul, "launches"), (row_matmul, "ln_launches"),
    (flash_attn, "fwd_launches"), (flash_attn, "dq_launches"),
    (flash_attn, "dkv_launches"), (flash_attn, "fused_launches"),
    (flash_attn, "nokey_launches"))


def launch_counts():
    """Every counter's value now (dicts copied)."""
    return [dict(v) if isinstance(v, dict) else v
            for v in (getattr(m, a) for m, a in LAUNCH_COUNTERS)]


def count_delta(after, before):
    """What each counter moved between two :func:`launch_counts`."""
    return [{k: n - b.get(k, 0) for k, n in a.items() if n != b.get(k, 0)}
            if isinstance(a, dict) else a - b
            for a, b in zip(after, before)]


def add_launch_counts(delta, sign=1):
    """Add ``sign`` times a :func:`count_delta` to the counters."""
    for (m, a), d in zip(LAUNCH_COUNTERS, delta):
        cur = getattr(m, a)
        if isinstance(cur, dict):
            for k, n in d.items():
                cur[k] = cur.get(k, 0) + sign * n
        else:
            setattr(m, a, cur + sign * d)


def held_buffers(dev):
    """The workspace and ticket tensors the kernels on ``dev`` use now,
    for a graph that captured their calls to keep alive."""
    return paged_attn.held_buffers(dev) + dequant_matmul.held_buffers(dev)


def capture(run, dev, stream, pool=None, generator=None):
    """Run ``run()`` eagerly on the side ``stream`` (the warm-up PyTorch's
    CUDA-graph notes ask for, which also builds the kernels, sets their
    attributes and grows their workspaces), then capture it into a CUDA
    graph on that stream, from ``pool`` when given, with ``generator``'s
    state registered so each replay draws afresh.  Returns (the warm-up's
    outputs, the graph, the capture's outputs, its :func:`count_delta`,
    the :func:`held_buffers` it baked).  The capture's launch counts are
    taken back whether or not it succeeds; an exception it raises carries
    the warm-up's outputs as ``eager_out``, for a caller that falls back
    to them."""
    cur = torch.cuda.current_stream(dev)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        eager_out = run()
    cur.wait_stream(stream)
    # the cyclic collector must not run inside the capture: freeing a dead
    # engine's graph, events or pinned buffers there makes CUDA calls that
    # invalidate it (torch.cuda.graph no longer collects on entry)
    gc.collect()
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    before = launch_counts()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            graph_out = run()
    except Exception as e:
        e.eager_out = eager_out
        raise
    finally:
        delta = count_delta(launch_counts(), before)
        add_launch_counts(delta, -1)
    return eager_out, graph, graph_out, delta, held_buffers(dev)
