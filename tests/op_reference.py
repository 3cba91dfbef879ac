"""The JAX package's outputs and gradients for the cases of
``tools/op_sweep.py``, many cases to one XLA compile.

:func:`references` traces a batch of cases under one ``jax.jit``: each
case's reference ops, and ``paddle_tpu.grad`` of its outputs, on the
reference's Tensors over the traced inputs, exactly as
:func:`tools.op_sweep.outputs_and_grads` runs them eagerly.  Eager
dispatch compiles every op and every vjp apart (about two compiles a
case); a batch compiles once.  A case runs eagerly instead when it reads
a value on the host (``nonzero``, ``unique``, ``tolist`` ...), so its
batch fails to trace, or when it outputs a 16-bit float, whose rounding
XLA changes when it fuses the ops around it.
"""
import jax
import numpy as np

import paddle_tpu as P
from tools import op_sweep as S

BATCH = 16
_HALF = ("float16", "bfloat16")


def lazy(cases):
    """``reference(case)``: :func:`references` of all ``cases``, computed
    at the first call; raises what the case's eager run raised."""
    got = {}

    def reference(case):
        if not got:
            got.update(references(cases))
        r = got[case.name]
        if isinstance(r, Exception):
            raise r
        return r
    return reference


def references(cases, batch=BATCH):
    """name -> (outputs as :func:`tools.op_sweep.flat` gives them, the
    gradients as :func:`tools.op_sweep.grads` gives them or ``None``),
    or the exception its eager run raised, for every case."""
    out = {}
    for k in range(0, len(cases), batch):
        out.update(_batch(cases[k:k + batch]))
    return out


def _eager(case):
    try:
        return S.outputs_and_grads(P, case, S.arrays(case))
    except Exception as e:              # raised again by its own test
        return e


def _batch(cases):
    arrays = [S.arrays(c) for c in cases]
    kept = {}          # name -> flat pairs, None where a traced value goes

    def trace(arrays_list):
        res = []
        for case, arrs in zip(cases, arrays_list):
            xs, out = S.run(P, case, arrs, grad=case.grad)
            pairs = S.flat_tensors(out)
            kept[case.name] = [(None, n) if S._is_tensor(v) else (v, n)
                               for v, n in pairs]
            gs = (S.grad_tensors(P, case, arrs, xs, out) if case.grad
                  else [])
            res.append(([v.value for v, _ in pairs if S._is_tensor(v)],
                        [None if g is None else g.value for g in gs]))
        return res
    try:
        got = jax.jit(trace)(arrays)
    except Exception:                   # a host read: split the batch
        if len(cases) == 1:
            return {cases[0].name: _eager(cases[0])}
        half = len(cases) // 2
        return {**_batch(cases[:half]), **_batch(cases[half:])}
    out = {}
    for case, arrs, (vals, gs) in zip(cases, arrays, got):
        pairs, it = [], iter(vals)
        for v, n in kept[case.name]:
            pairs.append((np.asarray(next(it)), n) if v is None else (v, n))
        if any(n in _HALF for _, n in pairs):
            out[case.name] = _eager(case)
            continue
        floats = [a for a in arrs if np.issubdtype(a.dtype, np.floating)]
        grads = ([np.zeros(a.shape, np.float32) if g is None
                  else np.asarray(g) for g, a in zip(gs, floats)]
                 if case.grad else None)
        out[case.name] = (pairs, grads)
    return out
