"""The static long tail (counterpart of ``paddle_tpu/static/misc.py``):
``Print``, ``py_func``, ``create_global_var``, ``name_scope``, the places
and the program-state io.

``Print`` and ``py_func`` run host Python on a tensor's value, which the
reference does from inside its compiled program (a host callback).  They
run eagerly and, in a static program, at every replay.  Inside a CUDA
graph capture (``jit.to_static`` on the card) they cannot: they raise
``jit.functional.GraphBreak``, and ``to_static`` runs that signature
eagerly.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from ..framework import core
from ..framework.param_attr import WeightNormParamAttr  # noqa: F401
from ..ops.dispatch import call
from ..tensor.tensor import Tensor, _readable
from .graph import _ensure_var_id, default_main_program, global_scope

# the reference's Variable is the static tensor; one Tensor type serves
# eager and static (record) modes
Variable = Tensor


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=False,
          print_phase="both"):
    """Print the value at execution time (eagerly, or at each replay of a
    static program) and pass it through as a new tensor."""
    tag = message or getattr(input, "name", None) or "var"

    def _p(x):
        _readable(x, "Print")
        v = x.detach()
        print(f"{tag}: {(v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()}")
        return x.clone()
    return call(_p, input, _name="print")


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """Run host Python ``func`` on the inputs' numpy values; its results
    take ``out``'s shapes and dtypes and are written into ``out`` (the
    templates).  ``backward_func``, if given, is the op's gradient: it
    gets (inputs, outputs, output grads) as numpy arrays, minus the
    skipped vars, and returns the inputs' grads."""
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    single_out = not isinstance(out, (list, tuple))
    out_meta = [(tuple(o.shape), o.dtype) for o in outs]
    skipped = set(id(v) for v in (skip_vars_in_backward_input or ()))
    keep_in = [id(t) not in skipped for t in xs]
    keep_out = [id(t) not in skipped for t in outs]

    def host(fn, vals):
        r = fn(*[v.detach().cpu().numpy() for v in vals])
        return r if isinstance(r, (list, tuple)) else (r,)

    class _PyFunc(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *vals):
            _readable(vals[0], "py_func")
            dev = vals[0].device
            res = tuple(torch.as_tensor(np.asarray(r)).to(dev, dt).reshape(
                shape) for r, (shape, dt) in zip(host(func, vals), out_meta))
            ctx.save_for_backward(*vals, *res)
            ctx.n_in = len(vals)
            return res

        @staticmethod
        def backward(ctx, *gs):
            saved = ctx.saved_tensors
            ins, res = saved[:ctx.n_in], saved[ctx.n_in:]
            args = ([v for v, k in zip(ins, keep_in) if k]
                    + [v for v, k in zip(res, keep_out) if k] + list(gs))
            grads = host(backward_func, args)
            return tuple(None if g is None else torch.as_tensor(
                np.asarray(g)).to(v.device, v.dtype).reshape(v.shape)
                for g, v in zip(grads, ins))

    def fn(*vals):
        res = _PyFunc.apply(*vals)
        if backward_func is None:
            res = tuple(r.detach() for r in res)
        return res
    result = call(fn, *xs, _name="py_func")
    results = result if isinstance(result, (list, tuple)) else [result]
    for tpl, r in zip(outs, results):
        tpl._rebind(r)
    return outs[0] if single_out else outs


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A persistent variable that is no parameter, registered in the
    global scope by name and captured by the default main program."""
    dt = core.convert_dtype(dtype)
    place = core.CPUPlace() if force_cpu else core.get_place()
    t = Tensor(torch.full([int(s) for s in shape], value, dtype=dt,
                          device=place.device))
    t.stop_gradient = True
    t.persistable = bool(persistable)
    t.name = name or f"global_var_{id(t)}"
    global_scope()._vars[t.name] = t
    prog = default_main_program()
    prog.captured[_ensure_var_id(t, prog)] = t
    return t


_name_scope_stack: list[str] = []


@contextlib.contextmanager
def name_scope(prefix=None):
    """A hierarchical op-name prefix (a debugging and profiling aid)."""
    _name_scope_stack.append(str(prefix or "scope"))
    try:
        yield
    finally:
        _name_scope_stack.pop()


def current_name_scope():
    return "/".join(_name_scope_stack)


def cpu_places(device_count=None):
    n = device_count or int(os.environ.get("CPU_NUM", 1))
    return [core.CPUPlace() for _ in range(n)]


def cuda_places(device_ids=None):
    """The cards' places (every visible card by default)."""
    if device_ids is None:
        device_ids = range(torch.cuda.device_count())
    return [core.CUDAPlace(i) for i in device_ids]


def load_program_state(model_path, var_list=None):
    """A ``static.save`` checkpoint as {name: numpy array}."""
    from ..io.serialization import load as _load
    path = model_path if model_path.endswith(".pdparams") \
        else model_path + ".pdparams"
    return {k: (v._host().copy() if hasattr(v, "_host") else np.asarray(v))
            for k, v in _load(path).items()}


def set_program_state(program, state_dict):
    """Assign a :func:`load_program_state` dict to a program's parameters,
    by name, else by the positional ``param_{i}`` names ``static.save``
    writes."""
    params = program.all_parameters()
    by_name = {getattr(p, "name", None): p for p in params}
    for i, p in enumerate(params):
        by_name.setdefault(f"param_{i}", p)
    for k, v in state_dict.items():
        p = by_name.get(k)
        if p is not None:
            p.set_value(np.asarray(v))
