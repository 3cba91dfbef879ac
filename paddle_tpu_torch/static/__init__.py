"""paddle_tpu_torch.static (counterpart of
``paddle_tpu/static/__init__.py``): the record-replay ``Program``, the
``Executor`` and ``ParallelExecutor`` on one device, ``append_backward`` /
``gradients``, ``static.nn``, the control flow (``cond``, ``while_loop``,
``case``, ``switch_case``), ``misc`` (``Print``, ``py_func``,
``create_global_var`` ...), ``save`` / ``load`` and program
serialization, ``InputSpec``, and ``save_inference_model`` /
``load_inference_model`` over ``inference/export.py``."""
import pickle

import torch

from . import nn
from .. import amp  # noqa: F401  (static.amp: the one amp package)
from .backward import append_backward, gradients
from .control_flow import case, cond, switch_case, while_loop
from .graph import (BuildStrategy, CompiledProgram, ExecutionStrategy,
                    Executor, Program, Scope, _set_static_mode, data,
                    default_main_program, default_startup_program,
                    executor_stats, global_scope, in_static_mode,
                    program_guard, scope_guard)
from .misc import (Print, Variable, WeightNormParamAttr, create_global_var,
                   cpu_places, cuda_places, current_name_scope,
                   load_program_state, name_scope, py_func,
                   set_program_state)
from ..jit.api import InputSpec


class ParallelExecutor(Executor):
    """ref: ``paddle_tpu/static/__init__.py:16``.  On one device it is the
    ``Executor``, with its positional ``run(program, feed, fetch_list)``
    form too.  Data parallelism over several devices (more than one
    place, or ``num_trainers > 1``) is not ported and raises (ROADMAP
    Queue 1 item 13)."""

    def __init__(self, use_cuda=False, loss_name=None, main_program=None,
                 build_strategy=None, exec_strategy=None, scope=None,
                 share_vars_from=None, num_trainers=1, trainer_id=0,
                 places=None):
        n = len(places) if isinstance(places, (list, tuple)) else 1
        if n > 1 or num_trainers > 1:
            raise NotImplementedError(
                "ParallelExecutor over more than one device is not ported "
                "(ROADMAP Queue 1 item 13); on one device it is the "
                "Executor")
        super().__init__(places[0] if isinstance(places, (list, tuple))
                         and places else None)
        self._main_program = main_program

    def run(self, fetch_list=None, feed=None, program=None, **kwargs):
        if isinstance(fetch_list, (Program, CompiledProgram)):
            # the Executor's positional form run(program, feed, fetch_list)
            program, fetch_list = fetch_list, program
        return super().run(program or self._main_program, feed, fetch_list,
                           **kwargs)


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         program=None, **kwargs):
    """Freeze a Program's replay into the ``torch.export`` artifact of
    ``inference.save_inference_model`` (ref: python/paddle/static/io.py;
    there a pruned ProgramDesc and its persistables): the ops the fetches
    need, with the parameters and persistable captures baked in; the
    feeds are its inputs (their declared unknown dims the dynamic batch)
    and the fetches its outputs."""
    from .graph import _declared_shapes, _ensure_var_id
    from ..inference.export import save_inference_model as _export
    from ..tensor.tensor import Tensor

    program = program or default_main_program()
    feed_vars = [feed_vars] if isinstance(feed_vars, Tensor) else feed_vars
    fetch_vars = [fetch_vars] if isinstance(fetch_vars, Tensor) \
        else fetch_vars
    feed_ids = [_ensure_var_id(v, program) for v in feed_vars]
    fetch_ids = [_ensure_var_id(v, program) for v in fetch_vars]
    program = _pruned(program, fetch_ids)
    fixed = {i: p.value.detach() for i, p in program.params.items()}
    fixed.update((i, t.value.detach()) for i, t in program.captured.items()
                 if t.persistable)

    def fn(*feeds):
        env = dict(fixed)
        env.update(zip(feed_ids, (f.value for f in feeds)))
        program.replay(env)
        return tuple(Tensor(env[i]) for i in fetch_ids)

    spec = [(_declared_shapes.get(i, list(v.shape)), v.dtype)
            for i, v in zip(feed_ids, feed_vars)]
    names = [v.name for v in feed_vars]
    return _export(path_prefix, fn, spec, input_names=names,
                   output_names=[v.name for v in fetch_vars])


def _pruned(program, fetch_ids):
    """A copy of ``program`` with only the ops its fetches depend on (the
    reference's pruned program): an eval clone's loss and its label feed
    drop out."""
    need, keep = set(fetch_ids), []
    for op in reversed(program.ops):
        if need.intersection(op.out_ids):
            keep.append(op)
            need.update(r for k, r in op.leaf_specs if k == "var")
    out = program.clone()
    out.ops = keep[::-1]
    return out


class _LoadedInferenceProgram:
    """What :func:`load_inference_model` returns as the program:
    ``Executor.run`` runs its artifact on the feeds by name."""

    def __init__(self, model):
        self.model = model
        self.ops = True       # not a startup program

    def run(self, feed, fetch_list=None):
        outs = self.model(*[feed[n] for n in self.model.input_names()])
        return [(o.float() if o.dtype == torch.bfloat16 else o).cpu().numpy()
                for o in outs]


def load_inference_model(path_prefix, executor=None, **kwargs):
    """[program, feed names, fetch names], as the reference returns them;
    run with ``exe.run(program, feed=..., fetch_list=...)`` on the
    executor's place (default: the card)."""
    from ..framework import core
    from ..inference.export import StandaloneModel
    place = getattr(executor, "place", None)
    place = place if isinstance(place, core.Place) else core.get_place()
    model = StandaloneModel(path_prefix, device=place.device)
    return [_LoadedInferenceProgram(model), model.input_names(),
            model.output_names()]


def save(program, model_path, **kwargs):
    """The program's parameters, as ``param_{i}`` in parameter order, to
    ``model_path.pdparams`` (``paddle.save``'s format)."""
    from ..io.serialization import save as _save
    state = {f"param_{i}": p for i, p in enumerate(program.all_parameters())}
    _save(state, model_path + ".pdparams")


def load(program, model_path, executor=None, var_list=None):
    """Copy a :func:`save` checkpoint into the program's parameters."""
    from ..io.serialization import load as _load
    state = _load(model_path + ".pdparams")
    for i, p in enumerate(program.all_parameters()):
        key = f"param_{i}"
        if key in state:
            p.set_value(state[key])


def serialize_program(feed_vars=None, fetch_vars=None, program=None,
                      **kwargs):
    """Bytes of the program's structure: its op count, feeds and
    parameter names (the Executor rebuilds the replay)."""
    prog = program or default_main_program()
    return pickle.dumps({"n_ops": len(prog.ops),
                         "feeds": list(prog.feed_ids),
                         "params": [getattr(p, "name", str(i))
                                    for i, p in prog.params.items()]})


def serialize_persistables(feed_vars=None, fetch_vars=None, program=None,
                           **kwargs):
    """Bytes of the program's parameters by name (numpy arrays; a
    bfloat16 one as its exact float32 copy)."""
    prog = program or default_main_program()
    return pickle.dumps({getattr(p, "name", str(i)): p._host().copy()
                         for i, p in prog.params.items()})


def deserialize_program(data):
    return pickle.loads(data)


def deserialize_persistables(program, data, executor=None):
    """Load :func:`serialize_persistables` bytes into the program's
    parameters; returns the state."""
    state = pickle.loads(data)
    program.set_state_dict(state)
    return state
