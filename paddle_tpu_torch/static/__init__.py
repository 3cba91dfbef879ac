"""paddle_tpu_torch.static (counterpart of
``paddle_tpu/static/__init__.py``): the record-replay ``Program``, the
``Executor`` and ``ParallelExecutor`` on one device, ``append_backward`` /
``gradients``, part of ``static.nn`` and ``InputSpec``.  Static control
flow, ``misc`` (``Variable``, ``py_func``, ...), inference-model export
and program serialization are not ported (ROADMAP Queue 1 item 4)."""
from . import nn
from .backward import append_backward, gradients
from .graph import (BuildStrategy, CompiledProgram, ExecutionStrategy,
                    Executor, Program, Scope, _set_static_mode, data,
                    default_main_program, default_startup_program,
                    executor_stats, global_scope, in_static_mode,
                    program_guard, scope_guard)
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
