"""The fluid facade (counterpart of ``paddle_tpu/fluid/__init__.py``),
minimal: the reader path (``core.EOFException``, ``io.PyReader``,
``layers.py_reader`` and its helpers), ``DatasetFactory`` with
``InMemoryDataset`` and ``QueueDataset``, and the static graph's names
the reader loop uses (``Program``, ``Executor``, ``program_guard``, the
places).  Every other public name of the reference's facade raises,
naming ROADMAP Queue 1 item 4 (the fluid facade)."""
from ..framework.core import CPUPlace, CUDAPlace  # noqa: F401
from ..static import ParallelExecutor  # noqa: F401
from ..static.backward import append_backward, gradients  # noqa: F401
from ..static.graph import (BuildStrategy, CompiledProgram,  # noqa: F401
                            ExecutionStrategy, Executor, Program, Scope,
                            data, default_main_program,
                            default_startup_program, global_scope,
                            program_guard, scope_guard)
from ..distributed import InMemoryDataset, QueueDataset
from . import core, io, layers, reader_compat  # noqa: F401
from ._facade import not_ported


class DatasetFactory:
    """ref fluid/dataset.py::DatasetFactory: ``create_dataset`` by name."""

    def create_dataset(self, datafeed_class="QueueDataset"):
        kinds = {"InMemoryDataset": InMemoryDataset,
                 "QueueDataset": QueueDataset,
                 # a GPU-PS accelerator dataset in the reference; the
                 # in-memory pipeline serves its API there too
                 "BoxPSDataset": InMemoryDataset}
        if datafeed_class not in kinds:
            raise ValueError(f"unknown dataset class {datafeed_class!r}; "
                             f"choose from {sorted(kinds)}")
        return kinds[datafeed_class]()


__getattr__ = not_ported(__name__)
