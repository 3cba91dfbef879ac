"""paddle_tpu_torch.distributed (counterpart of
``paddle_tpu/distributed/__init__.py``): the parameter-server era input
surface of ``ps_compat`` (a host-only copy of the reference's), at the
reference's places; ``fleet`` holds its data generators.

The datasets read their slots' dtypes from the port's Tensors (torch
dtypes), the one thing the copy cannot read as it is.  Every other
public name of the reference's package raises, naming its ROADMAP item:
13 for the collectives, launch, data parallelism and sharding, 10 and 13
for ``auto`` (its megatron rules serve sharded inference, item 10)."""
import numpy as np

from . import fleet, ps_compat  # noqa: F401
from .ps_compat import CountFilterEntry, EntryAttr, ProbabilityEntry


class _TorchSlots:
    def _slot_dtypes(self):
        """int64 for an integer slot variable, else float32 (the copy's
        rule over torch dtypes)."""
        return [np.float32 if v.value.is_floating_point() else np.int64
                for v in self._use_vars]


class QueueDataset(_TorchSlots, ps_compat.QueueDataset):
    __doc__ = ps_compat.QueueDataset.__doc__


class InMemoryDataset(_TorchSlots, ps_compat.InMemoryDataset):
    __doc__ = ps_compat.InMemoryDataset.__doc__


# the reference's other public names, by the ROADMAP item that ports them
NOT_PORTED = dict.fromkeys((
    "ParallelEnv", "init_parallel_env", "get_rank", "get_world_size",
    "spawn", "is_initialized", "ReduceOp", "Group", "new_group",
    "get_group", "barrier", "wait", "all_reduce", "reduce", "all_gather",
    "all_gather_object", "broadcast", "scatter", "alltoall", "send", "recv",
    "reduce_scatter", "split", "collective_axis", "CollectiveTimeout",
    "DataParallel", "DistributedDataParallel", "reducer", "Reducer",
    "DeviceMeshAllReduce", "MeshAxesAllReduce", "EagerProcessTransport",
    "sharding", "launch", "utils", "collective", "data_parallel",
    "parallel"), 13)
NOT_PORTED["auto"] = "10 and 13"


def __getattr__(name):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"distributed.{name} is not ported (ROADMAP Queue 1 item "
            f"{NOT_PORTED[name]})")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
