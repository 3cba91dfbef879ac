"""paddle_tpu_torch.distributed.fleet: the MultiSlot data generators of
``ps_compat``, at the reference's place
(``paddle_tpu/distributed/fleet/__init__.py:23``).  The rest of the
reference's fleet (its ``init``, strategies, meta optimizers, util and
metrics) comes with multi-GPU training and raises, naming ROADMAP Queue
1 item 13."""
from .ps_compat import (DataGenerator, MultiSlotDataGenerator,  # noqa: F401
                        MultiSlotStringDataGenerator)


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    raise NotImplementedError(
        f"distributed.fleet.{name} is not ported (ROADMAP Queue 1 item 13)")
