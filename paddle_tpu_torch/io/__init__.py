"""paddle_tpu_torch.io (counterpart of ``paddle_tpu/io/__init__.py``; ref:
python/paddle/io/__init__.py)."""
from .dataset import (Dataset, IterableDataset, TensorDataset, ComposeDataset,
                      ChainDataset, ConcatDataset, Subset, random_split,
                      Sampler, SequenceSampler, RandomSampler,
                      WeightedRandomSampler, BatchSampler,
                      DistributedBatchSampler)
from .dataloader import (DataLoader, default_collate_fn, get_worker_info,
                         WorkerInfo, prefetch_to_device, prefetch_stats,
                         reset_prefetch_stats)
from .serialization import save, load
