# Copied from paddle_tpu/io/dataset.py (numpy-only), code unchanged but for
# DistributedBatchSampler's default replicas and rank, read from
# torch.distributed; the port keeps its own copy so it never imports
# paddle_tpu.
"""Datasets and samplers (ref: python/paddle/io/ → fluid/dataloader/)."""
from __future__ import annotations

import numpy as np


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise TypeError("IterableDataset has no __getitem__")

    def __len__(self):
        # TypeError (not RuntimeError) so list()/length_hint treat it as
        # "no length available" instead of propagating
        raise TypeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, index):
        return tuple(t[index] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            if isinstance(sample, (tuple, list)):
                out.extend(sample)
            else:
                out.append(sample)
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self.cum[-1])

    def __getitem__(self, idx):
        if idx < 0:                      # torch/reference semantics
            if idx < -len(self):
                raise IndexError(idx)
            idx += len(self)
        ds = int(np.searchsorted(self.cum, idx, side="right"))
        prev = 0 if ds == 0 else int(self.cum[ds - 1])
        return self.datasets[ds][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def _rng_from_generator(generator):
    """A numpy RandomState honoring an explicit generator: an int seed, a
    numpy Generator/RandomState, or a paddle-style generator exposing
    initial_seed()/get_state(); None falls back to global np.random."""
    if generator is None:
        return np.random
    if isinstance(generator, (int, np.integer)):
        return np.random.RandomState(int(generator))
    if isinstance(generator, (np.random.RandomState, np.random.Generator)):
        return generator
    for attr in ("initial_seed", "seed"):
        fn = getattr(generator, attr, None)
        if callable(fn):
            try:
                return np.random.RandomState(int(fn()) % (2 ** 32))
            except Exception:                              # noqa: BLE001
                break
    return np.random


def random_split(dataset, lengths, generator=None):
    total = len(dataset)
    if sum(lengths) != total:
        # paddle 2.x also supports fractions; keep ints strict
        raise ValueError("sum of lengths != dataset size")
    perm = _rng_from_generator(generator).permutation(total)
    out = []
    off = 0
    for n in lengths:
        out.append(Subset(dataset, perm[off:off + n].tolist()))
        off += n
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        rng = _rng_from_generator(self.generator)
        if self.replacement:
            return iter(rng.randint(0, n, self.num_samples).tolist())
        return iter(rng.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def _world():
    """(world size, rank) of ``torch.distributed`` when it is initialised,
    else (1, 0): what the reference's process count gives on one host."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class DistributedBatchSampler(BatchSampler):
    """Shard batches across data-parallel ranks (ref: python/paddle/io/
    DistributedBatchSampler → fleet).  The default replica count and rank
    are ``torch.distributed``'s when it is initialised, else 1 and 0."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        world, me = _world()
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas if num_replicas is not None else world
        self.local_rank = rank if rank is not None else me
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            rng.shuffle(indices)
            self.epoch += 1
        # pad to be evenly divisible; TILE when pad > n (tiny datasets on
        # many ranks) so every rank gets num_samples entries — unequal
        # counts would deadlock the data-parallel collectives
        pad = self.total_size - n
        if pad > 0:
            reps = int(np.ceil(pad / max(n, 1)))
            indices = np.concatenate([indices] + [indices] * reps)[
                :self.total_size]
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in indices:
            batch.append(int(idx))
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch
