"""Data loading: the port of ``deepspeed_tpu/runtime/dataloader.py``
(``RepeatingLoader``, ``DeepSpeedDataLoader``, ``default_collate``).

Batches are numpy arrays (or dicts and tuples of them), as in the JAX
package; the engine moves each micro-batch to its device. Each process
strides the dataset by (world size, rank), DistributedSampler's split and
the JAX loader's across processes; the world comes from
``torch.distributed`` when a process group exists, or from the engine
(``deepspeed_io``: the data-parallel world and rank). So the ranks' k-th
micro-batches together hold the same samples at every world size: those
at positions k·micro·world … (k+1)·micro·world − 1 of the (shuffled)
order, rank r taking every world-th from r.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Optional

import numpy as np


class RepeatingLoader:
    """Wraps an iterable to restart it on StopIteration."""

    def __init__(self, loader: Iterable):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)


def default_collate(samples) -> Any:
    """Stack a list of samples (dicts, tuples or arrays) into one batch."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: np.stack([np.asarray(s[k]) for s in samples])
                for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(np.stack([np.asarray(s[i]) for s in samples])
                           for i in range(len(first)))
    return np.stack([np.asarray(s) for s in samples])


def _world() -> tuple:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class DeepSpeedDataLoader:
    """Batches of ``batch_size`` samples (the per-process micro batch),
    each process taking every ``num_shards``-th sample from
    ``shard_index``; ``shuffle`` permutes with ``seed + epoch``."""

    def __init__(self, dataset, batch_size: int,
                 collate_fn: Optional[Callable] = None, local_rank: int = -1,
                 drop_last: bool = True, shuffle: bool = False, seed: int = 0,
                 num_shards: Optional[int] = None,
                 shard_index: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or default_collate
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        if num_shards is None:
            num_shards, shard_index = _world()
        self.num_shards = num_shards
        self.shard_index = shard_index or 0
        self.len = len(dataset) // (batch_size * self.num_shards)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.len

    def __iter__(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng(self.seed + self.epoch).permutation(n)
        order = order[self.shard_index::self.num_shards]
        usable = (len(order) // self.batch_size) * self.batch_size
        for start in range(0, usable, self.batch_size):
            idx = order[start:start + self.batch_size]
            yield self.collate_fn([self.dataset[int(i)] for i in idx])
