"""Deterministic per-rank data sharding.

The port's copy of :mod:`tpudist.data.sampler`, with the same index math
(the semantics of ``torch.utils.data.DistributedSampler`` as the
reference drives it: ``shuffle=True``, ``seed=0``, ``drop_last=False``):

1. a permutation of ``len(dataset)`` indices from numpy's PCG64 keyed by
   ``seed + epoch`` (``set_epoch`` re-keys it every epoch);
2. padding to a multiple of ``num_replicas`` by wrapping indices from the
   head (or truncation with ``drop_last=True``);
3. the strided subsample ``indices[rank::num_replicas]``.

The permutation is numpy's, not ``torch.randperm``'s, so both packages
shard a dataset identically from the same seed.
"""

from __future__ import annotations

import math
from typing import Iterator, Sequence

import numpy as np


class DistributedSampler:
    """Index sampler yielding this rank's shard of the dataset each epoch.
    ``num_replicas``/``rank`` default to the ``torch.distributed`` world
    when one is initialised, else to a single replica."""

    def __init__(
        self,
        dataset_size: int | Sequence,
        num_replicas: int | None = None,
        rank: int | None = None,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ):
        if not isinstance(dataset_size, int):
            dataset_size = len(dataset_size)
        if num_replicas is None or rank is None:
            import torch.distributed as dist

            up = dist.is_available() and dist.is_initialized()
            if num_replicas is None:
                num_replicas = dist.get_world_size() if up else 1
            if rank is None:
                rank = dist.get_rank() if up else 0
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} out of range for {num_replicas} replicas")
        self.dataset_size = dataset_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        if drop_last and dataset_size % num_replicas != 0:
            self.num_samples = dataset_size // num_replicas
        else:
            self.num_samples = math.ceil(dataset_size / num_replicas)
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int) -> None:
        """Re-key the shuffle for a new epoch (without it every epoch
        replays the same order)."""
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        if self.shuffle:
            rng = np.random.Generator(np.random.PCG64(self.seed + self.epoch))
            indices = rng.permutation(self.dataset_size)
        else:
            indices = np.arange(self.dataset_size)
        if self.drop_last:
            indices = indices[: self.total_size]
        else:
            pad = self.total_size - len(indices)
            if pad > 0:
                # wrap from the head, repeating the whole sequence if the
                # pad exceeds the dataset (torch semantics)
                reps = math.ceil(pad / len(indices))
                indices = np.concatenate([indices, np.tile(indices, reps)[:pad]])
        if len(indices) != self.total_size:
            raise RuntimeError(f"sampler built {len(indices)} indices, "
                               f"want {self.total_size}")
        return indices[self.rank :: self.num_replicas]

    def __iter__(self) -> Iterator[int]:
        return iter(self._indices().tolist())

    def epoch_indices(self) -> np.ndarray:
        """This rank's full index shard for the current epoch."""
        return self._indices()

    def __len__(self) -> int:
        return self.num_samples
