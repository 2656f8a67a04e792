"""Deterministic sharded sampling, the DistributedSampler equivalent.

JAX counterpart: calm_vit_dte_tpu/data/sampler.py (copied: the port imports
nothing of the JAX package). Reference: torch DistributedSampler(shuffle=
True, seed=2006) with set_epoch(epoch) (distributed_trainer_cls.py:56-57,
73): an epoch-seeded global permutation, padded by wrap-around to a multiple
of the shard count, then shard-strided, so every shard sees a disjoint,
equally sized part and all shards agree on the permutation. The same seed,
epoch and sizes give the JAX package's indices exactly.
"""

from __future__ import annotations

import numpy as np


class ShardedSampler:
    def __init__(self, dataset_size: int, num_shards: int, shard: int,
                 seed: int = 2006, shuffle: bool = True,
                 drop_last: bool = False):
        if not 0 <= shard < num_shards:
            raise ValueError(f"shard {shard} out of range [0, {num_shards})")
        self.dataset_size = dataset_size
        self.num_shards = num_shards
        self.shard = shard
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        if self.drop_last:
            return self.dataset_size // self.num_shards
        return -(-self.dataset_size // self.num_shards)

    def indices(self) -> np.ndarray:
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            order = rng.permutation(self.dataset_size)
        else:
            order = np.arange(self.dataset_size)
        per_shard = len(self)
        total = per_shard * self.num_shards
        if total > self.dataset_size:  # wrap-around padding
            order = np.concatenate([order, order[:total - self.dataset_size]])
        else:
            order = order[:total]
        return order[self.shard::self.num_shards]

    def valid_mask(self) -> np.ndarray:
        """Bool mask aligned with indices(): False for wrap-around padding
        entries (duplicates), which an evaluation must not count."""
        per_shard = len(self)
        pos = self.shard + np.arange(per_shard) * self.num_shards
        return pos < self.dataset_size

    def __iter__(self):
        return iter(self.indices())
