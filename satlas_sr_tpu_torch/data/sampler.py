"""Index samplers of the train loader (the JAX package's `data/sampler.py`, copied).

- WeightedInfiniteSampler: weighted sampling with replacement through
  np.random.choice, the reference's CustomWeightedRandomSampler
  (s2-naip_dataset.py:18-32), wired whenever a train config names
  `tile_weights`;
- EnlargedShuffleSampler: basicsr's EnlargedSampler, a shuffled epoch order
  enlarged by a ratio and sharded by rank.

Both are seeded and epoch-aware: each epoch's draws are a pure function of
(seed, epoch), so `iter_from` fast-forwards a resumed run in O(1) to the
exact draws the uninterrupted run would have made. One process trains on
one card, so rank is 0 and world_size 1 unless a caller says otherwise.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


class WeightedInfiniteSampler:
    """Yields weighted-random dataset indices, sharded across processes."""

    def __init__(
        self,
        weights: np.ndarray,
        seed: int = 0,
        rank: int = 0,
        world_size: int = 1,
        chunk: int = 65536,
    ):
        p = np.asarray(weights, np.float64)
        self._p = p / p.sum()
        self._n = len(p)
        self._seed = seed
        self._rank = rank
        self._world = world_size
        self._chunk = chunk

    def _per_rank_len(self) -> int:
        return len(range(self._rank, self._chunk, self._world))

    def iter_from(self, start: int) -> Iterator[int]:
        """Resume the per-rank stream at draw `start` in O(1).

        Each epoch's draws are a pure function of (seed, epoch), so
        fast-forwarding is arithmetic — the loader uses this to make a
        resumed run consume EXACTLY the samples the uninterrupted run
        would have (the reference restarts its within-epoch position)."""
        per_rank = self._per_rank_len()
        if per_rank == 0:
            raise ValueError(
                f"empty per-rank sample stream: chunk={self._chunk} yields "
                f"nothing for rank {self._rank} of {self._world}")
        epoch, offset = divmod(max(0, int(start)), per_rank)
        while True:
            rng = np.random.RandomState((self._seed + epoch) % (2**31 - 1))
            draw = rng.choice(self._n, size=self._chunk, p=self._p, replace=True)
            yield from draw[self._rank :: self._world][offset:].tolist()
            offset = 0
            epoch += 1

    def __iter__(self) -> Iterator[int]:
        return self.iter_from(0)


class EnlargedShuffleSampler:
    """Shuffled epoch-order sampler with ratio enlargement, sharded by rank."""

    def __init__(
        self,
        num_samples: int,
        seed: int = 0,
        rank: int = 0,
        world_size: int = 1,
        ratio: int = 1,
        shuffle: bool = True,
    ):
        self._n = num_samples
        self._seed = seed
        self._rank = rank
        self._world = world_size
        self._ratio = max(1, ratio)
        self._shuffle = shuffle

    def epoch_indices(self, epoch: int) -> np.ndarray:
        total = self._n * self._ratio
        if self._shuffle:
            rng = np.random.RandomState((self._seed + epoch) % (2**31 - 1))
            idx = rng.permutation(total) % self._n
        else:
            idx = np.arange(total) % self._n
        return idx[self._rank :: self._world]

    def _per_rank_len(self) -> int:
        total = self._n * self._ratio
        return len(range(self._rank, total, self._world))

    def iter_from(self, start: int) -> Iterator[int]:
        """O(1) fast-forward to per-rank draw `start` (see
        WeightedInfiniteSampler.iter_from)."""
        per_rank = self._per_rank_len()
        if per_rank == 0:
            raise ValueError(
                f"empty per-rank sample stream: {self._n} samples x ratio "
                f"{self._ratio} yield nothing for rank {self._rank} of "
                f"{self._world} (dataset too small for this world size)")
        epoch, offset = divmod(max(0, int(start)), per_rank)
        while True:
            yield from self.epoch_indices(epoch)[offset:].tolist()
            offset = 0
            epoch += 1

    def __iter__(self) -> Iterator[int]:
        return self.iter_from(0)


def build_sampler(
    dataset,
    opt: dict,
    seed: int = 0,
    rank: int = 0,
    world_size: int = 1,
):
    """Choose the sampler for a dataset config block (train semantics)."""
    tile_weights_path = opt.get("tile_weights")
    if tile_weights_path:
        import json
        import os

        with open(os.path.expanduser(tile_weights_path)) as f:
            tile_weights = json.load(f)
        weights = dataset.tile_weights_array(tile_weights)
        return WeightedInfiniteSampler(weights, seed, rank, world_size)
    return EnlargedShuffleSampler(
        len(dataset),
        seed,
        rank,
        world_size,
        ratio=int(opt.get("dataset_enlarge_ratio", 1)),
        shuffle=bool(opt.get("use_shuffle", True)),
    )
