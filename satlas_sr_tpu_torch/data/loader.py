"""Eval-side data loading (the JAX package's `data/loader.py`: default_collate,
build_dataset and SequentialEvalLoader).

Batches are numpy dicts; the model moves them to its device. The prefetching
train loader and the samplers come with the trainer.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np


def default_collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack array fields; keep scalar/string fields as lists."""
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.integer, np.floating)):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals
    return out


def build_dataset(dataset_opt: Dict[str, Any]):
    from ..registry import DATASET_REGISTRY

    opt = dict(dataset_opt)
    ds_type = opt.pop("type")
    return DATASET_REGISTRY.get(ds_type)(opt)


class SequentialEvalLoader:
    """One ordered pass over a dataset (validation/test), process-shardable.

    With world > 1 each rank loads only indices rank, rank+world, ... Every
    rank iterates the SAME number of fixed-size batches (pads repeat the last
    local sample and are masked out via the 'valid' key) so the ranks stay in
    lockstep; 'index' carries global dataset indices for stable output
    naming.
    """

    def __init__(self, dataset, batch_size: int = 1, collate: Callable = default_collate,
                 rank: int = 0, world: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.rank = rank
        self.world = max(1, world)

    def _steps(self) -> int:
        per_rank = -(-len(self.dataset) // self.world)  # ceil: largest shard
        return -(-per_rank // self.batch_size)

    def __len__(self) -> int:
        return self._steps()

    def __iter__(self):
        n = len(self.dataset)
        local = list(range(self.rank, n, self.world))
        n_valid = len(local)
        steps = self._steps()
        total = steps * self.batch_size
        if not local:
            local = [0]  # empty shard: load a placeholder, all-invalid
        padded = local + [local[-1]] * (total - len(local))
        bs = self.batch_size
        for s in range(steps):
            idxs = padded[s * bs:(s + 1) * bs]
            batch = self.collate([self.dataset[i] for i in idxs])
            batch["index"] = np.asarray(idxs, np.int64)
            batch["valid"] = np.asarray([s * bs + j < n_valid for j in range(bs)], bool)
            yield batch
