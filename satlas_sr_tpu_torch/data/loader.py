"""Data loading (the JAX package's `data/loader.py`): default_collate,
build_dataset, the prefetching train loader and SequentialEvalLoader.

Batches are numpy dicts; the model moves them to its device. The train
loader's threads decode ahead of the card (the PNG codec releases the GIL).
Each draw's (index, draw ordinal) pair is assigned under one lock, the
ordinal salts the dataset's per-item RNG, and completed batches are re-ordered
by sequence number, so the batch stream does not depend on thread scheduling;
`start_sample` fast-forwards the sampler for a bit-identical resume. One
process feeds one card: a batch is `batch_size_per_gpu` rows.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

from ..parallel.mesh import local_shard_indices


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


class _WorkerError:
    """Queue marker relaying a prefetch worker's exception to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class PrefetchLoader:
    """Iterates batches assembled by background threads from an index sampler."""

    def __init__(
        self,
        dataset,
        sampler,
        batch_size: int,
        num_workers: int = 2,
        prefetch_depth: int = 4,
        collate: Callable = default_collate,
        start_sample: int = 0,
    ):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch_depth = prefetch_depth
        self.collate = collate
        # start_sample: resume fast-forward — skip this many per-rank draws
        # so a resumed run consumes exactly the samples (indices AND salts)
        # the uninterrupted run would have at the same iteration.
        self._start_sample = max(0, int(start_sample))
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch_depth)
        self._index_lock = threading.Lock()
        self._index_iter = self._sampler_iter(self._start_sample)
        self._draws = self._start_sample
        self._seq = 0  # batch sequence assigned with the draws
        self._consumed_seq = 0  # next sequence __iter__ must yield
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    def _sampler_iter(self, start: int):
        iter_from = getattr(self.sampler, "iter_from", None)
        if iter_from is not None:
            return iter_from(start)
        it = iter(self.sampler)
        if start:  # O(n) fallback for plain iterables
            import itertools
            from collections import deque

            deque(itertools.islice(it, start), maxlen=0)
        return it

    def _next_indices(self) -> Optional[tuple]:
        """Hand a worker (batch_seq, [(index, draw_ordinal), ...]).

        Both the draw ordinal and the batch sequence number are assigned
        under the sequencer lock, so the mapping draw -> (index, salt) and
        batch -> position in the training stream are deterministic
        regardless of which worker thread ends up loading what — the salt
        feeds the dataset's per-item RNG (frame sampling / rand_crop) in
        place of a racy shared epoch counter, and __iter__ re-orders
        completed batches by sequence (like torch's DataLoader) so the
        batch ORDER doesn't depend on thread scheduling either.
        """
        with self._index_lock:
            out = []
            try:
                for _ in range(self.batch_size):
                    out.append((next(self._index_iter), self._draws))
                    self._draws += 1
            except StopIteration:
                pass
            if not out:
                return None
            seq = self._seq
            self._seq += 1
        return seq, out

    def _load(self, index: int, salt: int):
        sample_fn = getattr(self.dataset, "sample", None)
        if sample_fn is not None:
            return sample_fn(index, salt)
        return self.dataset[index]

    def _put(self, item) -> None:
        # Blocking put that still honors stop(): workers parked on a full
        # queue must exit when the loader shuts down.
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def _worker(self) -> None:
        try:
            while not self._stop.is_set():
                nxt = self._next_indices()
                if nxt is None:
                    self._queue.put(None)
                    return
                seq, indices = nxt
                batch = self.collate([self._load(i, salt) for i, salt in indices])
                self._put((seq, batch))
        except BaseException as e:  # noqa: BLE001 - relayed to the consumer
            # A dying worker must surface, not starve the training loop: an
            # unhandled load/collate error (corrupt png, dataset exhausted
            # its skip budget) used to kill the daemon thread silently and
            # leave __iter__ blocked on queue.get() forever.
            self._put(_WorkerError(e))

    def start(self) -> "PrefetchLoader":
        for _ in range(self.num_workers):
            t = threading.Thread(target=self._worker, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        # drain so workers blocked on put() can exit
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass

    def _restart(self) -> None:
        """Fresh pass over a finite sampler: new index stream + workers."""
        self.stop()
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads = []
        self._stop = threading.Event()
        self._queue = queue.Queue(maxsize=self.prefetch_depth)
        # A restart is a FRESH pass over a finite sampler (next epoch), not
        # a resume: start from sample 0 — the construction-time fast-forward
        # applies to the first pass only — and keep the draw-ordinal salt
        # counter monotonic so repeated passes resample frames/crops instead
        # of replaying pass 1 bit-for-bit.
        self._index_iter = self._sampler_iter(0)
        self._seq = 0
        self._consumed_seq = 0
        self.start()

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if not self._threads:
            self.start()
        elif all(not t.is_alive() for t in self._threads):
            self._restart()  # previous (finite) pass exhausted its workers
        finished = 0
        stash: Dict[int, Any] = {}  # out-of-order completions, keyed by seq
        while True:
            item = self._queue.get()
            if item is None:
                finished += 1
                if finished >= self.num_workers:
                    # all workers exited -> every put preceded its None
                    # (queue FIFO); flush any tail in sequence order,
                    # advancing the cursor so a later pass stays in sync
                    for s in sorted(stash):
                        self._consumed_seq = s + 1
                        yield stash[s]
                    stash.clear()
                    return
                continue
            if isinstance(item, _WorkerError):
                self.stop()
                raise RuntimeError(
                    "PrefetchLoader worker failed while loading a batch"
                ) from item.exc
            seq, batch = item
            stash[seq] = batch
            while self._consumed_seq in stash:
                yield stash.pop(self._consumed_seq)
                self._consumed_seq += 1


def build_dataset(dataset_opt: Dict[str, Any]):
    from ..registry import DATASET_REGISTRY

    opt = dict(dataset_opt)
    ds_type = opt.pop("type")
    return DATASET_REGISTRY.get(ds_type)(opt)


def build_train_loader(dataset, dataset_opt: Dict[str, Any], seed: int = 0, rank: int = 0,
                       world_size: int = 1, start_sample: int = 0) -> PrefetchLoader:
    """The train loader for a dataset config block: its sampler
    (`data/sampler.build_sampler`), batch_size_per_gpu rows a batch (one
    card a process), num_worker_per_gpu threads, prefetch_depth batches."""
    from .sampler import build_sampler

    sampler = build_sampler(dataset, dataset_opt, seed, rank, world_size)
    batch = int(dataset_opt.get("batch_size_per_gpu", 16))
    workers = int(dataset_opt.get("num_worker_per_gpu", 2))
    depth = int(dataset_opt.get("prefetch_depth", 4))
    return PrefetchLoader(dataset, sampler, batch, workers, depth, start_sample=start_sample)


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
        local = local_shard_indices(n, self.rank, self.world)
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
