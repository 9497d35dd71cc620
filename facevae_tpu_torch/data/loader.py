"""Prefetching data loader (a copy of facevae_tpu/data/loader.py, not an
import of it).

Replaces the reference's DataLoader(num_workers=8, pin_memory) +
DistributedSampler (train.py:15-16): a thread pool decodes/augments items
ahead of consumption (PIL and cv2 release the GIL while they decode and
warp), batches are stacked into numpy arrays, and each process reads only
its shard of the index space.  The loop (train/loop.py) pins them and
copies them to the card on a side stream.

Epoch ordering matches DistributedSampler semantics: a seed-per-epoch
permutation of the repeated dataset, sliced per process.
"""
from __future__ import annotations

import collections
import concurrent.futures as cf
from typing import Iterator, Tuple

import numpy as np


class PrefetchLoader:
    def __init__(self, dataset, batch_size: int, num_workers: int = 8,
                 shard: Tuple[int, int] = (0, 1), seed: int = 0,
                 drop_last: bool = True, prefetch_batches: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.proc_idx, self.num_procs = shard
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch_batches = prefetch_batches
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        per_proc = len(self.dataset) // self.num_procs
        if self.drop_last:
            return per_proc // self.batch_size
        return (per_proc + self.batch_size - 1) // self.batch_size

    def _indices(self) -> np.ndarray:
        rng = np.random.RandomState(self.seed + self.epoch)
        perm = rng.permutation(len(self.dataset))
        per_proc = len(self.dataset) // self.num_procs
        return perm[self.proc_idx * per_proc:(self.proc_idx + 1) * per_proc]

    def __iter__(self) -> Iterator:
        indices = self._indices()
        n_batches = len(self)
        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending: collections.deque = collections.deque()

            def submit_batch(b):
                idxs = indices[b * self.batch_size:(b + 1) * self.batch_size]
                pending.append([pool.submit(self.dataset.__getitem__, int(i)) for i in idxs])

            for b in range(min(self.prefetch_batches, n_batches)):
                submit_batch(b)
            next_b = min(self.prefetch_batches, n_batches)
            for _ in range(n_batches):
                futures = pending.popleft()
                items = [f.result() for f in futures]
                if next_b < n_batches:
                    submit_batch(next_b)
                    next_b += 1
                yield tuple(np.stack([it[i] for it in items]) for i in range(len(items[0])))
