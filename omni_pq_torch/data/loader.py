"""Batching: shuffling epoch loader + endless weak-batch iterator.

The port's own copy of `omni_pq_tpu/data/loader.py`: the same seed, epoch
and shard give the same batches. Replaces the reference's torch DataLoader + DistributedSampler stack
(train.py:260-321): per-host shuffled batching with a process-count-aware
shard (multi-host data parallelism feeds each host its slice), an endless
reshuffling iterator for the weak/unlabeled stream (the reference's
get_next_weak_batch with its re-created iterator, train.py:311-321), and
stack-collation into fixed-shape numpy dicts.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def collate(samples) -> Dict[str, np.ndarray]:
    keys = [k for k in samples[0] if not isinstance(samples[0][k], str)]
    return {k: np.stack([s[k] for s in samples]) for k in keys}


class Loader:
    """Shuffled epoch iterator over a map-style dataset, optionally sharded
    across hosts (shard_id/num_shards replace DistributedSampler)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, shard_id: int = 0,
                 num_shards: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            idx = rng.permutation(n)
        # pad so every shard sees the same number of samples (like
        # DistributedSampler's wrap-around)
        if self.num_shards > 1:
            per = -(-n // self.num_shards)
            idx = np.concatenate([idx, idx[: per * self.num_shards - n]])
            idx = idx[self.shard_id::self.num_shards]
        return idx

    def __len__(self):
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = self._indices()
        nb = len(self)
        for b in range(nb):
            chunk = idx[b * self.batch_size:(b + 1) * self.batch_size]
            yield collate([self.dataset[int(i)] for i in chunk])


def endless(loader: Loader) -> Iterator[Dict[str, np.ndarray]]:
    """Endless reshuffling stream (weak batches, train.py:311-321): epoch
    0, 1, 2, ... of `loader`, one after the other."""
    if len(loader) == 0:
        raise ValueError("endless: the loader yields no batch")
    epoch = 0
    while True:
        loader.set_epoch(epoch)
        yield from loader
        epoch += 1


class PrefetchLoader:
    """Threaded prefetching wrapper: worker threads build the next batches
    while the accelerator runs the current step (the role of torch
    DataLoader's C++ worker processes; the heavy per-scene ops call into the
    native core in omni_pq_torch/native, which releases the GIL). Batches
    come in the wrapped loader's order; a dataset that draws from one
    random stream (the ScanNet and ARKit loaders) sees its draws in the
    order the threads take them."""

    def __init__(self, loader: Loader, num_workers: int = 4,
                 prefetch: int = 4):
        self.loader = loader
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch

    def set_epoch(self, epoch: int):
        self.loader.set_epoch(epoch)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        import queue
        import threading
        from concurrent.futures import ThreadPoolExecutor

        idx = self.loader._indices()
        nb = len(self.loader)
        bs = self.loader.batch_size
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # never blocks for good: a consumer that stops early sets `stop`
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def produce():
            pool = ThreadPoolExecutor(max_workers=self.num_workers)
            try:
                futures = []
                for b in range(nb):
                    chunk = idx[b * bs:(b + 1) * bs]
                    futures.append(pool.map(
                        lambda i: self.loader.dataset[int(i)], chunk))
                for fut in futures:
                    if not put(collate(list(fut))):
                        return
                put(None)
            except Exception as err:  # a sample failed: the consumer raises
                put(err)
            finally:
                pool.shutdown(wait=True, cancel_futures=True)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()


class DoubleLoader:
    """Alternating A/B iterator (double_loader.py:1-29): yields batches from
    two loaders in turn; the shorter one restarts endlessly while one full
    pass of the longer one defines an epoch."""

    def __init__(self, loader_a, loader_b):
        self.loader_a = loader_a
        self.loader_b = loader_b

    def __len__(self):
        return 2 * max(len(self.loader_a), len(self.loader_b))

    def __iter__(self):
        longer, shorter, a_first = (
            (self.loader_a, self.loader_b, True)
            if len(self.loader_a) >= len(self.loader_b)
            else (self.loader_b, self.loader_a, False))
        short_it = endless(shorter)
        for batch in longer:
            if a_first:
                yield batch
                yield next(short_it)
            else:
                yield next(short_it)
                yield batch
