"""Batching for the train CLI: a shuffled epoch loader over a map-style
dataset and the endless stream of weak batches (the single-process part of
`omni_pq_tpu/data/loader.py`; sharding across processes comes with data
parallelism)."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def collate(samples) -> Dict[str, np.ndarray]:
    keys = [k for k in samples[0] if not isinstance(samples[0][k], str)]
    return {k: np.stack([s[k] for s in samples]) for k in keys}


class Loader:
    """Batches of `batch_size` scenes in an order shuffled per epoch from
    seed + epoch (the JAX package's Loader with one shard); a last partial
    batch is dropped."""

    def __init__(self, dataset, batch_size: int, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = np.random.default_rng(self.seed + self.epoch).permutation(
            len(self.dataset))
        for b in range(len(self)):
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
