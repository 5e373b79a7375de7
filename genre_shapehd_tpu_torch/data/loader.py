"""Batched loading with a thread pool and a prefetch queue (counterpart of
``genre_shapehd_tpu/data/loader.py``)."""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..parallel import mesh


def collate(samples: List[Dict]) -> Dict:
    """Stack sample dicts; non-array values collect into lists."""
    out: Dict = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals).astype(np.float32)
        elif isinstance(vals[0], (int, float)):
            out[key] = np.asarray(vals, dtype=np.float32)
        else:
            out[key] = vals
    return out


class DataLoader:
    """Batches built by ``num_workers`` threads, ``PREFETCH`` batches
    ahead.  In order, the last one short, unless ``shuffle`` (a new
    permutation each pass, from ``seed`` + the pass number) or
    ``drop_last``.  A dataset with ``set_epoch`` is given the pass
    number before the pass starts (its augmentation draws from it).

    ``batch_size`` is the global batch.  With ``num_shards`` > 1 (the
    ranks of ``cli.train --multihost``) every shard draws the same index
    sequence and loads only its contiguous slice of each batch, repeated
    first to lcm(B, N) when N does not divide B
    (``parallel.mesh.shard_slice``); full batches only (``drop_last``)."""
    PREFETCH = 2

    def __init__(self, dataset, batch_size: int, num_workers: int = 4,
                 shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False, shard_id: int = 0,
                 num_shards: int = 1):
        if num_shards > 1 and not drop_last:
            raise ValueError("num_shards > 1 needs drop_last: every shard "
                             "holds an equal slice of a full batch")
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.num_shards = num_shards
        self.shard = mesh.shard_slice(batch_size, num_shards, shard_id)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def _index_batches(self) -> List[List[int]]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        bs = self.batch_size
        batches = [idx[i * bs:(i + 1) * bs] for i in range(len(self))]
        if self.num_shards > 1:
            batches = [b[self.shard] for b in batches]
        return [b.tolist() for b in batches]

    def __iter__(self) -> Iterator[Dict]:
        batches = self._index_batches()
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self.epoch)
        self.epoch += 1
        q: "queue.Queue" = queue.Queue(maxsize=self.PREFETCH)
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idx in batches:
                        if stop.is_set():
                            return
                        q.put(collate(list(pool.map(
                            self.dataset.__getitem__, idx))))
                q.put(None)
            except BaseException as e:       # re-raised in the consumer
                q.put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()


class InfiniteLoader:
    """Cycles a DataLoader forever, a new pass when one ends."""

    def __init__(self, loader: DataLoader):
        self.loader = loader
        self._it: Optional[Iterator] = None

    def __next__(self):
        if self._it is None:
            self._it = iter(self.loader)
        try:
            return next(self._it)
        except StopIteration:
            self._it = iter(self.loader)
            return next(self._it)
