"""Batched loading with a thread pool and a prefetch queue (counterpart of
``genre_shapehd_tpu/data/loader.py``, single process)."""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List

import numpy as np


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
    """In-order batches (the last one may be short), built by
    ``num_workers`` threads, ``PREFETCH`` batches ahead."""
    PREFETCH = 2

    def __init__(self, dataset, batch_size: int, num_workers: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self) -> Iterator[Dict]:
        n, bs = len(self.dataset), self.batch_size
        batches = [list(range(i, min(i + bs, n))) for i in range(0, n, bs)]
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
