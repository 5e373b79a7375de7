"""Buffered sharded batch saving, :class:`BatchSave` (counterpart of
``genre_shapehd_tpu/utils/io.py``): tensors are brought to the host as
numpy by the clean function, bfloat16 as float32 so that plain numpy
reads the ``.npz``."""

from __future__ import annotations

import os
from typing import Any, Callable, List

import numpy as np
import torch


def default_clean(batch: Any) -> Any:
    if isinstance(batch, dict):
        return {k: default_clean(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return [default_clean(v) for v in batch]
    if isinstance(batch, torch.Tensor):
        t = batch.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if hasattr(batch, "__array__"):
        return np.asarray(batch)
    return batch


def default_len(batch: Any) -> int:
    if isinstance(batch, dict):
        return default_len(next(iter(batch.values())))
    return len(batch)


def default_collate(buffers: List[Any]) -> Any:
    first = buffers[0]
    if isinstance(first, dict):
        return {k: default_collate([b[k] for b in buffers]) for k in first}
    if isinstance(first, np.ndarray):
        return np.concatenate(buffers, axis=0)
    out: List = []
    for b in buffers:
        out.extend(b)
    return out


def default_subset(batch: Any, start: int, end: int) -> Any:
    if isinstance(batch, dict):
        return {k: default_subset(v, start, end) for k, v in batch.items()}
    return batch[start:end]


def npz_compatible(value: Any) -> Any:
    """A bfloat16 array or tensor as float32 numpy (``np.savez`` stores
    bfloat16 in a form ``np.load`` cannot read back); anything else as it
    is."""
    if isinstance(value, torch.Tensor):
        return default_clean(value)
    if isinstance(value, np.ndarray) and (value.dtype.kind == "V"
                                          or value.dtype.name == "bfloat16"):
        return value.astype(np.float32)
    return value


def default_save(path: str, data: Any) -> None:
    if isinstance(data, dict):
        np.savez(path, **{k: npz_compatible(v) for k, v in data.items()})
    else:
        np.savez(path, data=npz_compatible(data))


class BatchSave:
    """Accumulate batches; flush ``filesize`` samples per shard file.

    ``savepath`` is a pattern with an ``{ind}`` field, e.g.
    ``out/shard{ind:04d}``.
    """

    def __init__(self, savepath: str, filesize: int, *,
                 collate_fn: Callable = default_collate,
                 subset_fn: Callable = default_subset,
                 len_fn: Callable = default_len,
                 clean_fn: Callable = default_clean,
                 save_fn: Callable = default_save):
        self.savepath = savepath
        self.filesize = filesize
        self.collate_fn = collate_fn
        self.subset_fn = subset_fn
        self.len_fn = len_fn
        self.clean_fn = clean_fn
        self.save_fn = save_fn
        os.makedirs(os.path.dirname(os.path.abspath(
            savepath.format(ind=0))), exist_ok=True)
        self._saveind = 0
        self._buffer: List = []
        self._buffer_size = 0
        self.closed = False

    def add_data(self, batch: Any) -> None:
        assert not self.closed
        batch = self.clean_fn(batch)
        self._buffer_size += self.len_fn(batch)
        self._buffer.append(batch)
        while self._buffer_size >= self.filesize:
            data = self.collate_fn(self._buffer)
            self.save_fn(self.savepath.format(ind=self._saveind),
                         self.subset_fn(data, 0, self.filesize))
            self._buffer = [self.subset_fn(data, self.filesize,
                                           self._buffer_size)]
            self._buffer_size -= self.filesize
            self._saveind += 1

    def close(self) -> None:
        if self._buffer_size > 0:
            self.save_fn(self.savepath.format(ind=self._saveind),
                         self.collate_fn(self._buffer))
            self._saveind += 1
        self.closed = True

    def get_fileind(self) -> int:
        return self._saveind

    def get_buffer_size(self) -> int:
        return self._buffer_size
