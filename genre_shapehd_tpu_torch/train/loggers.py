"""Training callbacks: progress bar, CSVs, NaN guard, TensorBoard
scalars, checkpoints (counterpart of
``genre_shapehd_tpu/train/loggers.py``).  The event protocol is the JAX
package's: on_train_begin/end, on_epoch_begin/end, on_batch_begin/end,
and a train/eval mode toggle, driven by ``train/loop.py``.  Every batch log is
a dict of sample-mean metrics with 'size' and (train) 'loss' keys.
"""

from __future__ import annotations

import csv
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np


class Logger:
    def __init__(self):
        self.params: Dict = {}
        self.training = True

    def set_params(self, params: Dict):
        self.params = params

    def train(self):
        self.training = True

    def eval(self):
        self.training = False

    def on_train_begin(self):
        pass

    def on_train_end(self):
        pass

    def on_epoch_begin(self, epoch: int):
        pass

    def on_epoch_end(self, epoch: int, epoch_log: Dict):
        pass

    def on_batch_begin(self, batch: int):
        pass

    def on_batch_end(self, batch: int, batch_log: Dict):
        pass


class ComposeLogger(Logger):
    """Fan-out to a list of loggers."""

    def __init__(self, loggers: List[Logger]):
        super().__init__()
        self.loggers = list(loggers)

    def add_logger(self, logger: Logger):
        self.loggers.append(logger)

    def set_params(self, params):
        super().set_params(params)
        for lg in self.loggers:
            lg.set_params(params)

    def train(self):
        super().train()
        for lg in self.loggers:
            lg.train()

    def eval(self):
        super().eval()
        for lg in self.loggers:
            lg.eval()

    def on_train_begin(self):
        for lg in self.loggers:
            lg.on_train_begin()

    def on_train_end(self):
        for lg in self.loggers:
            lg.on_train_end()

    def on_epoch_begin(self, epoch):
        for lg in self.loggers:
            lg.on_epoch_begin(epoch)

    def on_epoch_end(self, epoch, epoch_log):
        for lg in self.loggers:
            lg.on_epoch_end(epoch, epoch_log)

    def on_batch_begin(self, batch):
        for lg in self.loggers:
            lg.on_batch_begin(batch)

    def on_batch_end(self, batch, batch_log):
        for lg in self.loggers:
            lg.on_batch_end(batch, batch_log)


class LogCumulator(Logger):
    """Size-weighted epoch means from batch logs."""

    def __init__(self):
        super().__init__()
        self._logs: List[Dict] = []

    def on_epoch_begin(self, epoch):
        self._logs = []

    def on_batch_end(self, batch, batch_log):
        self._logs.append(dict(batch_log))

    def get_epoch_log(self) -> Dict[str, float]:
        if not self._logs:
            return {}
        total = float(sum(l.get("size", 1) for l in self._logs))
        out: Dict[str, float] = {"size": total}
        keys = {k for l in self._logs for k in l} - {"size"}
        for k in keys:
            num = sum(l[k] * l.get("size", 1) for l in self._logs if k in l
                      and l[k] is not None)
            den = sum(l.get("size", 1) for l in self._logs if k in l
                      and l[k] is not None)
            out[k] = float(num) / max(float(den), 1.0)
        return out


class Progbar:
    """Running-average progress bar.

    The step-weighted running-average accumulation in ``update`` follows
    the Keras ``Progbar`` idiom (MIT license).
    """

    def __init__(self, target: int, width: int = 30,
                 stream=None, interval: float = 0.05):
        self.target = target
        self.width = width
        self.stream = stream or sys.stdout
        self.interval = interval
        self._values: Dict[str, List[float]] = {}
        self._start = time.time()
        self._last_update = 0.0
        self._seen_so_far = 0

    def update(self, current: int, values=None):
        values = values or []
        for k, v in values:
            if k not in self._values:
                self._values[k] = [v * (current - self._seen_so_far),
                                   current - self._seen_so_far]
            else:
                self._values[k][0] += v * (current - self._seen_so_far)
                self._values[k][1] += current - self._seen_so_far
        self._seen_so_far = current

        now = time.time()
        if now - self._last_update < self.interval and current < self.target:
            return
        self._last_update = now

        bar_len = int(self.width * current / max(self.target, 1))
        bar = "=" * bar_len + ("." * (self.width - bar_len))
        eta = ((now - self._start) / max(current, 1)
               * (self.target - current))
        info = " - ".join(
            f"{k}: {v[0] / max(v[1], 1):.4f}" for k, v in self._values.items())
        self.stream.write(
            f"\r{current}/{self.target} [{bar}] eta {eta:4.0f}s - {info}")
        if current >= self.target:
            self.stream.write("\n")
        self.stream.flush()

    def add(self, n: int, values=None):
        self.update(self._seen_so_far + n, values)


class ProgbarLogger(Logger):
    """Live per-epoch progress bar."""

    def __init__(self, interval: float = 0.05):
        super().__init__()
        self.interval = interval
        self.progbar: Optional[Progbar] = None

    def on_epoch_begin(self, epoch):
        steps = (self.params.get("steps_per_epoch", 0) if self.training
                 else self.params.get("steps_per_eval", 0))
        phase = "train" if self.training else "eval"
        print(f"Epoch {epoch}/{self.params.get('epoch', '?')} [{phase}]")
        self.progbar = Progbar(target=steps, interval=self.interval)

    def on_batch_end(self, batch, batch_log):
        if self.progbar is None:
            return
        metrics = self.params.get("metrics", [])
        vals = [(k, float(v)) for k, v in batch_log.items()
                if k in metrics and v is not None]
        self.progbar.update(batch + 1, vals)


class CsvLogger(Logger):
    """Per-epoch CSV ``epoch_loss.csv``: one row per epoch per phase
    (train/eval)."""

    def __init__(self, filepath: str):
        super().__init__()
        self.filepath = filepath
        self.cumulator = LogCumulator()

    def on_epoch_begin(self, epoch):
        self.cumulator.on_epoch_begin(epoch)

    def on_batch_end(self, batch, batch_log):
        self.cumulator.on_batch_end(batch, batch_log)

    def on_epoch_end(self, epoch, epoch_log):
        log = dict(epoch_log)
        log["epoch"] = epoch
        log["phase"] = "train" if self.training else "eval"
        exists = os.path.isfile(self.filepath)
        fieldnames = ["epoch", "phase"] + sorted(
            k for k in log if k not in ("epoch", "phase"))
        mode = "a" if exists else "w"
        with open(self.filepath, mode, newline="") as f:
            w = csv.DictWriter(f, fieldnames=fieldnames, extrasaction="ignore")
            if not exists:
                w.writeheader()
            w.writerow(log)


class BatchCsvLogger(Logger):
    """Optional per-batch CSV of the train phase (``--log_batch``)."""

    def __init__(self, filepath: str):
        super().__init__()
        self.filepath = filepath
        self.epoch = 0
        self._writer = None
        self._file = None

    def on_epoch_begin(self, epoch):
        self.epoch = epoch

    def on_batch_end(self, batch, batch_log):
        if not self.training:
            return
        row = {"epoch": self.epoch, "batch": batch,
               **{k: float(v) for k, v in batch_log.items()
                  if isinstance(v, (int, float, np.floating))}}
        exists = os.path.isfile(self.filepath)
        with open(self.filepath, "a" if exists else "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=sorted(row),
                               extrasaction="ignore")
            if not exists:
                w.writeheader()
            w.writerow(row)


class TerminateOnNaN(Logger):
    """Raise at the next batch after any NaN metric."""

    def __init__(self):
        super().__init__()
        self.batch_with_nan: Optional[int] = None

    def on_batch_begin(self, batch):
        if self.batch_with_nan is not None:
            raise FloatingPointError(
                f"NaN metric encountered in batch {self.batch_with_nan}")

    def on_batch_end(self, batch, batch_log):
        for k, v in batch_log.items():
            if isinstance(v, (int, float, np.floating)) and np.isnan(v):
                self.batch_with_nan = batch


class TensorBoardLogger(Logger):
    """Each epoch's mean metrics as TensorBoard scalars ``train/<k>`` and
    ``eval/<k>``, through tensorboardX.  Without that package it raises
    ImportError when built, before the run's first step."""

    def __init__(self, logdir: str):
        super().__init__()
        try:
            from tensorboardX import SummaryWriter
        except ImportError as e:
            raise ImportError(
                "--tensorboard needs the tensorboardX package, which is not "
                "installed") from e
        self.writer = SummaryWriter(logdir)

    def on_epoch_end(self, epoch, epoch_log):
        phase = "train" if self.training else "eval"
        for k, v in epoch_log.items():
            if isinstance(v, (int, float, np.floating)) and k != "size":
                self.writer.add_scalar(f"{phase}/{k}", float(v), epoch)
        self.writer.flush()

    def on_train_end(self):
        self.writer.close()


class ModelSaveLogger(Logger):
    """Periodic / best / latest checkpoints.

    ``save_fn(filepath, epoch)`` is provided by the trainer and closes over
    the live model state.
    """

    def __init__(self, filepath: str, period: int = 1,
                 save_best_only: bool = False, save_fn=None):
        super().__init__()
        self.filepath = filepath
        self.period = period
        self.save_best_only = save_best_only
        self.save_fn = save_fn
        self.best = np.inf

    def on_epoch_end(self, epoch, epoch_log):
        if self.training and self.save_best_only:
            return               # best tracked on eval only
        if not self.training and not self.save_best_only:
            return
        if self.save_best_only:
            loss = epoch_log.get("loss")
            if loss is None or loss >= self.best:
                return
            self.best = float(loss)
            path = self.filepath
        else:
            if epoch % self.period != 0:
                return
            path = self.filepath.format(epoch=epoch)
        if self.save_fn is not None:
            self.save_fn(path, epoch)
