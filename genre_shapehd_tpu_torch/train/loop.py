"""Training loop: the model's steps over a loader, with the logger bus
(counterpart of ``genre_shapehd_tpu/train/loop.py``).

A worker thread fetches the next batch and copies it to the device while
the current step runs.  Metrics come back as device scalars; reading
them waits for the device, so they are read every ``opt.log_every``
steps (default 1: every step), in order.  With ``opt.log_time`` each
step ends in a device synchronise, so ``batch_time`` is the step's wall
time on the device.  With a visualizer, the first ``opt.vis_batches_vali``
eval batches of every ``opt.vis_every_vali``-th epoch are drawn and
dumped as ``.npz`` under ``<full_logdir>/epochNNNN_vali/``.

In a group of ranks (``parallel/mesh.py``) every rank runs the loop on its
slice of each batch; the model's steps return the global batch's metrics,
so every logger, ``TerminateOnNaN`` included, sees the same values on
every rank, and a batch counts as the global batch.  ``initialize`` gives
every rank rank 0's weights.  With ``opt.profile_step`` N, rank 0 runs
its N-th train step under ``torch.profiler`` and writes the step's
kernels, all-reduce times, the spans of ``--sp`` (``sp.halo``,
``sp.gather``), each model stage's forward and backward spans
(``utils/trace.py``) and K3's launches by shape to
``<full_logdir>/profile_step.json``.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.checkpoint import load_checkpoint, resume_path, save_checkpoint
from ..data.loader import InfiniteLoader
from ..ops.cuda import subpixel_kernel
from ..parallel import mesh
from ..utils import trace
from .loggers import ComposeLogger, LogCumulator
from .state import reference_payload_to_state, state_to_reference_payload


class Trainer:
    def __init__(self, model, opt, logger: Optional[ComposeLogger] = None,
                 visualizer=None):
        self.model = model
        self.visualizer = visualizer
        self.opt = opt
        self.logger = logger or ComposeLogger([])
        self.cumulator = LogCumulator()
        self.logger.add_logger(self.cumulator)
        self.start_epoch = 0
        self.initial_loss_eval = float("inf")
        self.steps_run = 0

    # ------------------------------------------------------------ state io
    def initialize(self, seed: int = 0) -> None:
        self.model.init_state(seed)
        mesh.broadcast_modules(self.model.net_modules().values())

    def save(self, path: str, epoch: int,
             loss_eval: Optional[float] = None) -> None:
        save_checkpoint(path, state_to_reference_payload(
            self.model, epoch, loss_eval if loss_eval is not None
            else self.initial_loss_eval))

    def load(self, path: str) -> Dict:
        payload = load_checkpoint(path)
        reference_payload_to_state(payload, self.model)
        self.start_epoch = int(payload.get("epoch", 0))
        self.initial_loss_eval = float(payload.get("loss_eval", np.inf))
        return payload

    def maybe_resume(self, logdir: str, resume: int) -> Optional[Dict]:
        path = resume_path(logdir, resume)
        if path is None:
            return None
        if not os.path.isfile(path):
            raise FileNotFoundError(f"resume checkpoint not found: {path}")
        return self.load(path)

    # ------------------------------------------------------------- batches
    def _prefetched(self, data_iter, steps: int):
        """One step ahead: the next batch is built and copied to the
        device on a worker thread while the current step runs."""
        q: "queue.Queue" = queue.Queue(maxsize=2)
        stop = threading.Event()

        def worker():
            try:
                for _ in range(steps):
                    if stop.is_set():
                        return
                    t0 = time.time()
                    batch = next(data_iter)
                    q.put((self.model.device_batch(batch), batch,
                           time.time() - t0))
            except Exception as e:          # re-raised in the main thread
                q.put(e)

        threading.Thread(target=worker, daemon=True).start()
        try:
            for _ in range(steps):
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()

    def _run_phase(self, epoch: int, data_iter, steps: int,
                   training: bool) -> Dict[str, float]:
        logger = self.logger
        logger.train() if training else logger.eval()
        logger.on_epoch_begin(epoch)
        log_every = max(int(getattr(self.opt, "log_every", 1) or 1), 1) \
            if training else 1
        log_time = getattr(self.opt, "log_time", False)
        sync = log_time and self.model.device.type == "cuda"
        pending = []

        def flush():
            for i0, m_dev, base in pending:
                m = {k: float(v) for k, v in m_dev.items()}
                logger.on_batch_begin(i0)
                logger.on_batch_end(i0, {**base, **m})
            pending.clear()

        t_end = time.time()
        for i, (dev_batch, batch, data_time) in enumerate(
                self._prefetched(data_iter, steps)):
            if training:
                metrics = self._train_step(dev_batch)
            else:
                metrics, pred = self.model.eval_step(dev_batch)
                self._maybe_visualize(epoch, i, pred, batch)
            if sync:
                torch.cuda.synchronize(self.model.device)
            base = {"size": self.opt.batch_size if mesh.world() > 1
                    else len(next(iter(dev_batch.values())))}
            if log_time:
                base["batch_time"] = time.time() - t_end
                base["data_time"] = data_time
            pending.append((i, metrics, base))
            if len(pending) >= log_every:
                flush()
            t_end = time.time()
        flush()
        epoch_log = self.cumulator.get_epoch_log()
        logger.on_epoch_end(epoch, epoch_log)
        return epoch_log

    def _train_step(self, dev_batch) -> Dict:
        self.steps_run += 1
        if self.steps_run != getattr(self.opt, "profile_step", 0) \
                or mesh.rank() != 0:
            return self.model.train_step(dev_batch)
        path = os.path.join(self.opt.full_logdir, "profile_step.json")
        metrics, report = profile_step(self.model, dev_batch)
        with open(path, "w") as f:
            json.dump({"step": self.steps_run, **report}, f, indent=1)
        return metrics

    def _maybe_visualize(self, epoch: int, batch_idx: int, pred: Dict,
                         batch: Dict) -> None:
        """Draw an eval batch and dump its packed output as
        ``batchNNNN.npz``, for the first ``vis_batches_vali`` batches of
        every ``vis_every_vali``-th epoch."""
        opt = self.opt
        if self.visualizer is None \
                or epoch % max(getattr(opt, "vis_every_vali", 1), 1) != 0 \
                or batch_idx >= getattr(opt, "vis_batches_vali", 0):
            return
        outdir = os.path.join(opt.full_logdir, f"epoch{epoch:04d}_vali")
        os.makedirs(outdir, exist_ok=True)
        output = self.model.pack_output(pred, batch)
        self.visualizer.visualize(output, batch_idx, outdir)
        np.savez(os.path.join(outdir, f"batch{batch_idx:04d}"),
                 **{k: v for k, v in output.items()
                    if isinstance(v, np.ndarray)})

    def train_epoch_pair(self, epoch: int, train_iter, eval_loader,
                         steps_per_epoch: int,
                         eval_batches: int) -> Dict[str, float]:
        """One train phase, then one eval phase."""
        log = self._run_phase(epoch, train_iter, steps_per_epoch,
                              training=True)
        if eval_batches:
            log = self._run_phase(epoch, iter(eval_loader), eval_batches,
                                  training=False)
        return log

    # --------------------------------------------------------------- train
    def fit(self, train_loader, eval_loader, epochs: int,
            steps_per_epoch: int, eval_batches: int,
            eval_at_start: bool = False) -> Dict[str, float]:
        self.logger.set_params({
            "epoch": epochs,
            "steps_per_epoch": steps_per_epoch,
            "steps_per_eval": eval_batches,
            "metrics": self.model.metrics,
        })
        self.logger.on_train_begin()
        if eval_at_start:
            self._run_phase(self.start_epoch, iter(eval_loader),
                            eval_batches, training=False)
        train_iter = InfiniteLoader(train_loader)
        last: Dict[str, float] = {}
        for epoch in range(self.start_epoch + 1, epochs + 1):
            last = self.train_epoch_pair(epoch, train_iter, eval_loader,
                                         steps_per_epoch, eval_batches)
        self.logger.on_train_end()
        return last


def profile_step(model, dev_batch) -> Tuple[Dict, Dict]:
    """One ``model.train_step`` under ``torch.profiler``: its metrics, and
    a report of its wall time, the process's peak device memory so far,
    its device kernels by name (launches and device ms), the gradients'
    all-reduce (the CPU side of its span, and the device time of NCCL's
    kernels), the spans of the Z halos and gathers (calls and CPU ms
    each), each model stage's span and its backward span that ran (calls,
    CPU ms, and the device ms of what was launched inside it; backward
    spans in one process only, ``utils/trace.py``) and K3's
    launches on a box or a Z slab by shape, ``BxCinxXxYxZ
    z<z_lo>+<z_out>``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cuda = model.device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    sync = (lambda: torch.cuda.synchronize(model.device)) if cuda \
        else (lambda: None)
    sync()
    shapes = dict(subpixel_kernel.slab_launches)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        metrics = model.train_step(dev_batch)
        sync()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = {e.key: {"launches": e.count,
                       "device_ms": e.self_device_time_total / 1e3}
               for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)}
    span = [e for e in events if e.key == trace.GRAD_ALL_REDUCE
            and e.device_type == DeviceType.CPU]
    spans = {e.key: {"calls": e.count, "cpu_ms": e.cpu_time_total / 1e3}
             for e in events if e.device_type == DeviceType.CPU
             and e.key in (trace.SP_HALO, trace.SP_GATHER)}
    k3_slabs = {
        "{}x{}x{}x{}x{} z{}+{}".format(*k): n - shapes.get(k, 0)
        for k, n in subpixel_kernel.slab_launches.items()
        if n > shapes.get(k, 0)}
    return metrics, {
        "rank": mesh.rank(), "world": mesh.world(), "sp": mesh.size(mesh.SP),
        "device": str(model.device),
        "backend": dist.get_backend() if mesh.joined() else None,
        "wall_ms": wall * 1e3,
        "peak_memory_gib": (torch.cuda.max_memory_allocated(model.device)
                            / 2 ** 30 if cuda else None),
        "all_reduce_grads": {
            "calls": sum(e.count for e in span),
            "cpu_ms": sum(e.cpu_time_total for e in span) / 1e3,
            "nccl_device_ms": sum(v["device_ms"] for k, v in kernels.items()
                                  if "nccl" in k.lower())},
        "spans": spans, "stages": _stage_spans(prof.events()),
        "k3_slabs": k3_slabs, "kernels": kernels}


def _stage_spans(events) -> Dict[str, Dict]:
    """Each stage span (``utils/trace.py``) and its backward span among
    the profile's events: calls, CPU ms, and device ms of the operations
    whose runtime call lies inside it, on whichever thread (autograd's
    for a backward)."""
    from torch.autograd import DeviceType
    names = {n for s in trace.STAGES
             for n in (s, s + trace.BACKWARD_SUFFIX)}
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    ranges: Dict[str, list] = {}
    for e in cpu:
        if e.name in names:
            ranges.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    launches = [(e.time_range.start, sum(k.duration for k in e.kernels))
                for e in cpu if e.kernels]
    return {name: {
        "calls": len(rs),
        "cpu_ms": sum(b - a for a, b in rs) / 1e3,
        "device_ms": sum(us for t, us in launches
                         if any(a <= t <= b for a, b in rs)) / 1e3}
        for name, rs in sorted(ranges.items())}
