"""Train entry point (counterpart of ``genre_shapehd_tpu/cli/train.py``);
it takes the command lines of the JAX package's ``scripts/train_*.sh``.

  python -m genre_shapehd_tpu_torch.cli.train --net marrnet1 \\
      --pred_depth_minmax --dataset shapenet --classes chair \\
      --data_root <ShapeNet renderings> --batch_size 4 \\
      --epoch_batches 2500 --eval_batches 5 --log_time --optim adam \\
      --lr 1e-3 --epoch 1000 --vis_batches_vali 10 --save_net 10 \\
      --workers 4 --logdir output/marrnet1 --suffix '{classes}' \\
      [--tensorboard] [--dtype bfloat16] [--device cuda]

Writes under ``<logdir>/<net>_<dataset>_<lr>[_<suffix>]/<expr_id>/``:
``opt.pt`` / ``opt.txt``, ``epoch_loss.csv`` (``batch_loss.csv`` with
``--log_batch``), ``checkpoint.pt`` every epoch, ``nets/NNNN.pt`` every
``--save_net`` epochs and ``best.pt`` on the eval loss -- checkpoints in
the JAX package's format, which either package's ``cli.test`` reads;
``epochNNNN_vali/`` with the visualizations and ``batchNNNN.npz`` of the
first ``--vis_batches_vali`` eval batches; ``tensorboard/`` under
``--tensorboard`` (needs tensorboardX).  ``--resume -1`` continues from
``checkpoint.pt``, Adam's state included.

On N cards, one process each (``--batch_size`` stays the global batch;
each rank loads its slice of it):

  python -m torch.distributed.run --nproc_per_node N \\
      -m genre_shapehd_tpu_torch.cli.train --multihost <the flags above>

With ``--sp S`` the ranks form a (N / S, S) grid: the S ranks of a dp
index load the same slice, and GenRe's 3D U-Net runs on Z slabs across
them (``parallel/mesh.py``, ``nn/unet3d.py``); other models replicate
over sp.  S must divide N (the JAX package drops the spare devices
instead).  On the CPU, two ranks of one process each:

  python -m torch.distributed.run --nproc_per_node 2 \\
      -m genre_shapehd_tpu_torch.cli.train --multihost --sp 2 \\
      --device cpu --dist_backend gloo <the flags above>

Rank 0 alone writes the logdir; its checkpoints have the format of a
one-process run's.  Each rank ends with a line ``[dp] rank r of N:
parameters and buffers sha1 <hex>[; peak device memory <x> GiB]; kernel
launches {...}`` (the hand-written kernels' launch counts of its run).
Rank 0's last line before it, ``[launches] {...}``, gives those counts
with K3's by shape and the peak device memory
(``ops/cuda/__init__.py::launch_line``).
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import sys

import torch

from ..core.device import resolve_device
from ..core.registry import get_dataset, get_model
from ..data.loader import DataLoader
from ..ops.cuda import launch_counts, launch_line
from ..parallel import mesh
from ..train.loggers import (BatchCsvLogger, ComposeLogger, CsvLogger,
                             ModelSaveLogger, ProgbarLogger,
                             TensorBoardLogger, TerminateOnNaN)
from ..train.loop import Trainer
from ..viz.visualizer import Visualizer
from . import options


def make_logdir(opt) -> str:
    """Logdir templating and the clobber guard: an existing logdir of a
    scratch run is deleted only for ``expr_id <= 0``.  In a group every
    rank checks, rank 0 alone deletes and makes it, and every rank waits
    for that."""
    name = f"{opt.net}_{opt.dataset}_{opt.lr}"
    if opt.suffix:
        name += "_" + opt.suffix.format(**vars(opt))
    logdir = os.path.join(opt.logdir, name, str(opt.expr_id))
    clobber = os.path.isdir(logdir) and opt.resume == 0
    if clobber and opt.expr_id > 0:
        raise RuntimeError(
            f"logdir {logdir} exists with positive expr_id; refusing to "
            "overwrite -- use expr_id <= 0 for scratch runs")
    mesh.barrier()              # every rank has looked before it changes
    if mesh.rank() == 0:
        if clobber:
            print(f"[setup] overwriting existing logdir {logdir}")
            shutil.rmtree(logdir)
        os.makedirs(logdir, exist_ok=True)
    mesh.barrier()
    return logdir


def main(argv=None) -> int:
    opt, unique_params = options.parse_train(argv)
    if not opt.multihost and mesh.launched_world() > 1:
        raise RuntimeError(
            f"{mesh.launched_world()} processes were launched without "
            "--multihost; pass it, or each would train a copy of its own")
    if opt.dist_backend is not None and not opt.multihost:
        raise ValueError("--dist_backend needs --multihost")
    if opt.sp != 1 and not opt.multihost:
        raise ValueError(f"--sp {opt.sp} needs --multihost: the Z slabs "
                         "of --sp are held by the ranks of a group")
    # no GPU with --device cuda: raise
    device = resolve_device(opt.device, mesh.local_rank()
                            if opt.multihost else None)
    if opt.logdir is None:
        raise ValueError("--logdir is required")
    if not opt.multihost:
        return train(opt, unique_params)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    opt.device = str(device)
    mesh.join(opt.dist_backend or ("nccl" if device.type == "cuda"
                                   else "gloo"), device, sp=opt.sp)
    try:
        return train(opt, unique_params)
    finally:
        mesh.leave()


def train(opt, unique_params) -> int:
    """Set up and run the training of ``opt``: on every rank of a group,
    where rank 0 alone writes the logdir."""
    seed = opt.manual_seed or 0
    torch.manual_seed(seed)
    lead = mesh.rank() == 0

    opt.full_logdir = make_logdir(opt)
    # a resume keeps the saved options except the unique params
    if opt.resume != 0 and os.path.isfile(f"{opt.full_logdir}/opt.pt"):
        with open(f"{opt.full_logdir}/opt.pt", "rb") as f:
            opt = options.overwrite_opt(opt, pickle.load(f), unique_params)
    mesh.barrier()                  # every rank has read opt.pt
    if lead:
        options.save_opt(opt.full_logdir, opt)

    model = get_model(opt.net)(opt)
    if lead:
        print("[setup] model", type(model).__module__, "on", model.device,
              "in", opt.dtype, *([
                  "on", mesh.world(), "ranks", f"(dp {mesh.size(mesh.DP)} "
                  f"x sp {mesh.size(mesh.SP)})"] if opt.multihost else []))
    # rank 0 writes; every rank stops on a NaN, which all of them see
    loggers = [TerminateOnNaN()]
    if lead:
        loggers = [ProgbarLogger(),
                   CsvLogger(f"{opt.full_logdir}/epoch_loss.csv")] + loggers
        if opt.log_batch:
            loggers.append(BatchCsvLogger(f"{opt.full_logdir}/batch_loss.csv"))
        if opt.tensorboard:
            loggers.append(TensorBoardLogger(f"{opt.full_logdir}/tensorboard"))
    logger = ComposeLogger(loggers)
    visualizer = Visualizer(n_workers=opt.vis_workers,
                            param_f=opt.vis_param_f) \
        if lead and opt.vis_batches_vali > 0 else None
    trainer = Trainer(model, opt, logger, visualizer=visualizer)
    trainer.initialize(seed)

    # checkpoints: the latest every epoch, snapshots every --save_net
    # epochs, the best on the eval loss
    save = lambda p, e: trainer.save(p, e)                 # noqa: E731
    best_logger = ModelSaveLogger(f"{opt.full_logdir}/best.pt",
                                  save_best_only=True, save_fn=save)
    if lead:
        logger.add_logger(ModelSaveLogger(
            f"{opt.full_logdir}/checkpoint.pt", period=1, save_fn=save))
        if opt.save_net:
            logger.add_logger(ModelSaveLogger(
                opt.full_logdir + "/nets/{epoch:04d}.pt",
                period=opt.save_net, save_fn=save))
        logger.add_logger(best_logger)
    if opt.resume != 0:
        trainer.maybe_resume(opt.full_logdir, opt.resume)
        best_logger.best = trainer.initial_loss_eval
        if lead:
            print("[setup] resumed at epoch", trainer.start_epoch)

    dataset_cls = get_dataset(opt.dataset)
    ds_train = dataset_cls(opt, mode="train", model=model)
    ds_vali = dataset_cls(opt, mode="vali", model=model)
    # every rank draws the same batches and loads its dp index's slice of
    # each (the sp ranks of a dp index load the same one)
    shard = dict(shard_id=mesh.index(mesh.DP),
                 num_shards=mesh.size(mesh.DP))
    train_loader = DataLoader(ds_train, opt.batch_size, opt.workers,
                              shuffle=True, seed=seed, drop_last=True,
                              **shard)
    vali_loader = DataLoader(ds_vali, opt.batch_size, opt.workers,
                             drop_last=True, **shard)
    steps = opt.epoch_batches or len(train_loader)
    eval_steps = min(opt.eval_batches if opt.eval_batches is not None
                     else len(vali_loader), len(vali_loader))
    if lead:
        print(f"[setup] {len(ds_train)} train / {len(ds_vali)} vali "
              f"samples; {steps} steps/epoch, {eval_steps} eval batches")
    try:
        trainer.fit(train_loader, vali_loader, epochs=opt.epoch,
                    steps_per_epoch=steps, eval_batches=eval_steps,
                    eval_at_start=opt.eval_at_start)
    finally:
        if visualizer is not None:
            visualizer.close()      # waits; re-raises a drawing's failure
    if lead:
        print(launch_line(model.device), flush=True)
    if opt.multihost:
        peak = (f"; peak device memory "
                f"{torch.cuda.max_memory_allocated(model.device) / 2**30:.3f}"
                f" GiB" if model.device.type == "cuda" else "")
        print(f"[dp] rank {mesh.rank()} of {mesh.world()}: parameters and "
              f"buffers sha1 "
              f"{mesh.state_digest(model.net_modules().values())}{peak}; "
              f"kernel launches {json.dumps(launch_counts())}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
