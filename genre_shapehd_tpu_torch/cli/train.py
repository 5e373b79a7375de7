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
"""

from __future__ import annotations

import os
import pickle
import shutil
import sys

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.registry import get_dataset, get_model
from ..data.loader import DataLoader
from ..train.loggers import (BatchCsvLogger, ComposeLogger, CsvLogger,
                             ModelSaveLogger, ProgbarLogger,
                             TensorBoardLogger, TerminateOnNaN)
from ..train.loop import Trainer
from ..viz.visualizer import Visualizer
from . import options


def make_logdir(opt) -> str:
    """Logdir templating and the clobber guard: an existing logdir of a
    scratch run is deleted only for ``expr_id <= 0``."""
    name = f"{opt.net}_{opt.dataset}_{opt.lr}"
    if opt.suffix:
        name += "_" + opt.suffix.format(**vars(opt))
    logdir = os.path.join(opt.logdir, name, str(opt.expr_id))
    if os.path.isdir(logdir) and opt.resume == 0:
        if opt.expr_id > 0:
            raise RuntimeError(
                f"logdir {logdir} exists with positive expr_id; refusing to "
                "overwrite -- use expr_id <= 0 for scratch runs")
        print(f"[setup] overwriting existing logdir {logdir}")
        shutil.rmtree(logdir)
    os.makedirs(logdir, exist_ok=True)
    return logdir


def main(argv=None) -> int:
    opt, unique_params = options.parse_train(argv)
    resolve_device(opt.device)           # no GPU with --device cuda: raise
    if opt.logdir is None:
        raise ValueError("--logdir is required")
    seed = opt.manual_seed or 0
    torch.manual_seed(seed)

    opt.full_logdir = make_logdir(opt)
    # a resume keeps the saved options except the unique params
    if opt.resume != 0 and os.path.isfile(f"{opt.full_logdir}/opt.pt"):
        with open(f"{opt.full_logdir}/opt.pt", "rb") as f:
            opt = options.overwrite_opt(opt, pickle.load(f), unique_params)
    options.save_opt(opt.full_logdir, opt)

    model = get_model(opt.net)(opt)
    print("[setup] model", type(model).__module__, "on", model.device, "in",
          opt.dtype)
    loggers = [ProgbarLogger(), CsvLogger(f"{opt.full_logdir}/epoch_loss.csv"),
               TerminateOnNaN()]
    if opt.log_batch:
        loggers.append(BatchCsvLogger(f"{opt.full_logdir}/batch_loss.csv"))
    if opt.tensorboard:
        loggers.append(TensorBoardLogger(f"{opt.full_logdir}/tensorboard"))
    logger = ComposeLogger(loggers)
    visualizer = Visualizer(n_workers=opt.vis_workers,
                            param_f=opt.vis_param_f) \
        if opt.vis_batches_vali > 0 else None
    trainer = Trainer(model, opt, logger, visualizer=visualizer)
    trainer.initialize(seed)

    # checkpoints: the latest every epoch, snapshots every --save_net
    # epochs, the best on the eval loss
    save = lambda p, e: trainer.save(p, e)                 # noqa: E731
    logger.add_logger(ModelSaveLogger(f"{opt.full_logdir}/checkpoint.pt",
                                      period=1, save_fn=save))
    if opt.save_net:
        logger.add_logger(ModelSaveLogger(
            opt.full_logdir + "/nets/{epoch:04d}.pt", period=opt.save_net,
            save_fn=save))
    best_logger = ModelSaveLogger(f"{opt.full_logdir}/best.pt",
                                  save_best_only=True, save_fn=save)
    logger.add_logger(best_logger)
    if opt.resume != 0:
        trainer.maybe_resume(opt.full_logdir, opt.resume)
        best_logger.best = trainer.initial_loss_eval
        print("[setup] resumed at epoch", trainer.start_epoch)

    dataset_cls = get_dataset(opt.dataset)
    ds_train = dataset_cls(opt, mode="train", model=model)
    ds_vali = dataset_cls(opt, mode="vali", model=model)
    train_loader = DataLoader(ds_train, opt.batch_size, opt.workers,
                              shuffle=True, seed=seed, drop_last=True)
    vali_loader = DataLoader(ds_vali, opt.batch_size, opt.workers,
                             drop_last=True)
    steps = opt.epoch_batches or len(train_loader)
    eval_steps = min(opt.eval_batches if opt.eval_batches is not None
                     else len(vali_loader), len(vali_loader))
    print(f"[setup] {len(ds_train)} train / {len(ds_vali)} vali samples; "
          f"{steps} steps/epoch, {eval_steps} eval batches")
    try:
        trainer.fit(train_loader, vali_loader, epochs=opt.epoch,
                    steps_per_epoch=steps, eval_batches=eval_steps,
                    eval_at_start=opt.eval_at_start)
    finally:
        if visualizer is not None:
            visualizer.close()      # waits; re-raises a drawing's failure
    return 0


if __name__ == "__main__":
    sys.exit(main())
