"""CLI flags (counterpart of ``genre_shapehd_tpu/cli/options.py``): the
train flags, parsed in two stages (general flags, then the chosen
model's and dataset's ``add_arguments``, each of which names the
``unique_params`` that a resume does not overwrite); the test flags of
the inference path; ``--device`` for both, and for training
``--multihost`` with its transport ``--dist_backend``.
"""

from __future__ import annotations

import argparse
import pickle
from typing import Set, Tuple

from ..core.device import device_name
from ..core.registry import get_dataset, get_model


def add_train_arguments(parser: argparse.ArgumentParser) -> Set[str]:
    """The JAX package's general train flags that this package reads,
    plus ``--device``; returns the general ``unique_params``."""
    unique_params = {"resume", "epoch", "workers", "batch_size", "save_net",
                     "epoch_batches", "logdir", "device", "multihost",
                     "dist_backend", "profile_step"}
    add = parser.add_argument
    add("--manual_seed", type=int, default=None,
        help="seed of the weights, the shuffling and the augmentation")
    add("--resume", type=int, default=0,
        help="0: scratch; -1: checkpoint.pt; -2: best.pt; N>0: nets/N.pt")
    add("--suffix", default="", type=str,
        help="logdir suffix, formatted with opt vars")
    add("--epoch", type=int, default=0, help="number of epochs to train")
    add("--dataset", type=str, default=None, help="dataset alias")
    add("--workers", type=int, default=4, help="data-loading threads")
    add("--classes", default="car", type=str,
        help="ShapeNet classes: aliases or synset ids joined by '+'")
    add("--batch_size", type=int, default=16)
    add("--epoch_batches", default=None, type=int,
        help="batches used per epoch")
    add("--eval_batches", default=None, type=int,
        help="batches used for evaluation")
    add("--eval_at_start", action="store_true",
        help="evaluate before training starts")
    add("--log_time", action="store_true",
        help="log batch_time/data_time (each step then waits for the "
             "device)")
    add("--log_every", type=int, default=1,
        help="read the train metrics every N steps (same values, same "
             "order; fewer waits for the device)")
    add("--log_batch", action="store_true",
        help="write batch_loss.csv, one row per train step")
    add("--net", type=str, required=True, help="model alias")
    add("--optim", type=str, default="adam")
    add("--lr", type=float, default=1e-4)
    add("--adam_beta1", type=float, default=0.5)
    add("--adam_beta2", type=float, default=0.9)
    add("--wdecay", type=float, default=0.0)
    add("--logdir", type=str, default=None)
    add("--expr_id", type=int, default=0,
        help="experiment index; >0 refuses deletion")
    add("--save_net", type=int, default=1,
        help="save the network every N epochs")
    add("--vis_every_vali", default=1, type=int,
        help="draw the eval visualizations every N epochs")
    add("--vis_batches_vali", type=int, default=10,
        help="eval batches drawn (and dumped as .npz) an epoch; 0: none")
    add("--vis_workers", default=4, type=int,
        help="visualizer threads (0: write synchronously)")
    add("--vis_param_f", default=None, type=str,
        help='JSON file {"voxel": {"isosurf_thres": x}}')
    add("--tensorboard", action="store_true",
        help="write TensorBoard scalars (needs the tensorboardX package)")
    add("--backbone_init", type=str, default=None,
        help="checkpoint whose first net is a ResNet-18 encoder (the JAX "
             "package's ResNet18Features tree): MarrNet-1's encoder "
             "starts from it")
    add("--im_size", type=int, default=256)
    add("--vox_res", type=int, default=128)
    add("--sph_res", type=int, default=128)
    add("--z_res", type=int, default=256)
    add("--dtype", type=str, default="float32",
        choices=("float32", "bfloat16"),
        help="compute dtype of the nets and the renderer")
    add("--synthetic_length", type=int, default=64,
        help="samples per epoch of the synthetic dataset")
    add("--device", type=device_name, default="cuda",
        help="cuda (default; raises when no GPU is present), cuda:N or "
             "cpu.  Under --multihost, cuda is cuda:<LOCAL_RANK>; cuda:N "
             "puts every rank on card N")
    add("--multihost", action="store_true",
        help="data parallelism across the processes that torchrun starts "
             "(python -m torch.distributed.run --nproc_per_node N -m "
             "genre_shapehd_tpu_torch.cli.train --multihost ...): each "
             "rank loads its slice of the global --batch_size")
    add("--dist_backend", type=str, default=None, choices=("nccl", "gloo"),
        help="the ranks' transport under --multihost (default: nccl on a "
             "card, gloo on --device cpu)")
    add("--profile_step", type=int, default=0,
        help="run train step N (counted from 1 in this run) under "
             "torch.profiler on rank 0 and write its kernels and "
             "all-reduce times to <logdir>/profile_step.json; 0: none")
    return unique_params


def parse_train(argv=None) -> Tuple[argparse.Namespace, Set[str]]:
    """General flags first, then the model's and the dataset's."""
    parser = argparse.ArgumentParser(
        description="GenRe training (PyTorch port)")
    unique_params = add_train_arguments(parser)
    first, _ = parser.parse_known_args(argv)
    if first.dataset is not None:
        parser, u = get_dataset(first.dataset).add_arguments(parser)
        unique_params |= u
    parser, u = get_model(first.net).add_arguments(parser)
    unique_params |= u
    return parser.parse_args(argv), unique_params


def save_opt(logdir: str, opt: argparse.Namespace) -> None:
    """``opt.pt`` (a pickle of the options) and a readable ``opt.txt``."""
    with open(f"{logdir}/opt.pt", "wb") as f:
        pickle.dump(vars(opt), f)
    with open(f"{logdir}/opt.txt", "w") as f:
        for k in sorted(vars(opt)):
            f.write(f"{k}: {getattr(opt, k)}\n")


def overwrite_opt(opt: argparse.Namespace, saved: dict,
                  unique_params: Set[str]) -> argparse.Namespace:
    """Restore saved options except the unique params."""
    for k, v in saved.items():
        if k not in unique_params:
            setattr(opt, k, v)
    return opt


def parse_test(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="GenRe inference on photos + masks (PyTorch port)")
    p.add_argument("--net", type=str, required=True, help="model alias")
    p.add_argument("--net_file", type=str, required=True,
                   help="checkpoint in the JAX package's format")
    p.add_argument("--marrnet1_file", type=str, default=None,
                   help="(shapehd) the MarrNet-1 checkpoint")
    p.add_argument("--input_rgb", type=str, required=True,
                   help="glob pattern for rgb images (PNG)")
    p.add_argument("--input_mask", type=str, default=None,
                   help="glob pattern for object masks (PNG)")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--workers", type=int, default=4,
                   help="data-loading worker threads")
    p.add_argument("--vis_workers", type=int, default=4,
                   help="visualizer threads (0: write synchronously)")
    p.add_argument("--vis_param_f", type=str, default=None,
                   help='JSON file {"voxel": {"isosurf_thres": x}}')
    p.add_argument("--im_size", type=int, default=256)
    p.add_argument("--vox_res", type=int, default=128)
    p.add_argument("--sph_res", type=int, default=128)
    p.add_argument("--z_res", type=int, default=256)
    p.add_argument("--padding_margin", type=int, default=16)
    p.add_argument("--dtype", type=str, default="float32",
                   choices=("float32", "bfloat16"),
                   help="compute dtype of the nets and the renderer")
    p.add_argument("--device", type=device_name, default="cuda",
                   help="cuda (default; raises when no GPU is present), "
                        "cuda:N or cpu")
    opt = p.parse_args(argv)
    opt.dataset = "test"
    return opt
