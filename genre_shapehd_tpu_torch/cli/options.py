"""CLI flags (counterpart of ``genre_shapehd_tpu/cli/options.py``): the
train flags, parsed in two stages (general flags, then the chosen
model's and dataset's ``add_arguments``, each of which names the
``unique_params`` that a resume does not overwrite; ``--printhelp``
prints the help of all of them); the test flags, the general ones and
the inference path's I/O parsed the same way with the model's; so the
command lines of ``scripts/*.sh`` run with the module swapped.
``--device`` for both, and for training ``--multihost`` with its
transport ``--dist_backend`` and ``--sp``.
"""

from __future__ import annotations

import argparse
import pickle
from typing import Optional, Set, Tuple

from ..core.device import device_name
from ..core.registry import get_dataset, get_model


def add_train_arguments(parser: argparse.ArgumentParser) -> Set[str]:
    """The JAX package's general train flags that this package reads,
    plus ``--device``; returns the general ``unique_params``."""
    unique_params = {"resume", "epoch", "workers", "batch_size", "save_net",
                     "epoch_batches", "logdir", "device", "multihost",
                     "dist_backend", "profile_step", "sp"}
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
    add("--sp", type=int, default=1,
        help="spatial-parallel mesh width: devices form a "
             "(n_devices/sp, sp) mesh and large voxel activations shard "
             "their Z axis across sp (needs --multihost and a number of "
             "ranks that sp divides; GenRe's 3D U-Net shards, the rest "
             "runs on every sp rank)")
    add("--profile_step", type=int, default=0,
        help="run train step N (counted from 1 in this run) under "
             "torch.profiler on rank 0 and write its kernels, "
             "all-reduce times and each stage's forward and backward "
             "spans to <logdir>/profile_step.json; 0: none")
    return unique_params


def train_parser(net: str, dataset: Optional[str] = None
                 ) -> Tuple[argparse.ArgumentParser, Set[str]]:
    """The train parser with the general flags, ``--printhelp``, and the
    flags of ``dataset`` (if any) and of model ``net``; and the
    ``unique_params``."""
    parser = argparse.ArgumentParser(
        description="GenRe training (PyTorch port)")
    unique_params = add_train_arguments(parser)
    parser.add_argument("--printhelp", action="store_true",
                        help="print the help, the model's and the "
                             "dataset's flags included, and exit")
    if dataset is not None:
        parser, u = get_dataset(dataset).add_arguments(parser)
        unique_params |= u
    parser, u = get_model(net).add_arguments(parser)
    return parser, unique_params | u


def parse_train(argv=None) -> Tuple[argparse.Namespace, Set[str]]:
    """General flags first, then the model's and the dataset's;
    ``--printhelp`` prints the help of all of them and exits 0."""
    general = argparse.ArgumentParser(add_help=False)
    add_train_arguments(general)
    general.add_argument("--printhelp", action="store_true")
    first, _ = general.parse_known_args(argv)
    parser, unique_params = train_parser(first.net, first.dataset)
    if first.printhelp:
        parser.print_help()
        raise SystemExit(0)
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


def test_parser(net: str) -> argparse.ArgumentParser:
    """The test parser: the general flags, the inference path's I/O and
    the flags of test model ``net``."""
    p = argparse.ArgumentParser(
        description="GenRe inference on photos + masks (PyTorch port)")
    add_train_arguments(p)
    p.add_argument("--input_rgb", type=str, required=True,
                   help="glob pattern for rgb images (PNG)")
    p.add_argument("--input_mask", type=str, default=None,
                   help="glob pattern for object masks (PNG)")
    p.add_argument("--net_file", type=str, required=True,
                   help="checkpoint in the JAX package's format")
    p.add_argument("--output_dir", type=str, required=True,
                   help="output directory, with _<--suffix> appended")
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--marrnet1_file", type=str, default=None,
                   help="(shapehd) the MarrNet-1 checkpoint")
    return get_model(net, test=True).add_arguments(p)[0]


def parse_test(argv=None) -> argparse.Namespace:
    """The general flags and the inference path's I/O first, then the
    model's (as the JAX ``parse_test``); the dataset is ``test``."""
    general = argparse.ArgumentParser(add_help=False)
    add_train_arguments(general)
    first, _ = general.parse_known_args(argv)
    opt = test_parser(first.net).parse_args(argv)
    opt.dataset = "test"
    return opt
