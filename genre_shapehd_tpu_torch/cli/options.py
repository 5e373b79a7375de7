"""Test-time CLI flags (the inference subset of
``genre_shapehd_tpu/cli/options.py``) plus ``--device``."""

from __future__ import annotations

import argparse


def parse_test(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="GenRe inference on photos + masks (PyTorch port)")
    p.add_argument("--net", type=str, required=True, help="model alias")
    p.add_argument("--net_file", type=str, required=True,
                   help="checkpoint in the JAX package's format")
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
    p.add_argument("--device", type=str, default="cuda",
                   choices=("cuda", "cpu"),
                   help="cuda (default) raises when no GPU is present")
    opt = p.parse_args(argv)
    opt.dataset = "test"
    return opt
