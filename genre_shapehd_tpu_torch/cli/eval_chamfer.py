"""Chamfer-distance evaluation between predicted and ground-truth voxel
grids (counterpart of ``tools/eval_chamfer.py``): voxel grids ->
iso-surface meshes (native extractor) -> area-weighted surface point
samples -> bidirectional Chamfer score (``ops.nndistance_score``, on the
card through the hand-written kernel K4 unless ``--device cpu``).

  python -m genre_shapehd_tpu_torch.cli.eval_chamfer \\
      --pred out/batch0000.npz --key pred_voxel --gt gt.npz --gt_key voxel \\
      [--n_points 1024] [--th 0.25] [--no_sigmoid] [--device cuda]
  python -m genre_shapehd_tpu_torch.cli.eval_chamfer \\
      --pred_dir out --gt_dir gt        # pairs out/<name>.npz, gt/<name>.npz

Prints one JSON object: ``{"chamfer_distance": x}`` or
``{"mean_chamfer_distance": x, "n_items": n, "per_item": {...}}``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops.chamfer import nndistance_score
from ..viz.mcubes import marching_cubes


def sample_surface(vol: np.ndarray, th: float, n_points: int,
                   rng: np.random.Generator) -> np.ndarray:
    """Area-weighted point samples of the iso-surface of a voxel grid,
    normalized to the unit cube centred at the origin; ``n_points`` zero
    points when the surface is empty."""
    vol = np.asarray(vol, np.float32)
    res = max(vol.shape)
    verts, faces = marching_cubes(vol, th, spacing=(1 / res,) * 3)
    if len(faces) == 0:
        return np.zeros((n_points, 3), np.float32)
    verts = verts - 0.5
    tris = verts[faces]                                   # (F, 3, 3)
    a = tris[:, 1] - tris[:, 0]
    b = tris[:, 2] - tris[:, 0]
    areas = 0.5 * np.linalg.norm(np.cross(a, b), axis=1)
    probs = areas / max(areas.sum(), 1e-12)
    idx = rng.choice(len(faces), size=n_points, p=probs)
    u = rng.random((n_points, 1))
    v = rng.random((n_points, 1))
    flip = (u + v) > 1.0
    u = np.where(flip, 1.0 - u, u)
    v = np.where(flip, 1.0 - v, v)
    return (tris[idx, 0] + u * a[idx] + v * b[idx]).astype(np.float32)


def chamfer_between_voxels(pred: np.ndarray, gt: np.ndarray,
                           th: float = 0.25, use_sigmoid: bool = True,
                           n_points: int = 1024, seed: int = 0,
                           device="cuda") -> float:
    """Standard GenRe/ShapeHD protocol: the Chamfer score between surface
    samples of the (sigmoid'ed) prediction at iso ``th`` and of the ground
    truth at iso 0.5."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    if use_sigmoid:
        pred = 1.0 / (1.0 + np.exp(-pred))
    p1 = sample_surface(pred, th, n_points, rng)
    p2 = sample_surface(gt, 0.5, n_points, rng)
    score = nndistance_score(torch.from_numpy(p1)[None].to(device),
                             torch.from_numpy(p2)[None].to(device))
    return float(score[0])


def _first_item(vol: np.ndarray) -> np.ndarray:
    return vol[0] if vol.ndim == 4 else vol


def eval_directory(pred_dir: str, gt_dir: str, key: str, gt_key: str,
                   th: float, use_sigmoid: bool, n_points: int,
                   device="cuda") -> Dict[str, float]:
    """Pair every ``<name>.npz`` in ``pred_dir`` with ``gt_dir/<name>.npz``
    and score the pair (the first item of a batched grid)."""
    results = {}
    for pred_path in sorted(glob.glob(os.path.join(pred_dir, "*.npz"))):
        name = os.path.basename(pred_path)
        gt_path = os.path.join(gt_dir, name)
        if not os.path.isfile(gt_path):
            continue
        results[name] = chamfer_between_voxels(
            _first_item(np.load(pred_path)[key]),
            _first_item(np.load(gt_path)[gt_key]), th=th,
            use_sigmoid=use_sigmoid, n_points=n_points, device=device)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Chamfer distance between voxel grids (PyTorch port)")
    ap.add_argument("--pred", default=None)
    ap.add_argument("--key", default="pred_voxel")
    ap.add_argument("--gt", default=None)
    ap.add_argument("--gt_key", default="voxel")
    ap.add_argument("--pred_dir", default=None,
                    help="directory of per-item .npz predictions")
    ap.add_argument("--gt_dir", default=None,
                    help="directory of matching .npz ground truths")
    ap.add_argument("--th", type=float, default=0.25)
    ap.add_argument("--n_points", type=int, default=1024)
    ap.add_argument("--no_sigmoid", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default) raises when no GPU is present")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.pred_dir:
        if not args.gt_dir:
            ap.error("--pred_dir requires --gt_dir")
        results = eval_directory(args.pred_dir, args.gt_dir, args.key,
                                 args.gt_key, args.th, not args.no_sigmoid,
                                 args.n_points, device)
        mean = float(np.mean(list(results.values()))) if results else None
        print(json.dumps({"mean_chamfer_distance": mean,
                          "n_items": len(results), "per_item": results}))
        return 0

    if not (args.pred and args.gt):
        ap.error("--pred/--gt or --pred_dir/--gt_dir")
    cd = chamfer_between_voxels(
        _first_item(np.load(args.pred)[args.key]),
        _first_item(np.load(args.gt)[args.gt_key]), th=args.th,
        use_sigmoid=not args.no_sigmoid, n_points=args.n_points,
        device=device)
    print(json.dumps({"chamfer_distance": cd}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
