"""The exact spherical renderer: (N, X, Y, Z) occupancy -> (N, R, R)
expected depth (counterpart of ``genre_shapehd_tpu/ops/render_sph.py``).

Rays start on a radius-2 shell (normalized [-1, 1] cube coordinates) at
each (lat, lon) direction of :func:`ops.sph.gen_sph_grid` and march
``z_res`` evenly spaced samples to the origin; the volume is probed
trilinearly (:func:`ops.grid_sample.grid_sample_3d`), the probabilities
clipped to [1e-5, 1 - 1e-5] and turned into first-hit probabilities,
and

    E[d] = sum_z stop[z] * z / (z_res - 1)  +  prod_z (1 - p[z])

(background depth 1).  It samples each ray point exactly where the fast
renderer (``ops/render_sph_fast.py``, CUDA kernels K1 and K2) factors
the resampling through cylindrical coordinates; ``--exact_render``
selects it.  Differentiable with respect to the volume.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .grid_sample import grid_sample_3d
from .sph import gen_sph_grid
from .stop_prob import stop_probability


@functools.lru_cache(maxsize=8)
def _ray_points(sph_res: int, z_res: int) -> np.ndarray:
    """Static (sph_res, sph_res, z_res, 3) float32 ray points in [-2, 2]."""
    dirs = gen_sph_grid(sph_res) * 2.0                       # (R, R, 3)
    alpha = np.linspace(0.0, 1.0, z_res, dtype=np.float32)   # (Z,)
    pts = dirs[:, :, None, :] * (1.0 - alpha)[None, None, :, None]
    return pts.astype(np.float32)


def render_spherical(vox: torch.Tensor, sph_res: int = 128,
                     z_res: int = 256) -> torch.Tensor:
    """vox (N, X, Y, Z) occupancy probabilities (callers clip them to
    [1e-5, 1 - 1e-5]) -> (N, sph_res, sph_res) expected depth in [0, 1+],
    background ~1.  The samples are float32 (or float64 for a float64
    volume); the depth weights are built in ``vox.dtype``."""
    n = vox.shape[0]
    pts = torch.from_numpy(_ray_points(sph_res, z_res)).to(vox.device)
    pts = pts[None].expand((n,) + pts.shape)
    prob = grid_sample_3d(vox, pts)                          # (N, R, R, Z)
    prob = torch.clamp(prob, 1e-5, 1.0 - 1e-5)
    stop = stop_probability(prob, dim=-1)
    depth_w = torch.linspace(0.0, 1.0, z_res, dtype=vox.dtype,
                             device=vox.device).to(stop.dtype)
    return (stop * depth_w).sum(-1) + torch.prod(1.0 - prob, dim=-1)
