"""Trilinear 3D grid sampling, ``align_corners=True`` with zero padding
(counterpart of ``genre_shapehd_tpu/ops/grid_sample.py``).

The JAX package gathers the eight corners itself; here
``F.grid_sample`` computes the same function, on the card and on the
CPU, and autograd gives its gradients with respect to the volume and the
points.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_3d(vol: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Sample a volume at normalized points with trilinear interpolation.

    vol (N, X, Y, Z); points (N, ..., 3) in [-1, 1], component 0 indexing
    X, 1 Y and 2 Z.  Returns (N, ...) in the promoted type of the two;
    points outside [-1, 1] contribute zeros.
    """
    n = vol.shape[0]
    dtype = torch.promote_types(vol.dtype, points.dtype)
    # F.grid_sample reads grid[..., 0] as the last axis (W), [..., 2] as
    # the first (D): reverse the components
    grid = points.reshape(n, -1, 1, 1, 3).flip(-1).to(dtype)
    out = F.grid_sample(vol[:, None].to(dtype), grid, mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out.reshape(points.shape[:-1])
