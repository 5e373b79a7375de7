"""Voxel-grid utilities (counterpart of the in-graph part of
``genre_shapehd_tpu/ops/voxel.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def binary_erosion(vox: torch.Tensor, iterations: int = 2) -> torch.Tensor:
    """3x3x3 binary erosion of (..., X, Y, Z) grids in {0, 1}: zero
    padding, then min-pooling, so border voxels always erode (scipy's
    ``border_value=0``)."""
    lead = vox.shape[:-3]
    out = vox.reshape((-1, 1) + vox.shape[-3:])
    for _ in range(iterations):
        out = -F.max_pool3d(-F.pad(out, (1,) * 6), 3, stride=1)
    return out.reshape(lead + vox.shape[-3:])


def surface_from_solid(vox: torch.Tensor, iterations: int = 2
                       ) -> torch.Tensor:
    """Surface shell ``clip(v - erosion(v), 0, 1)`` of solid grids."""
    return torch.clamp(vox - binary_erosion(vox, iterations), 0.0, 1.0)
