"""Spherical backprojection: spherical depth map -> voxel distance field
(counterpart of ``genre_shapehd_tpu/ops/spherical_bp.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .camera_bp import _scatter_mean_tdf
from .sph import gen_sph_grid


def spherical_backproject(sph_depth: torch.Tensor,
                          grid: Optional[torch.Tensor] = None,
                          res: int = 128
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, R, R) spherical depths (<0 discarded) -> (tdf, cnt), each
    (N, res, res, res); tdf is 0 where no point landed."""
    n, rh, rw = sph_depth.shape
    if grid is None:
        grid = torch.as_tensor(gen_sph_grid(rh), dtype=sph_depth.dtype,
                               device=sph_depth.device)
    glob = (grid[None] * sph_depth[..., None]).reshape(n, rh * rw, 3)
    valid = (sph_depth >= 0.0).reshape(n, rh * rw)
    return _scatter_mean_tdf(glob, valid, res, background=0.0)


def backproject_spherical_masked(sph_full: torch.Tensor, margin: int = 16,
                                 res: int = 128) -> torch.Tensor:
    """GenRe's use of the op: crop the padding margin off the (N, H, W)
    map, backproject ``1 - crop``, map the field with
    ``(-df + 1/res) * res`` and zero the voxels that received no hit."""
    h, w = sph_full.shape[1], sph_full.shape[2]
    crop = sph_full[:, margin:h - margin, margin:w - margin]
    proj_df, cnt = spherical_backproject(1.0 - crop, res=res)
    mask = torch.clamp(cnt, 0.0, 1.0)
    return (-proj_df + 1.0 / res) * res * mask
