"""Reprojection-consistency loss between a voxel grid and surface samples
(counterpart of ``genre_shapehd_tpu/ops/reproj.py``; no model trains on
it).  For each surface sample x0 with the shared normal n0, the voxel
nearest x0 should be occupied, and the voxels closer than ``alpha * l``
to the sample's normal line should be empty, weighted by closeness."""

from __future__ import annotations

import math

import torch


def reprojection_loss(v: torch.Tensor, x: torch.Tensor, x0: torch.Tensor,
                      n0: torch.Tensor, l: float,
                      alpha: float = math.sqrt(2) / 2, beta: float = 1.0,
                      gamma: float = 1.0) -> torch.Tensor:
    """v (V,) voxel occupancies (a flattened grid); x (V, 3) voxel
    centres; x0 (S, 3) surface samples; n0 (3,) normal (divided by its
    squared norm, as the JAX package does); l the voxel edge."""
    v = v.reshape(-1)
    x = x.reshape(-1, 3)
    n0 = n0 / (n0 ** 2).sum()

    diff = x[:, None, :] - x0[None, :, :]              # (V, S, 3)
    sq = (diff ** 2).sum(dim=2)                        # (V, S)
    i0 = torch.argmin(sq, dim=0)                       # (S,)
    loss_1 = ((1.0 - v[i0]) ** 2).sum()

    d = torch.linalg.norm(torch.linalg.cross(
        diff, n0.expand_as(diff), dim=2), dim=2)
    mask_near = (d < alpha * l).to(v.dtype)
    # each sample's nearest voxel is left out of the second term
    vs = torch.arange(v.shape[0], device=v.device)
    mask_not_nearest = 1.0 - (vs[:, None] == i0[None, :]).to(v.dtype)
    w = gamma * (1.0 - d / (alpha * l)) ** beta
    loss_2 = (w * (v[:, None] ** 2) * mask_near * mask_not_nearest).sum()
    return loss_1 + loss_2
