"""Chamfer / nearest-neighbour distance between point clouds (counterpart
of ``genre_shapehd_tpu/ops/chamfer.py`` and of the kernel-backed
``nndistance_pallas`` / ``nndistance_score_pallas``).

  nndistance        -> (dist1, dist2) squared NN distances per point
  nndistance_w_idx  -> (dist1, dist2, idx1, idx2)
  nndistance_score  -> mean sqrt(dist1) + mean sqrt(dist2)

CUDA clouds go through the hand-written kernel K4, CPU clouds through its
plain version (``ops/cuda/chamfer_kernel.py``); both are differentiable.
``block`` bounds the plain version's (P1, block) temporary; the kernel
never forms one.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .cuda.chamfer_kernel import nn_min_dist


def nndistance_w_idx(x1: torch.Tensor, x2: torch.Tensor, block: int = 4096
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """x1 (B, P1, 3), x2 (B, P2, 3) -> dist1 (B, P1) = min_j |x1_i - x2_j|²,
    dist2 (B, P2), and the int32 indices of the minima."""
    return nn_min_dist(x1, x2, block)


def nndistance(x1: torch.Tensor, x2: torch.Tensor, block: int = 4096
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional squared nearest-neighbour distances."""
    d1, d2, _, _ = nn_min_dist(x1, x2, block)
    return d1, d2


def nndistance_score(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """mean sqrt(d1) + mean sqrt(d2) per batch."""
    d1, d2 = nndistance(x1, x2)
    return (torch.sqrt(d1 + 1e-20).mean(dim=1)
            + torch.sqrt(d2 + 1e-20).mean(dim=1))
