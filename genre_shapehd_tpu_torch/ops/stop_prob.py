"""First-hit ("stop") probability along a ray
(counterpart of ``genre_shapehd_tpu/ops/stop_prob.py``)."""

from __future__ import annotations

import torch


def stop_probability(p: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """stop[z] = p[z] * prod_{i<z} (1 - p[i]) along ``dim`` (exclusive
    cumprod).  Callers clamp ``p`` away from {0, 1}."""
    cum = torch.cumprod(1.0 - p, dim=dim)
    ones = torch.ones_like(cum.narrow(dim, 0, 1))
    excl = torch.cat([ones, cum.narrow(dim, 0, p.shape[dim] - 1)], dim=dim)
    return p * excl
