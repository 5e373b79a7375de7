"""Spherical-map helpers (counterpart of ``genre_shapehd_tpu/ops/sph.py``)."""

from __future__ import annotations

import numpy as np
import torch


def gen_sph_grid(res: int = 128) -> np.ndarray:
    """Unit-sphere direction grid, (res, res, 3) float32.

    Latitudes phi are the midpoints of ``linspace(0, 180, 2*res+1)``,
    longitudes theta are ``linspace(0, 360, res+1)[:-1]``;
    direction = (sin(phi)cos(theta), sin(phi)sin(theta), cos(phi)).
    """
    phi = np.deg2rad(np.linspace(0.0, 180.0, res * 2 + 1)[1::2])
    theta = np.deg2rad(np.linspace(0.0, 360.0, res + 1)[:-1])
    sin_phi = np.sin(phi)[:, None]
    grid = np.stack(
        [sin_phi * np.cos(theta)[None, :],
         sin_phi * np.sin(theta)[None, :],
         np.broadcast_to(np.cos(phi)[:, None], (res, res))],
        axis=-1)
    return grid.astype(np.float32)


def sph_pad(sph_nhwc: torch.Tensor, padding_margin: int = 16) -> torch.Tensor:
    """(N, H, W, C) square map -> (N, H+2m, W+2m, C): replicate the pole
    rows first, then wrap the longitude columns (which therefore carry the
    replicated rows with them)."""
    m = padding_margin
    n, h, w, c = sph_nhwc.shape
    assert h == w, "spherical maps are square (lat x lon)"
    rows = torch.cat([sph_nhwc[:, :1].expand(n, m, w, c), sph_nhwc,
                      sph_nhwc[:, -1:].expand(n, m, w, c)], dim=1)
    return torch.cat([rows[:, :, w - m:], rows, rows[:, :, :m]], dim=2)


def sph_pad_numpy(sph_chw: np.ndarray, padding_margin: int = 16) -> np.ndarray:
    """Host-side twin of :func:`sph_pad` for (C, H, W) ground truths: wrap
    the longitude columns, then replicate the pole rows."""
    m = padding_margin
    out = np.pad(sph_chw, ((0, 0), (0, 0), (m, m)), "wrap")
    return np.pad(out, ((0, 0), (m, m), (0, 0)), "edge")
