"""Voxel-grid utilities (counterpart of ``genre_shapehd_tpu/ops/voxel.py``):
host-side numpy and ``scipy.ndimage`` helpers for dataset work --
downsampling, bounds, alignment, translation, linear resampling,
solidification and surface shells -- and the in-graph erosion and
surface shell of the training loss in torch."""

from __future__ import annotations

import numpy as np
import scipy.ndimage as ndi
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------- host side

def downsample(vox: np.ndarray, times: int, use_max: bool = True
               ) -> np.ndarray:
    """2x block-downsample ``times`` times (max or mean pooling)."""
    for _ in range(times):
        d = vox.shape[0] // 2
        blocks = vox[:2 * d, :2 * d, :2 * d].reshape(d, 2, d, 2, d, 2)
        vox = blocks.max(axis=(1, 3, 5)) if use_max \
            else blocks.mean(axis=(1, 3, 5))
    return vox


def find_bound(vox: np.ndarray, th: float = 0.0) -> np.ndarray:
    """(3, 2) min / max occupied index per axis (zeros when empty)."""
    occ = np.argwhere(vox > th)
    if occ.size == 0:
        return np.zeros((3, 2), dtype=np.int64)
    return np.stack([occ.min(axis=0), occ.max(axis=0)], axis=1)


def bounding_box_align(vox_a: np.ndarray, vox_b: np.ndarray,
                       th: float = 0.0) -> np.ndarray:
    """Translate ``vox_a`` so that its occupied bounding box's centre
    meets ``vox_b``'s."""
    ba = find_bound(vox_a, th)
    bb = find_bound(vox_b, th)
    shift = np.round((bb.mean(axis=1) - ba.mean(axis=1))).astype(int)
    return translate(vox_a, shift)


def translate(vox: np.ndarray, shift: np.ndarray) -> np.ndarray:
    """Integer translation with zero fill."""
    out = np.zeros_like(vox)
    src = [slice(max(0, -s), vox.shape[i] - max(0, s))
           for i, s in enumerate(shift)]
    dst = [slice(max(0, s), vox.shape[i] - max(0, -s))
           for i, s in enumerate(shift)]
    out[tuple(dst)] = vox[tuple(src)]
    return out


def transform_by_matrix(vox: np.ndarray, mat: np.ndarray,
                        order: int = 1) -> np.ndarray:
    """Resample a grid under a 3x3 linear map about its centre
    (``scipy.ndimage.affine_transform`` with the inverse map, zero
    outside)."""
    centre = (np.asarray(vox.shape, dtype=np.float64) - 1.0) / 2.0
    inv = np.linalg.inv(mat)
    offset = centre - inv @ centre
    return ndi.affine_transform(vox, inv, offset=offset, order=order,
                                mode="constant", cval=0.0)


def fill_solid(vox: np.ndarray, th: float = 0.5) -> np.ndarray:
    """Solidify a surface voxelization: every cell that empty space does
    not connect to the border becomes occupied."""
    return ndi.binary_fill_holes(vox > th).astype(vox.dtype)


def surface_from_solid_np(vox: np.ndarray, iterations: int = 2
                          ) -> np.ndarray:
    """Host twin of :func:`surface_from_solid`:
    ``clip(v - erosion(v, ones(3, 3, 3), iterations), 0, 1)``."""
    er = ndi.binary_erosion(vox, structure=np.ones((3, 3, 3)),
                            iterations=iterations).astype(vox.dtype)
    return np.clip(vox - er, 0.0, 1.0)


# ------------------------------------------------------------ torch side

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
