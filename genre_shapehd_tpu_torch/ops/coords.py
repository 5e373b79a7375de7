"""Frame conventions between the image, camera-backprojection and voxel
frames (counterpart of ``genre_shapehd_tpu/ops/coords.py``).

Layouts: images (N, H, W[, C]); voxels (N, X, Y, Z) on the cube
[-0.5, 0.5]^3.
"""

from __future__ import annotations

import torch


def depth_image_to_cambp_frame(depth_nhw: torch.Tensor) -> torch.Tensor:
    """(N, H, W) image-frame depth -> (N, W, H) transposed, then flipped
    along the new axis 1 -- the frame ``camera_backproject`` expects."""
    return torch.flip(depth_nhw.transpose(1, 2), dims=(1,))


def gt_voxel_to_train_frame(vox_xyz: torch.Tensor) -> torch.Tensor:
    """(..., X, Y, Z): swap the last two axes, then flip the last."""
    return torch.flip(vox_xyz.transpose(-2, -1), dims=(-1,))


def train_frame_to_gt_voxel(vox_xyz: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`gt_voxel_to_train_frame`: flip the last axis,
    then swap the last two."""
    return torch.flip(vox_xyz, dims=(-1,)).transpose(-2, -1)
