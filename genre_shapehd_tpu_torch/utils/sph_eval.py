"""Spherical rendering of a predicted depth map (counterpart of
``genre_shapehd_tpu/utils/sph_eval.py``): the training path's camera
backprojection, then the exact renderer (``ops/render_sph.py``)."""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from .. import ops
from ..core.device import resolve_device


def make_sgrid(b: int) -> np.ndarray:
    """(4b², 3) unit-sphere directions: the flattened
    ``ops.gen_sph_grid(2b)``."""
    return ops.gen_sph_grid(2 * b).reshape(-1, 3)


def render_spherical_from_depth(pack: Dict, silhou: np.ndarray,
                                sph_res: int = 128, z_res: int = 256,
                                vox_res: int = 128,
                                device: Union[str, torch.device] = "cuda"
                                ) -> np.ndarray:
    """Predicted depth -> (sph_res, sph_res) spherical depth, background
    (and anything beyond) 1.

    pack: {'depth': (1, H, W, 1) or (H, W) relative depth in [0, 1],
    'depth_minmax': (2,) or (1, 2)}; silhou: (H, W) soft mask in [0, 1],
    thresholded at 0.95.  Computed on ``device``."""
    dev = resolve_device(str(device))
    depth = np.asarray(pack["depth"], dtype=np.float32)
    depth = depth.reshape(depth.shape[-3], depth.shape[-2]) \
        if depth.ndim >= 3 else depth
    minmax = np.asarray(pack["depth_minmax"], dtype=np.float32).reshape(-1)

    gt_sil = (np.asarray(silhou) > 0.95).astype(np.float32)
    depth = depth * gt_sil
    # relative -> absolute, the min-max denormalization of the models
    dmin, dmax = float(minmax[0]), float(minmax[1])
    abs_depth = (1.0 - depth) * (dmax - dmin + 1e-4) + dmin
    abs_depth = np.where(gt_sil > 0, abs_depth, 0.0).astype(np.float32)

    with torch.no_grad():
        d = ops.coords.depth_image_to_cambp_frame(
            torch.from_numpy(abs_depth)[None].to(dev))
        proj = ops.camera_backproject_shifted(d, ops.FL_GENRE, ops.CAM_DIST,
                                              vox_res)
        sph = ops.render_spherical(torch.clamp(proj * 50.0, 1e-5,
                                               1.0 - 1e-5), sph_res, z_res)
    return np.minimum(sph[0].cpu().numpy(), 1.0)
