"""Geometry ops of GenRe's training, inference and scoring paths
(PyTorch; the renderer's and the Chamfer distance's kernels in CUDA).
Counterpart of ``genre_shapehd_tpu/ops``."""

from .sph import gen_sph_grid, sph_pad, sph_pad_numpy
from .stop_prob import stop_probability
from .camera_bp import (camera_backproject, camera_backproject_shifted,
                        get_surface_mask, shift_tdf, FL_MARRNET, FL_GENRE,
                        CAM_DIST)
from .spherical_bp import spherical_backproject, backproject_spherical_masked
from .render_sph_fast import render_spherical_fast
from .grid_sample import grid_sample_3d
from .render_sph import render_spherical
from .chamfer import nndistance, nndistance_w_idx, nndistance_score
from .reproj import reprojection_loss
from . import coords, voxel

__all__ = [
    "gen_sph_grid", "sph_pad", "sph_pad_numpy", "stop_probability",
    "camera_backproject", "camera_backproject_shifted", "get_surface_mask",
    "shift_tdf", "FL_MARRNET", "FL_GENRE", "CAM_DIST",
    "spherical_backproject", "backproject_spherical_masked",
    "render_spherical_fast", "grid_sample_3d", "render_spherical",
    "nndistance", "nndistance_w_idx",
    "nndistance_score", "reprojection_loss", "coords", "voxel",
]
