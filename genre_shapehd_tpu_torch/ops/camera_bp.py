"""Camera backprojection: depth image -> truncated distance field
(counterpart of ``genre_shapehd_tpu/ops/camera_bp.py``).

A scatter-mean over flattened voxel indices.  The JAX package drops
out-of-range points with ``mode="drop"``; here every invalid point goes to
a dump slot at the end of each sample's row, which ``index_add_`` fills and
the result slices off.
"""

from __future__ import annotations

from typing import Tuple

import torch

#: focal length (pixels, 256x256 crops) of the GenRe pipeline
FL_GENRE = 418.3
#: camera distance from the object centre
CAM_DIST = 2.2


def _scatter_mean_tdf(glob: torch.Tensor, valid: torch.Tensor, res: int,
                      background: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter distance-to-voxel-centre means onto a res^3 grid.

    glob (N, P, 3) global coordinates, valid (N, P) bool.  Returns
    (tdf, cnt), each (N, res, res, res); unhit voxels hold ``background``
    in tdf and 0 in cnt.
    """
    n, p, _ = glob.shape
    vox_idx = torch.floor((glob + 0.5) * res).to(torch.int64)
    inb = ((vox_idx >= 0) & (vox_idx < res)).all(dim=-1)
    valid = valid & inb

    centre = (vox_idx.to(glob.dtype) + 0.5) / res - 0.5
    dist = torch.sqrt(((glob - centre) ** 2).sum(dim=-1) + 1e-20)

    cells = res ** 3
    flat = (vox_idx[..., 0] * res + vox_idx[..., 1]) * res + vox_idx[..., 2]
    flat = torch.where(valid, flat, cells)              # dump slot
    rows = torch.arange(n, device=glob.device)[:, None] * (cells + 1)
    flat = (flat + rows).reshape(-1)

    sums = torch.zeros(n * (cells + 1), dtype=glob.dtype, device=glob.device)
    cnt = torch.zeros_like(sums)
    sums.index_add_(0, flat, torch.where(valid, dist, 0.0).reshape(-1))
    cnt.index_add_(0, flat, valid.to(glob.dtype).reshape(-1))
    sums = sums.view(n, cells + 1)[:, :cells]
    cnt = cnt.view(n, cells + 1)[:, :cells]

    eps = 1e-5
    tdf = torch.where(cnt > eps, sums / torch.clamp(cnt, min=1.0),
                      torch.full_like(sums, background))
    shape = (n, res, res, res)
    return tdf.reshape(shape), cnt.reshape(shape)


def _camera_glob_coords(depth: torch.Tensor, fl: float,
                        cam_dist: float) -> torch.Tensor:
    """(N, H, W) ray depth -> (N, H*W, 3) global coordinates (camera on +x
    at ``cam_dist``, looking at the origin)."""
    n, h, w = depth.shape
    dt, dev = depth.dtype, depth.device
    imind_h = (torch.arange(h, dtype=dt, device=dev) - (h - 1) / 2.0)[None, :, None]
    imind_w = (torch.arange(w, dtype=dt, device=dev) - (w - 1) / 2.0)[None, None, :]
    fl_t = torch.tensor(fl, dtype=dt, device=dev)
    cd_t = torch.tensor(cam_dist, dtype=dt, device=dev)
    cos_theta = fl_t / torch.sqrt(imind_h ** 2 + imind_w ** 2 + fl_t ** 2)
    d = depth * cos_theta
    return torch.stack(
        [(d - cd_t).expand(n, h, w),
         (-d * imind_w / fl_t).expand(n, h, w),
         (-d * imind_h / fl_t).expand(n, h, w)],
        dim=-1).reshape(n, h * w, 3)


def camera_backproject(depth: torch.Tensor, fl: float = FL_GENRE,
                       cam_dist: float = CAM_DIST,
                       res: int = 128) -> torch.Tensor:
    """(N, H, W) absolute ray depth -> (N, res, res, res) TDF: mean
    point-to-voxel-centre distance where hit, 1/res elsewhere.  Pixels
    with depth < 0 are discarded; zero-depth background lands outside the
    cube."""
    n, h, w = depth.shape
    glob = _camera_glob_coords(depth, fl, cam_dist)
    valid = (depth >= 0.0).reshape(n, h * w)
    tdf, _ = _scatter_mean_tdf(glob, valid, res, background=1.0 / res)
    return tdf


def shift_tdf(tdf: torch.Tensor, res: int = 128) -> torch.Tensor:
    """1 - res * tdf (distance field -> proximity)."""
    return 1.0 - res * tdf


def camera_backproject_shifted(depth: torch.Tensor, fl: float = FL_GENRE,
                               cam_dist: float = CAM_DIST,
                               res: int = 128) -> torch.Tensor:
    """Backproject, then shift (the GenRe model's use of the op)."""
    return shift_tdf(camera_backproject(depth, fl, cam_dist, res), res)


def get_surface_mask(depth: torch.Tensor, fl: float = FL_GENRE,
                     cam_dist: float = CAM_DIST, res: int = 128
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Visibility and free-space masks of a (N, H, W) ray-depth image,
    each (N, res, res, res): ``surface_vox`` is 1 where a point landed;
    ``mask`` is 1 except at empty voxels that project inside the image
    onto a pixel of depth >= 0 and lie in front of that depth (free space,
    carved to 0)."""
    n, h, w = depth.shape
    dt, dev = depth.dtype, depth.device
    _, cnt = _scatter_mean_tdf(
        _camera_glob_coords(depth, fl, cam_dist),
        (depth >= 0).reshape(n, -1), res, background=1.0 / res)
    surface_vox = torch.clamp(cnt, 0.0, 1.0)

    # voxel centres onto the image plane
    centre = (torch.arange(res, dtype=dt, device=dev) + 0.5) / res - 0.5
    cx = centre[:, None, None]
    cy = centre[None, :, None]
    cz = centre[None, None, :]
    fl_t = torch.tensor(fl, dtype=dt, device=dev)
    cd_t = torch.tensor(cam_dist, dtype=dt, device=dev)
    denom = cx + cd_t
    idh = torch.round(0.5 * (h - 1.0) - cz * fl_t / denom).to(torch.int64)
    idw = torch.round(0.5 * (w - 1.0) - cy * fl_t / denom).to(torch.int64)
    inb = (idh >= 0) & (idh < h) & (idw >= 0) & (idw < w)
    flat = (idh.clamp(0, h - 1) * w + idw.clamp(0, w - 1)).reshape(-1)
    dep = depth.reshape(n, -1)[:, flat].reshape(n, res, res, res)
    ray_depth = torch.sqrt((cx + cd_t) ** 2 + cy ** 2 + cz ** 2)
    carve = (cnt <= 1e-5) & inb & (dep >= 0) & (dep < ray_depth)
    return surface_vox, torch.where(carve, 0.0, 1.0).to(dt)

