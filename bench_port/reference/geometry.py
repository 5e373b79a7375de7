"""GenRe's geometry in plain PyTorch, float32: the camera and spherical
backprojections (a scatter-mean of points onto the voxel grid), the
spherical map's padding, and the spherical renderer.

The renderer is the published one's two-stage resampling, written from
its definition: every ray sample is a linear interpolation over rho and
z of values that are themselves bilinear in x and y on the volume, at
theta's rays.  Each interpolation is a gather of two neighbours with
hat weights, worked out here from the sampling grid; a corner outside
the grid weighs nothing.  Then the clip, the first-hit probability and
the expected depth.

Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

FL_GENRE = 418.3          # focal length of GenRe's 256² crops, pixels
CAM_DIST = 2.2            # camera distance from the object's centre
RHO_RES = 192             # radial samples of the renderer's first stage


def abs_depth(depth, minmax, silhou):
    """net1's depth (N, H, W, 1) on [0, 100] with its (N, 2) min/max and
    the input silhouette (N, H, W, 1) on [0, 100] -> absolute ray depth
    (N, W, H) in the backprojection's frame; 0 off the silhouette."""
    d = 1.0 - depth[..., 0] / 100.0
    dmin, dmax = minmax[:, 0, None, None], minmax[:, 1, None, None]
    d = d * (dmax - dmin + 1e-4) + dmin
    d = torch.where(silhou[..., 0] / 100.0 < 0.5, 0.0, d)
    return torch.flip(d.transpose(1, 2), dims=(1,))


def scatter_mean(pts, valid, res: int, background: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean distance of the points (N, P, 3) on the cube [-0.5, 0.5]^3 to
    the centre of the voxel each falls in, and the count per voxel;
    ``background`` where none falls."""
    n = pts.shape[0]
    idx = torch.floor((pts + 0.5) * res).long()
    valid = valid & ((idx >= 0) & (idx < res)).all(-1)
    centre = (idx.float() + 0.5) / res - 0.5
    dist = torch.sqrt(((pts - centre) ** 2).sum(-1) + 1e-20)
    cells = res ** 3
    flat = (idx[..., 0] * res + idx[..., 1]) * res + idx[..., 2]
    flat = torch.where(valid, flat, cells)
    flat = flat + torch.arange(n, device=pts.device)[:, None] * (cells + 1)
    total = torch.zeros(n * (cells + 1), device=pts.device)
    count = torch.zeros_like(total)
    total = total.index_add(0, flat.reshape(-1),
                            torch.where(valid, dist, 0.0).reshape(-1))
    count = count.index_add(0, flat.reshape(-1), valid.float().reshape(-1))
    total = total.view(n, cells + 1)[:, :cells]
    count = count.view(n, cells + 1)[:, :cells]
    mean = torch.where(count > 1e-5, total / count.clamp(min=1.0),
                       torch.full_like(total, background))
    shape = (n, res, res, res)
    return mean.reshape(shape), count.reshape(shape)


def camera_backproject(depth, res: int, fl: float = FL_GENRE,
                       cam_dist: float = CAM_DIST):
    """(N, H, W) ray depth -> (N, res³) proximity ``1 - res * tdf``: the
    camera on +x at ``cam_dist`` looks at the origin; depth < 0 is
    dropped, background depth 0 lands outside the cube."""
    n, h, w = depth.shape
    dev = depth.device
    ih = (torch.arange(h, device=dev, dtype=torch.float32)
          - (h - 1) / 2.0)[None, :, None]
    iw = (torch.arange(w, device=dev, dtype=torch.float32)
          - (w - 1) / 2.0)[None, None, :]
    d = depth * (fl / torch.sqrt(ih ** 2 + iw ** 2 + fl * fl))
    pts = torch.stack([(d - cam_dist).expand(n, h, w),
                       (-d * iw / fl).expand(n, h, w),
                       (-d * ih / fl).expand(n, h, w)], -1)
    tdf, _ = scatter_mean(pts.reshape(n, h * w, 3),
                          (depth >= 0).reshape(n, h * w), res, 1.0 / res)
    return 1.0 - res * tdf


def sph_directions(res: int, device) -> torch.Tensor:
    """(res, res, 3) unit directions: latitude phi at the midpoints of
    [0, 180] degrees in 2 res steps, longitude theta from 0 by 360 / res."""
    phi = torch.deg2rad(torch.linspace(0, 180, 2 * res + 1,
                                       dtype=torch.float64)[1::2])
    theta = torch.deg2rad(torch.linspace(0, 360, res + 1,
                                         dtype=torch.float64)[:-1])
    grid = torch.stack([torch.sin(phi)[:, None] * torch.cos(theta)[None],
                        torch.sin(phi)[:, None] * torch.sin(theta)[None],
                        torch.cos(phi)[:, None].expand(res, res)], -1)
    return grid.float().to(device)


def spherical_backproject(sph_full, margin: int, res: int):
    """net2's padded map (N, R + 2m, R + 2m) -> (N, res³): the margin cut
    off, ``1 - map`` as the radius along each direction, the mean
    distance field mapped by ``(1/res - df) * res`` where a point landed,
    0 elsewhere."""
    crop = sph_full[:, margin:sph_full.shape[1] - margin,
                    margin:sph_full.shape[2] - margin]
    r = 1.0 - crop
    n, rh, rw = r.shape
    pts = (sph_directions(rh, r.device)[None] * r[..., None])
    df, count = scatter_mean(pts.reshape(n, rh * rw, 3),
                             (r >= 0).reshape(n, rh * rw), res, 0.0)
    return (1.0 / res - df) * res * count.clamp(0.0, 1.0)


def sph_pad(x, m: int):
    """(N, R, R, C) -> (N, R + 2m, R + 2m, C): the pole rows repeated,
    then the longitudes wrapped around."""
    n, h, w, c = x.shape
    rows = torch.cat([x[:, :1].expand(n, m, w, c), x,
                      x[:, -1:].expand(n, m, w, c)], 1)
    return torch.cat([rows[:, :, w - m:], rows, rows[:, :, :m]], 2)


# ------------------------------------------------------------------ renderer
def _taps(t: torch.Tensor, size: int):
    """Continuous indices -> the two neighbours (clamped into range) and
    their hat weights (0 for a neighbour outside [0, size))."""
    lo = torch.floor(t)
    f = t - lo
    lo = lo.long()
    out = []
    for idx, wt in ((lo, 1.0 - f), (lo + 1, f)):
        ok = (idx >= 0) & (idx < size)
        out.append((idx.clamp(0, size - 1), torch.where(ok, wt, 0.0)))
    return out


def _render_taps(v: int, sph_res: int, z_res: int, rho_res: int, device):
    f64 = dict(dtype=torch.float64, device=device)
    phi = torch.deg2rad(torch.linspace(0, 180, 2 * sph_res + 1, **f64)[1::2])
    theta = torch.deg2rad(torch.linspace(0, 360, sph_res + 1, **f64)[:-1])
    radius = 2.0 * (1.0 - torch.linspace(0.0, 1.0, z_res, **f64))
    rho_max = math.sqrt(2.0) * (1.0 + 2.0 / (v - 1))
    rho = torch.linspace(0.0, rho_max, rho_res, **f64)

    def index(coord):             # [-1, 1] onto [0, v - 1]
        return (coord + 1.0) * 0.5 * (v - 1)

    tx = index(rho[None] * torch.cos(theta)[:, None])     # (Th, M)
    ty = index(rho[None] * torch.sin(theta)[:, None])
    tz = index(torch.cos(phi)[:, None] * radius[None])    # (Ph, S)
    tm = torch.sin(phi)[:, None] * radius[None] * (rho_res - 1) / rho_max
    as32 = lambda taps: [(i, w.float()) for i, w in taps]  # noqa: E731
    return (as32(_taps(tx, v)), as32(_taps(ty, v)), as32(_taps(tz, v)),
            as32(_taps(tm, rho_res)))


def ray_samples(vox, sph_res: int, z_res: int, rho_res: int = RHO_RES,
                cast=lambda x: x):
    """(B, V, V, V) volume -> (B, Ph, Th, S) samples along the rays."""
    v = vox.shape[1]
    xs, ys, zs, ms = _render_taps(v, sph_res, z_res, rho_res, vox.device)
    vox = cast(vox)
    c = 0.0
    for xi, xw in xs:
        for yi, yw in ys:
            c = c + (xw * yw)[None, :, :, None] * vox[:, xi, yi, :]
    c = cast(c)                                    # (B, Th, M, V)
    p = 0.0
    for zi, zw in zs:
        for mi, mw in ms:
            p = p + (zw * mw)[None, None] * c[:, :, mi, zi]
    return p.permute(0, 2, 1, 3)                   # (B, Ph, Th, S)


def expected_depth(p):
    """Samples (..., S) -> the expected normalised depth of the first hit,
    plus the probability that no sample is hit."""
    s = p.shape[-1]
    p = p.clamp(1e-5, 1.0 - 1e-5)
    keep = torch.cumprod(1.0 - p, -1)
    before = torch.cat([torch.ones_like(keep[..., :1]), keep[..., :-1]], -1)
    depth = torch.linspace(0.0, 1.0, s, device=p.device)
    return (p * before * depth).sum(-1) + keep[..., -1]


def render(vox, sph_res: int, z_res: int, rho_res: int = RHO_RES,
           cast=lambda x: x, rows: int = 8):
    """(B, V, V, V) occupancy -> (B, Ph, Th) expected depth, in blocks
    of ``rows`` volumes."""
    return torch.cat([expected_depth(ray_samples(vox[i:i + rows], sph_res,
                                                 z_res, rho_res, cast))
                      for i in range(0, vox.shape[0], rows)])


def erode(vox, iterations: int = 2):
    """3³ binary erosion of (N, X, Y, Z) grids, zero outside."""
    x = vox[:, None]
    for _ in range(iterations):
        x = -F.max_pool3d(-F.pad(x, (1,) * 6), 3, stride=1)
    return x[:, 0]
