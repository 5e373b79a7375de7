"""The benchmark's inputs, made on the device from the seed in a few
large calls.

Photos are the shaded solids of ``chip_smoke.py::make_photos``
(ellipsoids and boxes under a random light, on white), drawn directly at
the network's input size as the test crop frames them (the object's box
centred, some 65 % of the side), ImageNet-normalised, with silhouettes
on [0, 100] as the port's preprocessing leaves them.  Shapes are solid
ellipsoids and boxes in the voxel grid.  The training cells' ground
truths are the maps of such photos: depth and normal on the scale of
100, the silhouette, the depth's min/max, a padded spherical map, the
solid voxels.
"""

from __future__ import annotations

from typing import Dict

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _grid(s: int, device):
    t = (torch.arange(s, device=device, dtype=torch.float32) + 0.5) / s
    return torch.meshgrid(t, t, indexing="ij")


def photos(n: int, size: int, g: torch.Generator, device
           ) -> Dict[str, torch.Tensor]:
    """``rgb`` (n, size, size, 3) normalised, ``silhou`` (n, size, size,
    1) on [0, 100], and the maps under them: ``nz`` (the surface's
    facing), ``u``, ``v`` (coordinates across the object)."""
    u = torch.rand((n, 10), generator=g, device=device)
    light = torch.randn((n, 3), generator=g, device=device)
    light[:, 2] = light[:, 2].abs() + 1.0
    light = light / light.norm(dim=1, keepdim=True)
    yy, xx = _grid(size, device)
    cy, cx = (0.45 + 0.1 * u[:, :2]).T
    ry, rx = (0.24 + 0.09 * u[:, 2:4]).T
    uu = (xx[None] - cx[:, None, None]) / rx[:, None, None]
    vv = (yy[None] - cy[:, None, None]) / ry[:, None, None]
    box = (u[:, 4] < 0.5)[:, None, None]
    inside = torch.where(box, (uu.abs() < 1) & (vv.abs() < 1),
                         uu * uu + vv * vv < 1)
    nz = torch.where(box, torch.full_like(uu, 0.8),
                     torch.sqrt((1 - uu * uu - vv * vv).clamp(0, 1)))
    shade = (-uu * light[:, 0, None, None] - vv * light[:, 1, None, None]
             + nz * light[:, 2, None, None]).clamp(0, 1)
    color = 0.2 + 0.7 * u[:, 5:8]
    rgb = torch.where(inside[..., None],
                      (0.15 + 0.85 * shade)[..., None]
                      * color[:, None, None, :], 1.0)
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)
    return {"rgb": (rgb - mean) / std,
            "silhou": inside.float()[..., None] * 100.0,
            "nz": nz * inside, "u": uu * inside, "v": vv * inside}


def solids(n: int, res: int, g: torch.Generator, device) -> torch.Tensor:
    """(n, res, res, res) solid ellipsoids and boxes in {0, 1}."""
    u = torch.rand((n, 7), generator=g, device=device)
    t = (torch.arange(res, device=device, dtype=torch.float32) + 0.5) / res
    c = 0.4 + 0.2 * u[:, :3]
    r = 0.15 + 0.2 * u[:, 3:6]
    d = [(t[None] - c[:, i, None]) / r[:, i, None] for i in range(3)]
    x, y, z = (d[0][:, :, None, None], d[1][:, None, :, None],
               d[2][:, None, None, :])
    box = (u[:, 6] < 0.5)[:, None, None, None]
    ball = x * x + y * y + z * z < 1
    cube = (x.abs() < 1) & (y.abs() < 1) & (z.abs() < 1)
    return torch.where(box, cube, ball).float()


def genre_batch(n: int, size: int, vox_res: int, sph_res: int, margin: int,
                g: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """A training batch of GenRe's joint step: what its loader hands the
    model after preprocessing."""
    p = photos(n, size, g, device)
    fg = p["silhou"] / 100.0
    depth = (0.3 + 0.4 * (1.0 - p["nz"]))[..., None] * fg * 100.0
    normal = torch.stack([p["u"], p["v"], p["nz"]], -1) * fg * 100.0
    lo = 1.2 + 0.4 * torch.rand((n, 1), generator=g, device=device)
    minmax = torch.cat([lo, lo + 0.6 + 0.4 * torch.rand(
        (n, 1), generator=g, device=device)], 1)
    sph = 0.3 + 0.5 * torch.rand((n, sph_res, sph_res), generator=g,
                                 device=device)
    m = margin
    rows = torch.cat([sph[:, :1].expand(n, m, sph_res), sph,
                      sph[:, -1:].expand(n, m, sph_res)], 1)
    sph = torch.cat([rows[:, :, -m:], rows, rows[:, :, :m]], 2)
    return {"rgb": p["rgb"], "silhou": p["silhou"], "depth": depth,
            "normal": normal, "depth_minmax": minmax,
            "spherical_object": sph[..., None].contiguous(),
            "voxel": solids(n, vox_res, g, device)}
