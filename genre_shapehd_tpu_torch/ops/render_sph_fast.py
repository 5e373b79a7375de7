"""Spherical renderer: (N, V, V, V) occupancy -> (N, R, R) expected depth
(counterpart of ``genre_shapehd_tpu/ops/render_sph_fast.py``).

The ray-sample positions are static and factor through cylindrical
coordinates, so the resampling is two stages of 1-D hat (linear-interp)
weights:

  stage 1 (per theta):  c[b, th, m, z] = sum_{x,y} vox[b,x,y,z]
                                          * wx[th,x,m] * wy[th,y,m]
  stage 2 (per phi):    p[b, ph, th, s] = sum_m wr[ph,m,s]
                                          * sum_z c[b,th,m,z] * wz[ph,z,s]

followed by the clip, the first-hit (stop) probability and the expected
depth.  Every hat-weight column has at most two adjacent nonzeros, so each
stage is a 2x2 bilinear gather: :func:`tap_tables` lists, per column, the
first nonzero row and its two weights.  The CUDA kernels
(``ops/cuda/render_kernel.py``) run on those tables; the plain version
runs the dense einsums of the JAX package's ``sample_rays_mxu``.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

RHO_RES = 192        # ~2x oversampled vs the 90.5-voxel cube half-diagonal


def _rho_max(vox_res: int) -> float:
    """Radial support of the zero-padded trilinear hats in the xy-plane."""
    return float(np.sqrt(2.0) * (1.0 + 2.0 / (vox_res - 1)))


def _hat_weights(targets: np.ndarray, size: int) -> np.ndarray:
    """(T,) continuous indices -> (size, T) linear-interp weight matrix;
    each out-of-range corner gets zero weight on its own."""
    t = np.asarray(targets, np.float64)
    lo = np.floor(t)
    frac = t - lo
    w = np.zeros((size, t.shape[0]), np.float64)
    cols = np.arange(t.shape[0])
    for corner, cw in ((lo, 1.0 - frac), (lo + 1.0, frac)):
        idx = corner.astype(np.int64)
        ok = (idx >= 0) & (idx < size)
        w[idx[ok], cols[ok]] += cw[ok]
    return w


@functools.lru_cache(maxsize=4)
def _stage_weights(vox_res: int, sph_res: int, z_res: int, rho_res: int):
    """Dense weight tensors (numpy float32): wx, wy (Th, V, M);
    wz (Ph, V, S); wr (Ph, M, S)."""
    v = vox_res
    phis = np.deg2rad(np.linspace(0, 180, sph_res * 2 + 1)[1::2])
    thetas = np.deg2rad(np.linspace(0, 360, sph_res + 1)[:-1])
    t_prime = 2.0 * (1.0 - np.linspace(0.0, 1.0, z_res))   # radius per step
    rho_max = _rho_max(v)
    rho = np.linspace(0.0, rho_max, rho_res)

    def to_idx(coord):
        # align_corners=True: [-1, 1] -> [0, v-1]
        return (coord + 1.0) * 0.5 * (v - 1)

    wx = np.zeros((sph_res, v, rho_res), np.float32)
    wy = np.zeros((sph_res, v, rho_res), np.float32)
    for k, th in enumerate(thetas):
        wx[k] = _hat_weights(to_idx(rho * np.cos(th)), v)
        wy[k] = _hat_weights(to_idx(rho * np.sin(th)), v)

    wz = np.zeros((sph_res, v, z_res), np.float32)
    wr = np.zeros((sph_res, rho_res, z_res), np.float32)
    rho_scale = (rho_res - 1) / rho_max
    for i, ph in enumerate(phis):
        wz[i] = _hat_weights(to_idx(np.cos(ph) * t_prime), v)
        wr[i] = _hat_weights(np.sin(ph) * t_prime * rho_scale, rho_res)
    return wx, wy, wz, wr


def _taps(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(G, size, T) dense hat weights -> lo (G, T) int32, w2 (G, T, 2)
    float32 with w[g, lo, t] = w2[g, t, 0] and w[g, lo+1, t] = w2[g, t, 1].

    Taken from the nonzeros of each column, which must be at most two and
    adjacent.  ``lo`` stays in [0, size-2] so both rows are in range: a
    single nonzero in the last row becomes the high tap of ``size-2``, an
    empty column gets zero weights at row 0.
    """
    size = w.shape[1]
    nz = w != 0.0
    count = nz.sum(axis=1)
    first = np.argmax(nz, axis=1)
    last = size - 1 - np.argmax(nz[:, ::-1], axis=1)
    if count.max() > 2 or not np.all((count == 0) | (last - first == count - 1)):
        raise ValueError("hat-weight columns must hold at most two "
                         "adjacent nonzeros")
    lo = np.where(count > 0, np.minimum(first, size - 2), 0)
    w_lo = np.take_along_axis(w, lo[:, None, :], axis=1)[:, 0]
    w_hi = np.take_along_axis(w, lo[:, None, :] + 1, axis=1)[:, 0]
    return lo.astype(np.int32), np.stack([w_lo, w_hi], -1).astype(np.float32)


@functools.lru_cache(maxsize=4)
def tap_tables(vox_res: int, sph_res: int, z_res: int,
               rho_res: int) -> Dict[str, np.ndarray]:
    """Per-column taps of the four weight tensors (numpy):
    x_lo/x_w, y_lo/y_w over (Th, M); z_lo/z_w, m_lo/m_w over (Ph, S)."""
    wx, wy, wz, wr = _stage_weights(vox_res, sph_res, z_res, rho_res)
    out = {}
    for name, w in (("x", wx), ("y", wy), ("z", wz), ("m", wr)):
        out[name + "_lo"], out[name + "_w"] = _taps(w)
    return out


def expected_depth(prob: torch.Tensor) -> torch.Tensor:
    """(..., S) ray samples -> (...) clip, first-hit expectation of the
    normalized depth s/(S-1), plus the all-miss probability."""
    from .stop_prob import stop_probability
    z_res = prob.shape[-1]
    prob = torch.clamp(prob, 1e-5, 1.0 - 1e-5)
    stop = stop_probability(prob, dim=-1)
    depth_w = torch.linspace(0.0, 1.0, z_res, dtype=prob.dtype,
                             device=prob.device)
    return (torch.einsum("nrsz,z->nrs", stop, depth_w)
            + torch.prod(1.0 - prob, dim=-1))


def render_spherical_fast(vox: torch.Tensor, sph_res: int = 128,
                          z_res: int = 256, rho_res: int = RHO_RES,
                          compute_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """(N, V, V, V) clipped occupancy -> (N, R, R) expected-depth map.

    Runs the two renderer kernels on a CUDA tensor, in either compute
    dtype, and their plain versions on a CPU tensor."""
    from .cuda.render_kernel import render_expected_depth
    return render_expected_depth(vox.float(), vox.shape[1], sph_res, z_res,
                                 rho_res, compute_dtype)
