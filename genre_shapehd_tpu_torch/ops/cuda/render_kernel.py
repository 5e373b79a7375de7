"""The spherical renderer's two CUDA kernels, their plain versions and
launch counts (counterpart of
``genre_shapehd_tpu/ops/pallas/render_kernel.py``).

  K1 ``render_stage1``      (csrc/render_kernel.cu) replaces the Pallas
     ``_s1_sparse_kernel`` and its dense twin ``_s1_kernel``:
     (B, V, V, V) volume -> c (B, Th, M, V), in the compute dtype.
  K2 ``render_stage2_scan`` replaces ``_s2scan_kernel``:
     c -> (B, Ph, Th) expected depth, float32, with the clip, the first-hit
     scan and the depth reduction fused in, so the (B, R, R, S) ray
     samples never reach device memory.

:func:`stage1` and :func:`stage2` launch the kernels on CUDA tensors and
run the plain versions (:func:`stage1_plain`, :func:`stage2_plain`, the
dense einsums of the JAX package's ``sample_rays_mxu`` plus its epilogue)
on CPU tensors.  A CUDA tensor either launches the kernel or raises.

The plain versions mirror the JAX package's rounding: operands are cast
to the compute dtype, each contraction accumulates in float32, and the
intermediates ``t1``, ``c`` and ``t2`` are rounded to the compute dtype.
The kernels accumulate each 4-term gather in float32 without rounding
``t1``/``t2``, so in bfloat16 they differ from the plain versions by
about one bfloat16 rounding of those intermediates.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from ..render_sph_fast import (RHO_RES, _stage_weights, expected_depth,
                               tap_tables)
from . import build

SOURCE = "render_kernel.cu"

#: launches of each kernel since the last :func:`reset_launches`
launches: Dict[str, int] = {"render_stage1": 0, "render_stage2_scan": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_cache: Dict[Tuple, Dict[str, torch.Tensor]] = {}
_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _dense_weights(vox_res, sph_res, z_res, rho_res, dtype, device):
    key = ("dense", vox_res, sph_res, z_res, rho_res, dtype, str(device))
    if key not in _cache:
        names = ("wx", "wy", "wz", "wr")
        ws = _stage_weights(vox_res, sph_res, z_res, rho_res)
        _cache[key] = {n: torch.as_tensor(w).to(device=device, dtype=dtype)
                       for n, w in zip(names, ws)}
    return _cache[key]


def device_taps(vox_res, sph_res, z_res, rho_res, dtype, device):
    """The tap tables on ``device``: ``*_lo`` int32 and ``*_w`` float32
    weights rounded to the compute dtype, as the plain version rounds its
    dense weights."""
    key = ("taps", vox_res, sph_res, z_res, rho_res, dtype, str(device))
    if key not in _cache:
        out = {}
        for k, v in tap_tables(vox_res, sph_res, z_res, rho_res).items():
            t = torch.as_tensor(v)
            if k.endswith("_w"):
                t = t.to(dtype).to(torch.float32)
            out[k] = t.contiguous().to(device)
        _cache[key] = out
    return _cache[key]


# ------------------------------------------------------------ plain versions
#: angles per einsum chunk of the plain versions (bounds the f32
#: intermediates t1 / t2 to ~0.8 / 1.6 GB at batch 8)
CHUNK = 8


def _chunks(n: int):
    if n % CHUNK:
        raise ValueError(f"sph_res {n} is not a multiple of {CHUNK}")
    return range(0, n, CHUNK)


def stage1_plain(vox: torch.Tensor, vox_res: int, sph_res: int = 128,
                 z_res: int = 256, rho_res: int = RHO_RES,
                 compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, V, V, V) -> c (B, Th, M, V) in ``compute_dtype``:
    t1 = sum_x vox * wx (rounded), c = sum_y t1 * wy (rounded)."""
    f32, cd = torch.float32, compute_dtype
    w = _dense_weights(vox_res, sph_res, z_res, rho_res, cd, vox.device)
    v = vox.to(cd).to(f32)
    out = []
    for k in _chunks(sph_res):
        wx = w["wx"][k:k + CHUNK].to(f32)
        wy = w["wy"][k:k + CHUNK].to(f32)
        t1 = torch.einsum("bxyz,cxm->bcmyz", v, wx).to(cd).to(f32)
        out.append(torch.einsum("bcmyz,cym->bcmz", t1, wy))
    return torch.cat(out, dim=1).to(cd)


def stage2_samples_plain(c: torch.Tensor, vox_res: int, sph_res: int = 128,
                         z_res: int = 256, rho_res: int = RHO_RES,
                         compute_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """c (B, Th, M, V) -> ray samples (B, Ph, Th, S) float32:
    t2 = sum_z c * wz (rounded), p = sum_m t2 * wr."""
    f32, cd = torch.float32, compute_dtype
    w = _dense_weights(vox_res, sph_res, z_res, rho_res, cd, c.device)
    cf = c.to(cd).to(f32)
    out = []
    for k in _chunks(sph_res):
        wz = w["wz"][k:k + CHUNK].to(f32)
        wr = w["wr"][k:k + CHUNK].to(f32)
        t2 = torch.einsum("btmz,czs->bctms", cf, wz).to(cd).to(f32)
        out.append(torch.einsum("bctms,cms->bcts", t2, wr))
    return torch.cat(out, dim=1)


def stage2_plain(c: torch.Tensor, vox_res: int, sph_res: int = 128,
                 z_res: int = 256, rho_res: int = RHO_RES,
                 compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """c -> (B, Ph, Th) expected depth: stage-2 samples + the epilogue."""
    return expected_depth(stage2_samples_plain(c, vox_res, sph_res, z_res,
                                               rho_res, compute_dtype))


# ------------------------------------------------------------------ kernels
def _library():
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.render_stage1.argtypes = [p, p, i, p, p, p, p, i, i, i, i, p]
        lib.render_stage1.restype = i
        lib.render_stage2_scan.argtypes = [p, p, i, p, p, p, p,
                                           i, i, i, i, i, i, p]
        lib.render_stage2_scan.restype = i
        _lib = lib
    return _lib


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def _dtype_code(dtype: torch.dtype) -> int:
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"renderer kernels take float32 or bfloat16, "
                        f"not {dtype}")
    return _DTYPE_CODE[dtype]


def _on_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise RuntimeError(f"{what}: tensor on {t.device}; the kernel runs "
                           "on CUDA and its plain version on the CPU only")


def _check_shape(t: torch.Tensor, shape, what: str) -> None:
    if t.dim() != 4 or tuple(t.shape[1:]) != tuple(shape):
        raise ValueError(f"{what}: expected (B, {', '.join(map(str, shape))})"
                         f", got {tuple(t.shape)}")


def stage1(vox: torch.Tensor, vox_res: int, sph_res: int = 128,
           z_res: int = 256, rho_res: int = RHO_RES,
           compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K1: (B, V, V, V) volume -> c (B, Th, M, V) in ``compute_dtype``."""
    _check_shape(vox, (vox_res,) * 3, "render_stage1 volume")
    code = _dtype_code(compute_dtype)
    if vox.device.type == "cpu":
        return stage1_plain(vox, vox_res, sph_res, z_res, rho_res,
                            compute_dtype)
    _on_cuda(vox, "render_stage1")
    vox = vox.to(compute_dtype).contiguous()
    taps = device_taps(vox_res, sph_res, z_res, rho_res, compute_dtype,
                       vox.device)
    b = vox.shape[0]
    c = torch.empty((b, sph_res, rho_res, vox_res), dtype=compute_dtype,
                    device=vox.device)
    lib = _library()
    with torch.cuda.device(vox.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.render_stage1(
            _ptr(vox), _ptr(c), code, _ptr(taps["x_lo"]), _ptr(taps["x_w"]),
            _ptr(taps["y_lo"]), _ptr(taps["y_w"]), b, vox_res, sph_res,
            rho_res, ctypes.c_void_p(stream))
        launches["render_stage1"] += 1
    _check(err, "render_stage1")
    return c


def stage2(c: torch.Tensor, vox_res: int, sph_res: int = 128,
           z_res: int = 256, rho_res: int = RHO_RES,
           compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K2: c (B, Th, M, V) -> (B, Ph, Th) float32 expected depth."""
    _check_shape(c, (sph_res, rho_res, vox_res), "render_stage2_scan c")
    code = _dtype_code(compute_dtype)
    if c.device.type == "cpu":
        return stage2_plain(c, vox_res, sph_res, z_res, rho_res,
                            compute_dtype)
    _on_cuda(c, "render_stage2_scan")
    if c.dtype != compute_dtype:
        raise TypeError(f"c is {c.dtype}, compute dtype {compute_dtype}")
    if not 2 <= z_res <= 512:
        raise ValueError(f"render_stage2_scan takes 2..512 samples per "
                         f"ray, not {z_res}")
    c = c.contiguous()
    taps = device_taps(vox_res, sph_res, z_res, rho_res, compute_dtype,
                       c.device)
    b = c.shape[0]
    out = torch.empty((b, sph_res, sph_res), dtype=torch.float32,
                      device=c.device)
    lib = _library()
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.render_stage2_scan(
            _ptr(c), _ptr(out), code, _ptr(taps["z_lo"]), _ptr(taps["z_w"]),
            _ptr(taps["m_lo"]), _ptr(taps["m_w"]), b, sph_res, rho_res,
            vox_res, sph_res, z_res, ctypes.c_void_p(stream))
        launches["render_stage2_scan"] += 1
    _check(err, "render_stage2_scan")
    return out


def render_expected_depth(vox: torch.Tensor, vox_res: int,
                          sph_res: int = 128, z_res: int = 256,
                          rho_res: int = RHO_RES,
                          compute_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """(B, V, V, V) clipped occupancy -> (B, R, R) expected-depth map:
    K1 then K2 (their plain versions on the CPU)."""
    c = stage1(vox, vox_res, sph_res, z_res, rho_res, compute_dtype)
    return stage2(c, vox_res, sph_res, z_res, rho_res, compute_dtype)
