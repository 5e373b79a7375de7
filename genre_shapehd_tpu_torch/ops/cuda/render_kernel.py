"""The spherical renderer's three CUDA kernels, their plain versions,
launch counts and gradients (counterpart of
``genre_shapehd_tpu/ops/pallas/render_kernel.py``).

  K1 ``render_stage1``      (csrc/render_kernel.cu) replaces the Pallas
     ``_s1_sparse_kernel`` and its dense twin ``_s1_kernel``:
     (B, V, V, V) volume -> c (B, Th, M, V), in the compute dtype.
  K2 ``render_stage2_scan`` replaces ``_s2scan_kernel``:
     c -> (B, Ph, Th) expected depth, float32, with the clip, the first-hit
     scan and the depth reduction fused in, so the (B, R, R, S) ray
     samples never reach device memory.
  K5 ``render_stage2_samples`` replaces ``_s2_kernel``: c -> (B, Ph, Th, S)
     float32 ray samples, every one written out.

K2 and K5 hold groups of (b, th) slabs of c in shared memory and stream
the (ph, s) taps once per group: :func:`plan` sizes the groups,
:func:`tap_records` packs the taps as one interleaved record table.

:func:`stage1`, :func:`stage2` and :func:`stage2_samples` launch the
kernels on CUDA tensors and run the plain versions (:func:`stage1_plain`,
:func:`stage2_plain`, :func:`stage2_samples_plain`: the dense einsums of
the JAX package's ``sample_rays_mxu`` plus its epilogue) on CPU tensors.
A CUDA tensor either launches the kernel or raises.

Gradients.  :func:`render_expected_depth` (the counterpart of
``render_expected_depth_pallas``) and :func:`sample_rays` (of
``sample_rays_pallas``) are ``autograd.Function`` subclasses, which record
nothing when the volume needs no gradient or under ``no_grad`` /
``inference_mode``.  The sampling map vox -> samples is linear; its
transpose (:func:`sample_rays_transpose`) is two scatter-adds over the
tap tables, in float32, on either device, as ``_sample_bwd`` takes XLA's
transpose.  The renderer's backward saves only the volume: it recomputes
the samples with K1 + K5 (the plain versions on the CPU), differentiates
the clip / first-hit / expected-depth epilogue in plain PyTorch, and
applies the transpose, as ``_render_expd_bwd`` does.

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

import numpy as np
import torch

from ..render_sph_fast import (RHO_RES, _stage_weights, expected_depth,
                               tap_tables)
from . import build

SOURCE = "render_kernel.cu"

#: launches of each kernel since the last :func:`reset_launches`
launches: Dict[str, int] = {"render_stage1": 0, "render_stage2_scan": 0,
                            "render_stage2_samples": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ELT = {torch.float32: 4, torch.bfloat16: 2}
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
    """K1's tap tables (x, y) on ``device``: ``*_lo`` int32 and ``*_w``
    float32 weights rounded to the compute dtype, as the plain version
    rounds its dense weights."""
    key = ("taps", vox_res, sph_res, z_res, rho_res, dtype, str(device))
    if key not in _cache:
        out = {}
        for k, v in tap_tables(vox_res, sph_res, z_res, rho_res).items():
            if k[0] not in "xy":
                continue
            t = torch.as_tensor(v)
            if k.endswith("_w"):
                t = t.to(dtype).to(torch.float32)
            out[k] = t.contiguous().to(device)
        _cache[key] = out
    return _cache[key]


# ------------------------------------------------------ K2 / K5: the plan
#: shared memory a K2 / K5 block may take for its slabs: the H100's 227 KB
#: less 1 KB for the kernels' static shared memory
SMEM_LIMIT = 226 * 1024
#: slabs a group holds at most, the kernels' kMaxGroup: each ph row's tap
#: records are read once per group
MAX_GROUP = 4


def row_stride(vox_res: int, dtype: torch.dtype) -> int:
    """Elements between the rows of a slab staged in shared memory: V
    rounded up to an odd number of 4-byte words, so that the rows of one
    z fall in different banks (V = 128 bf16: 65 words, 130 elements)."""
    elt = _ELT[dtype]
    words = -(-vox_res * elt // 4)
    words += 1 - words % 2
    return words * 4 // elt


def plan(vox_res: int, rho_res: int, dtype: torch.dtype) -> Dict[str, int]:
    """K2's and K5's shared memory for slabs c[b, th] of (M, V) in
    ``dtype``: ``group`` (G) slabs per group, :data:`MAX_GROUP` or as many
    as fit in :data:`SMEM_LIMIT`, the staged ``row_stride``, ``slab_bytes``
    and ``smem_bytes`` = G * slab_bytes.  Raises ValueError where one slab
    does not fit (float32 at V = 256, M = 384: 395 KB)."""
    _dtype_code(dtype)
    pe = row_stride(vox_res, dtype)
    slab = rho_res * pe * _ELT[dtype]
    if slab > SMEM_LIMIT:
        raise ValueError(f"a (M, V) = ({rho_res}, {vox_res}) slab of c in "
                         f"{dtype} takes {slab} bytes of shared memory, more "
                         f"than a block has ({SMEM_LIMIT})")
    group = min(MAX_GROUP, SMEM_LIMIT // slab)
    return dict(group=group, row_stride=pe, slab_bytes=slab,
                smem_bytes=group * slab)


def record_row(z_res: int) -> int:
    """Records per ph row of :func:`tap_records`: K2's 32 lanes times its
    samples per lane, the power of two from 4 (K5's 4 samples a lane) at
    or above S / 32."""
    spl = 4
    while 32 * spl < z_res:
        spl *= 2
    return 32 * spl


def tap_records(vox_res: int, sph_res: int, z_res: int, rho_res: int,
                dtype: torch.dtype) -> torch.Tensor:
    """The stage-2 taps as one interleaved record table, zero past S.  A
    record has W words: float32 {z_lo, m_lo, z_w0, z_w1, m_w0, m_w1};
    bfloat16 {z_lo | m_lo << 16, z_w0 | z_w1 << 16, m_w0 | m_w1 << 16}
    with the weights in bfloat16.  The weights are rounded to ``dtype``,
    as the plain version rounds its dense weights, so bfloat16 holds them
    exactly.  Quad-major: the 4 records of samples 4q .. 4q + 3 are W
    16-byte chunks, stored as int32 (Ph, W, :func:`record_row` / 4, 4), so
    lanes that read consecutive quads read consecutive 16 bytes."""
    _dtype_code(dtype)
    key = ("records", vox_res, sph_res, z_res, rho_res, dtype)
    if key not in _cache:
        t = tap_tables(vox_res, sph_res, z_res, rho_res)
        w = {f"{k}{i}": torch.from_numpy(
                 np.ascontiguousarray(t[k + "_w"][..., i])).to(dtype)
             for k in "zm" for i in (0, 1)}
        if dtype == torch.float32:
            words = [t["z_lo"], t["m_lo"]] + [
                w[k].numpy().view(np.int32) for k in ("z0", "z1", "m0", "m1")]
        else:
            if max(vox_res, rho_res) > 1 << 16:
                raise ValueError("bfloat16 records hold rows below 2**16")
            u = {k: v.view(torch.int16).numpy().view(np.uint16)
                 .astype(np.uint32) for k, v in w.items()}
            words = [(t["z_lo"].astype(np.uint32)
                      | (t["m_lo"].astype(np.uint32) << 16)),
                     u["z0"] | (u["z1"] << 16), u["m0"] | (u["m1"] << 16)]
            words = [x.view(np.int32) for x in words]
        n_w = len(words)
        rec = np.zeros((sph_res, record_row(z_res), n_w), np.int32)
        rec[:, :z_res] = np.stack(words, -1)
        quads = rec.reshape(sph_res, -1, n_w, 4).transpose(0, 2, 1, 3)
        _cache[key] = torch.from_numpy(np.ascontiguousarray(quads))
    return _cache[key]


# ------------------------------------------------------------ plain versions
#: angles per einsum chunk of the plain versions (bounds the f32
#: intermediates t1 / t2 to ~0.8 / 1.6 GB at batch 8); the last chunk
#: takes what is left
CHUNK = 8


def _chunks(n: int):
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
        lib.render_stage1.argtypes = [p, p, i, i, p, p, p, p, i, i, i, i, p]
        lib.render_stage1.restype = i
        for name in ("render_stage2_scan", "render_stage2_samples"):
            fn = getattr(lib, name)
            fn.argtypes = [p, p, i, p] + [i] * 9 + [p]
            fn.restype = i
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
    """K1: (B, V, V, V) volume -> c (B, Th, M, V) in ``compute_dtype``.
    The kernel reads a float32 or bfloat16 volume as it is and rounds each
    element to ``compute_dtype`` itself; another dtype is cast first."""
    _check_shape(vox, (vox_res,) * 3, "render_stage1 volume")
    code = _dtype_code(compute_dtype)
    if vox.device.type == "cpu":
        return stage1_plain(vox, vox_res, sph_res, z_res, rho_res,
                            compute_dtype)
    _on_cuda(vox, "render_stage1")
    if vox.dtype not in _DTYPE_CODE:
        vox = vox.to(compute_dtype)
    vox = vox.contiguous()
    taps = device_taps(vox_res, sph_res, z_res, rho_res, compute_dtype,
                       vox.device)
    b = vox.shape[0]
    c = torch.empty((b, sph_res, rho_res, vox_res), dtype=compute_dtype,
                    device=vox.device)
    lib = _library()
    with torch.cuda.device(vox.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.render_stage1(
            _ptr(vox), _ptr(c), _DTYPE_CODE[vox.dtype], code,
            _ptr(taps["x_lo"]), _ptr(taps["x_w"]),
            _ptr(taps["y_lo"]), _ptr(taps["y_w"]), b, vox_res, sph_res,
            rho_res, ctypes.c_void_p(stream))
        launches["render_stage1"] += 1
    _check(err, "render_stage1")
    return c


def _launch_stage2(name: str, c: torch.Tensor, out_shape: Tuple[int, ...],
                   vox_res: int, sph_res: int, z_res: int, rho_res: int,
                   compute_dtype: torch.dtype) -> torch.Tensor:
    """K2 or K5 (``name``) on a CUDA c into a new float32 tensor of shape
    (B,) + ``out_shape``; raises before launching what the plan refuses."""
    _on_cuda(c, name)
    if c.dtype != compute_dtype:
        raise TypeError(f"c is {c.dtype}, compute dtype {compute_dtype}")
    pl = plan(vox_res, rho_res, compute_dtype)
    c = c.contiguous()
    key = ("device_records", vox_res, sph_res, z_res, rho_res, compute_dtype,
           str(c.device))
    if key not in _cache:
        _cache[key] = tap_records(vox_res, sph_res, z_res, rho_res,
                                  compute_dtype).to(c.device)
    out = torch.empty((c.shape[0],) + out_shape, dtype=torch.float32,
                      device=c.device)
    lib = _library()
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(
            _ptr(c), _ptr(out), _DTYPE_CODE[compute_dtype], _ptr(_cache[key]),
            c.shape[0], sph_res, rho_res, vox_res, sph_res, z_res,
            record_row(z_res), pl["row_stride"], pl["group"],
            ctypes.c_void_p(stream))
        launches[name] += 1
    _check(err, name)
    return out


def stage2(c: torch.Tensor, vox_res: int, sph_res: int = 128,
           z_res: int = 256, rho_res: int = RHO_RES,
           compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K2: c (B, Th, M, V) -> (B, Ph, Th) float32 expected depth."""
    _check_shape(c, (sph_res, rho_res, vox_res), "render_stage2_scan c")
    _dtype_code(compute_dtype)
    if c.device.type == "cpu":
        return stage2_plain(c, vox_res, sph_res, z_res, rho_res,
                            compute_dtype)
    if not 2 <= z_res <= 512:
        raise ValueError(f"render_stage2_scan takes 2..512 samples per "
                         f"ray, not {z_res}")
    return _launch_stage2("render_stage2_scan", c, (sph_res, sph_res),
                          vox_res, sph_res, z_res, rho_res, compute_dtype)


def stage2_samples(c: torch.Tensor, vox_res: int, sph_res: int = 128,
                   z_res: int = 256, rho_res: int = RHO_RES,
                   compute_dtype: torch.dtype = torch.float32
                   ) -> torch.Tensor:
    """K5: c (B, Th, M, V) -> (B, Ph, Th, S) float32 ray samples."""
    _check_shape(c, (sph_res, rho_res, vox_res), "render_stage2_samples c")
    _dtype_code(compute_dtype)
    if c.device.type == "cpu":
        return stage2_samples_plain(c, vox_res, sph_res, z_res, rho_res,
                                    compute_dtype)
    if z_res < 2:
        raise ValueError(f"render_stage2_samples takes 2 or more samples "
                         f"per ray, not {z_res}")
    return _launch_stage2("render_stage2_samples", c,
                          (sph_res, sph_res, z_res), vox_res, sph_res, z_res,
                          rho_res, compute_dtype)


# ---------------------------------------------------------------- gradients
def _scatter_tables(vox_res, sph_res, z_res, rho_res, dtype, device):
    """Rows and weights of the two scatter-adds of the transpose, from the
    tap tables (weights rounded to the compute dtype, as in the forward):
    stage 2, per (ph, s, i, j): row (m0+i)*V + z0+j of c, weight
    wr_i * wz_j; stage 1, per (th, m, i, j): row (x0+i)*V + y0+j of the
    volume, weight wx_i * wy_j."""
    key = ("scatter", vox_res, sph_res, z_res, rho_res, dtype, str(device))
    if key not in _cache:
        t = {k: torch.as_tensor(v) for k, v in
             tap_tables(vox_res, sph_res, z_res, rho_res).items()}
        w = {k: t[k + "_w"].to(dtype).float() for k in "xyzm"}
        ij = torch.arange(2)
        out = {}
        for name, a, bb in (("s2", "m", "z"), ("s1", "x", "y")):
            rows = ((t[a + "_lo"].long()[..., None, None] + ij[:, None])
                    * vox_res + t[bb + "_lo"].long()[..., None, None]
                    + ij[None, :])
            wts = w[a][..., :, None] * w[bb][..., None, :]
            out[name + "_rows"] = rows.reshape(-1).to(device)
            out[name + "_w"] = wts.reshape(-1, 4, 1).to(device)
        _cache[key] = out
    return _cache[key]


def sample_rays_transpose(g: torch.Tensor, vox_res: int, sph_res: int = 128,
                          z_res: int = 256, rho_res: int = RHO_RES,
                          compute_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """The transpose of the sampling map: g (B, Ph, Th, S) -> (B, V, V, V)
    float32.  Stage 2: each sample's cotangent, times its 4 tap weights,
    is added into c's (m, z) rows; stage 1 likewise into the volume's
    (x, y) rows.  Both run as ``index_add_`` over rows of B*Th (B*V)
    contiguous columns."""
    tab = _scatter_tables(vox_res, sph_res, z_res, rho_res, compute_dtype,
                          g.device)
    b, v, m = g.shape[0], vox_res, rho_res
    cols = g.float().permute(1, 3, 0, 2).reshape(sph_res * z_res, -1)
    src = (tab["s2_w"] * cols[:, None, :]).reshape(-1, cols.shape[1])
    gc = cols.new_zeros(m * v, cols.shape[1]).index_add_(
        0, tab["s2_rows"], src)                         # ((m, z), (b, th))
    cols = gc.view(m, v, b, sph_res).permute(3, 0, 2, 1).reshape(
        sph_res * m, b * v)                             # ((th, m), (b, z))
    src = (tab["s1_w"] * cols[:, None, :]).reshape(-1, cols.shape[1])
    gv = cols.new_zeros(v * v, b * v).index_add_(0, tab["s1_rows"], src)
    return gv.view(v, v, b, v).permute(2, 0, 1, 3).contiguous()


def _samples(vox, vox_res, sph_res, z_res, rho_res, compute_dtype):
    c = stage1(vox, vox_res, sph_res, z_res, rho_res, compute_dtype)
    return stage2_samples(c, vox_res, sph_res, z_res, rho_res, compute_dtype)


class _SampleRays(torch.autograd.Function):
    """Forward: K1, K5.  Backward: the transpose of the linear map."""

    @staticmethod
    def forward(ctx, vox, *args):
        ctx.args = args
        return _samples(vox, *args)

    @staticmethod
    def backward(ctx, g):
        return (sample_rays_transpose(g, *ctx.args),) + (None,) * 5


class _RenderExpectedDepth(torch.autograd.Function):
    """Forward: K1, K2.  Backward: the samples again from the saved volume
    (K1, K5), the epilogue's gradient, the transpose."""

    @staticmethod
    def forward(ctx, vox, *args):
        ctx.args = args
        ctx.save_for_backward(vox)
        c = stage1(vox, *args)
        return stage2(c, *args)

    @staticmethod
    def backward(ctx, g):
        (vox,) = ctx.saved_tensors
        p = _samples(vox, *ctx.args)
        with torch.enable_grad():
            p.requires_grad_(True)
            (gp,) = torch.autograd.grad(expected_depth(p), p, g)
        return (sample_rays_transpose(gp, *ctx.args),) + (None,) * 5


def sample_rays(vox: torch.Tensor, vox_res: int, sph_res: int = 128,
                z_res: int = 256, rho_res: int = RHO_RES,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, V, V, V) volume -> (B, Ph, Th, S) float32 ray samples: K1 then
    K5 (their plain versions on the CPU); differentiable in the volume."""
    return _SampleRays.apply(vox, vox_res, sph_res, z_res, rho_res,
                             compute_dtype)


def render_expected_depth(vox: torch.Tensor, vox_res: int,
                          sph_res: int = 128, z_res: int = 256,
                          rho_res: int = RHO_RES,
                          compute_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """(B, V, V, V) clipped occupancy -> (B, R, R) expected-depth map:
    K1 then K2 (their plain versions on the CPU); differentiable in the
    volume."""
    return _RenderExpectedDepth.apply(vox, vox_res, sph_res, z_res, rho_res,
                                      compute_dtype)
