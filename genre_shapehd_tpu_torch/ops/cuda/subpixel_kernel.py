"""The final deconv of the 3D U-Net as one CUDA kernel, its plain version
and launch count (counterpart of
``genre_shapehd_tpu/ops/pallas/subpixel_kernel.py``).

  K3 ``deconv_final`` (csrc/deconv_final_kernel.cu) computes the whole of
     the JAX package's ``deconv_final_fused`` -- the phase conv that XLA
     runs there and the phase assembly of the Pallas ``_final_tail_kernel``:
     ``ConvTranspose3d(Cin -> 1, k=4, s=2, p=1)`` plus bias,
     x (B, Cin, X, Y, Z) -> (B, 1, 2X, 2Y, 2Z), float32 or bfloat16;
     or, on a Z slab of the sharded 3D U-Net (``parallel/mesh.py``), the
     output planes of ``z_out`` input positions from ``z_lo`` (0 or 1)
     of an x whose first and last Z planes are the neighbours' halo:
     (B, 1, 2X, 2Y, 2 z_out).

:func:`deconv_final` launches the kernel on CUDA tensors and runs the
plain version (:func:`deconv_final_plain`, ``F.conv_transpose3d``) on CPU
tensors.  A CUDA tensor either launches the kernel or raises.

The kernel is outside autocast's reach, so the wrapper does what autocast
would: with autocast on for the tensor's device the compute dtype is the
autocast dtype, else the input's; x and the weight are rounded to it.  The
kernel accumulates in float32, adds the float32 bias and rounds once to
the compute dtype, half a bfloat16 step from the float32 result.  The
plain version in bfloat16 rounds more than once inside the library (the
sum, the bias, their sum), so the two differ by up to two bfloat16 steps
of the output.

In bfloat16 the kernel computes the layer on the tensor cores as a GEMM
per block: the 27 neighbour offsets of each input position times the
channels, against :func:`pack_weight`'s (27, Cin_pad, 8) weight with its
structured zeros, into the 8 output phases.  :func:`deconv_final_gemm` is
the same contraction in PyTorch, so that the CPU tests hold the
formulation.  In float32, and in bfloat16 where that tiling does not
apply (Z > 64, Z not a multiple of 8, Cin > 288), the CUDA cores
compute the 8 taps of each phase directly, as the plain version does.

The gradient (:func:`deconv_final_backward`) is the plain version's,
computed by ``aten.convolution_backward`` without running the forward
again; the JAX package has no backward kernel either (``_df_bwd`` is the
VJP of ``_final_ref_xla``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import build

SOURCE = "deconv_final_kernel.cu"

#: launches of the kernel since the last :func:`reset_launches`
launches: Dict[str, int] = {"deconv_final": 0}
#: the launches on a box or a Z slab (not on a cube) by shape, (B, Cin,
#: X, Y, Z, z_lo, z_out)
slab_launches: Dict[Tuple[int, ...], int] = {}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    slab_launches.clear()


def _z_range(x: torch.Tensor, z_lo: int, z_out) -> int:
    return x.shape[4] - 2 * z_lo if z_out is None else z_out


def deconv_final_plain(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, z_lo: int = 0,
                       z_out: int = None) -> torch.Tensor:
    """x (B, Cin, X, Y, Z), weight (Cin, 1, 4, 4, 4), bias (1,) -> the
    output planes 2 z_lo .. 2 (z_lo + z_out) - 1 of (B, 1, 2X, 2Y, 2Z)
    (all of them by default); parameters are cast to x's dtype unless
    autocast does it."""
    if not torch.is_autocast_enabled(x.device.type):
        weight, bias = weight.to(x.dtype), bias.to(x.dtype)
    out = F.conv_transpose3d(x, weight, bias, stride=2, padding=1)
    z_out = _z_range(x, z_lo, z_out)
    if (z_lo, z_out) == (0, x.shape[4]):
        return out
    return out[..., 2 * z_lo:2 * (z_lo + z_out)]


def pack_weight(weight: torch.Tensor) -> torch.Tensor:
    """(Cin, 1, 4, 4, 4) -> B (27, Cin_pad, 8), Cin_pad = Cin rounded up to
    16: B[d, c, g] for the offset d = (di, dj, dk) in {0,1,2}^3 and the
    output phase g = (a, e, f) in {0,1}^3 is the tap (3+a-2di, 3+e-2dj,
    3+f-2dk) of channel c where every d - phase is 0 or 1, else 0; padded
    channels are 0.  The kernel builds the same B in shared memory."""
    cin = weight.shape[0]
    b = weight.new_zeros((27, -(-cin // 16) * 16, 8))
    for d in range(27):
        di, dj, dk = d // 9, d // 3 % 3, d % 3
        for g in range(8):
            a, e, f = g >> 2, g >> 1 & 1, g & 1
            if 0 <= di - a <= 1 and 0 <= dj - e <= 1 and 0 <= dk - f <= 1:
                b[d, :cin, g] = weight[:, 0, 3 + a - 2 * di, 3 + e - 2 * dj,
                                       3 + f - 2 * dk]
    return b


def deconv_final_gemm(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, z_lo: int = 0,
                      z_out: int = None) -> torch.Tensor:
    """The kernel's formulation in PyTorch: x padded by one voxel, its 27
    shifted views (B, 27, Cin, X, Y, z_out) from Z position ``z_lo``
    contracted with :func:`pack_weight` into 8 phases per input position,
    the phases interleaved into (B, 1, 2X, 2Y, 2 z_out), plus bias."""
    bsz, cin, nx, ny = x.shape[:4]
    nz = _z_range(x, z_lo, z_out)
    xp = F.pad(x, (1, 1, 1, 1, 1, 1))
    cols = torch.stack([xp[:, :, d // 9:d // 9 + nx, d // 3 % 3:d // 3 % 3
                           + ny, z_lo + d % 3:z_lo + d % 3 + nz]
                        for d in range(27)], 1)
    ph = torch.einsum("bdcijk,dcg->bijkg", cols,
                      pack_weight(weight)[:, :cin].to(x.dtype))
    out = ph.reshape(bsz, nx, ny, nz, 2, 2, 2).permute(0, 1, 4, 2, 5, 3, 6)
    return out.reshape(bsz, 1, 2 * nx, 2 * ny, 2 * nz) + bias.to(x.dtype)


def deconv_final_backward(grad: torch.Tensor, x: torch.Tensor,
                          weight: torch.Tensor, needs=(True, True, True),
                          z_lo: int = 0):
    """Gradients of :func:`deconv_final_plain` (``conv_transpose3d(x,
    weight, bias, stride=2, padding=1)``, its Z planes from ``2 z_lo``)
    with respect to (x, weight, bias), each None where ``needs`` says so:
    one ``aten.convolution_backward`` in x's dtype, no forward, of
    ``grad`` widened by zero planes to the whole output; the weight's and
    the bias's come back in the weight's dtype."""
    rest = 2 * x.shape[4] - 2 * z_lo - grad.shape[4]
    if z_lo or rest:
        grad = F.pad(grad, (2 * z_lo, rest))
    gx, gw, gb = torch.ops.aten.convolution_backward(
        grad.to(x.dtype), x, weight.to(x.dtype), [1], [2, 2, 2], [1, 1, 1],
        [1, 1, 1], True, [0, 0, 0], 1, list(needs))
    return (gx, None if gw is None else gw.to(weight.dtype),
            None if gb is None else gb.to(weight.dtype))


def _library():
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.deconv_final.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.deconv_final_slab.argtypes = [p, p, p, p] + [i] * 8 + [p]
        lib.deconv_final.restype = lib.deconv_final_slab.restype = i
        _lib = lib
    return _lib


def _check_args(x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor, z_lo: int, z_out) -> None:
    if x.dim() != 5:
        raise ValueError(f"deconv_final: x must be (B, Cin, X, Y, Z), got "
                         f"{tuple(x.shape)}")
    if z_lo or z_out is not None:
        n = _z_range(x, z_lo, z_out)
        if z_lo not in (0, 1) or n < 1 or z_lo + n > x.shape[4]:
            raise ValueError(f"deconv_final: output planes of Z positions "
                             f"{z_lo} .. {z_lo + n - 1} of x "
                             f"{tuple(x.shape)}; z_lo must be 0 or 1")
    if tuple(weight.shape) != (x.shape[1], 1, 4, 4, 4):
        raise ValueError(f"deconv_final: weight must be ({x.shape[1]}, 1, 4, "
                         f"4, 4), got {tuple(weight.shape)}")
    if tuple(bias.shape) != (1,):
        raise ValueError(f"deconv_final: bias must be (1,), got "
                         f"{tuple(bias.shape)}")


def _launch(x: torch.Tensor, weight: torch.Tensor,
            bias: torch.Tensor) -> torch.Tensor:
    """The whole layer on a cube, the main path's call.  x already in the
    compute dtype; weight (rounded by the kernel to x's dtype), bias
    float32; all CUDA."""
    x = x.contiguous()                   # NCDHW; a channels-last x is copied
    w = weight.reshape(x.shape[1], 64).contiguous()
    b = bias.contiguous()
    bsz, cin, s = x.shape[0], x.shape[1], x.shape[2]
    out = torch.empty((bsz, 1, 2 * s, 2 * s, 2 * s), dtype=x.dtype,
                      device=x.device)
    lib = _library()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())          # noqa: E731
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.deconv_final(ptr(x), ptr(w), ptr(b), ptr(out),
                               _DTYPE_CODE[x.dtype], bsz, cin, s,
                               ctypes.c_void_p(stream))
        launches["deconv_final"] += 1
    if err != 0:
        raise RuntimeError(f"deconv_final: CUDA error {err} at launch")
    return out


def _launch_slab(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 z_lo: int, z_out) -> torch.Tensor:
    """As :func:`_launch`, for any other call: a box, or the output
    planes of ``z_out`` Z positions from ``z_lo``."""
    x = x.contiguous()
    w = weight.reshape(x.shape[1], 64).contiguous()
    b = bias.contiguous()
    bsz, cin, nx, ny, nz = x.shape
    z_out = _z_range(x, z_lo, z_out)
    out = torch.empty((bsz, 1, 2 * nx, 2 * ny, 2 * z_out), dtype=x.dtype,
                      device=x.device)
    lib = _library()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())          # noqa: E731
    shape = (bsz, cin, nx, ny, nz, z_lo, z_out)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.deconv_final_slab(ptr(x), ptr(w), ptr(b), ptr(out),
                                    _DTYPE_CODE[x.dtype], *shape,
                                    ctypes.c_void_p(stream))
        launches["deconv_final"] += 1
        slab_launches[shape] = slab_launches.get(shape, 0) + 1
    if err != 0:
        raise RuntimeError(f"deconv_final: CUDA error {err} at launch")
    return out


class _DeconvFinal(torch.autograd.Function):
    """Forward: K3 on a cube.  Backward: the gradient of the plain
    version."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        return _launch(x, weight, bias)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        return deconv_final_backward(grad, x, weight, ctx.needs_input_grad)


class _DeconvFinalSlab(torch.autograd.Function):
    """Forward: K3 on a box or a Z slab.  Backward: the gradient of the
    plain version."""

    @staticmethod
    def forward(ctx, x, weight, bias, z_lo, z_out):
        ctx.save_for_backward(x, weight)
        ctx.z_lo = z_lo
        return _launch_slab(x, weight, bias, z_lo, z_out)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        return deconv_final_backward(grad, x, weight,
                                     ctx.needs_input_grad[:3],
                                     ctx.z_lo) + (None, None)


def deconv_final(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor, z_lo: int = 0,
                 z_out: int = None) -> torch.Tensor:
    """``ConvTranspose3d(Cin -> 1, k=4, s=2, p=1)(x)`` with the layer's
    parameters as ``nn.ConvTranspose3d`` holds them, or its output planes
    of ``z_out`` Z positions from ``z_lo`` (0 or 1): K3 on CUDA tensors,
    the plain version on CPU tensors."""
    _check_args(x, weight, bias, z_lo, z_out)
    if x.device.type == "cpu":
        return deconv_final_plain(x, weight, bias, z_lo, z_out)
    if x.device.type != "cuda" or weight.device != x.device \
            or bias.device != x.device:
        raise RuntimeError(
            f"deconv_final: x on {x.device}, weight on {weight.device}, bias "
            f"on {bias.device}; the kernel runs on one CUDA device and its "
            "plain version on the CPU only")
    dtype = (torch.get_autocast_dtype("cuda")
             if torch.is_autocast_enabled("cuda") else x.dtype)
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"deconv_final takes float32 or bfloat16, not {dtype}")
    # the weight goes to the kernel as float32 and is rounded there to the
    # compute dtype, like x; the bias stays float32
    if z_lo == 0 and z_out is None and x.shape[2] == x.shape[3] == x.shape[4]:
        return _DeconvFinal.apply(x.to(dtype), weight.float(), bias.float())
    return _DeconvFinalSlab.apply(x.to(dtype), weight.float(), bias.float(),
                                  z_lo, z_out)
