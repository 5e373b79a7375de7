"""The critic's first layer and its activation as one CUDA kernel, its
plain version, its GEMM formulation and launch count.

  K6 ``critic_stem`` (csrc/critic_stem_kernel.cu) computes
     ``leaky_relu(conv3d(v, W, stride 2, padding 1), 0.2)`` for one input
     channel and 64 output channels, k4, no bias: v (B, 1, R, R, R)
     float32 (the critic's probabilities), R in {32, 64, 128} -> (B, 64,
     R/2, R/2, R/2) bfloat16.  It replaces no Pallas kernel: the JAX
     package leaves the layer to XLA.  On the card cuDNN runs the layer
     through its channels-last kernel with layout conversions around it,
     and the cast and the activation as passes of their own; the kernel
     reads v once and writes the activation once.

The kernel serves inference under bfloat16 autocast only
(:func:`uses_kernel`): it has no backward and no float32 path, so a
gradient-recording, float32 or CPU call runs ``nn.Conv3d`` and
``F.leaky_relu`` as before.  It reads v as float32 and rounds it to
bfloat16 as autocast's cast would, rounds the float32 weight
to bfloat16, sums in float32, applies the activation to the float32 sum
and rounds once.  The plain version under autocast rounds the
convolution's sum and then the activation's product, so the two differ by
up to one bfloat16 rounding of the output.

:func:`critic_stem_gemm` is the kernel's formulation in PyTorch (each
output position's 64 taps times the (64 taps x 64 channels) weight), so
that the CPU tests hold it, as ``deconv_final_gemm`` does for K3.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch
import torch.nn.functional as F

from . import build

SOURCE = "critic_stem_kernel.cu"
#: the R the kernel is instantiated for (the ``switch`` of its entry point)
RESOLUTIONS = (32, 64, 128)
#: the layer's output channels
COUT = 64
SLOPE = 0.2

#: launches of the kernel since the last :func:`reset_launches`
launches: Dict[str, int] = {"critic_stem": 0}

_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def critic_stem_plain(v: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """v (B, 1, R, R, R), weight (64, 1, 4, 4, 4) ->
    ``leaky_relu(conv3d(v, weight, stride 2, padding 1), 0.2)``."""
    return F.leaky_relu(F.conv3d(v, weight, None, 2, 1), SLOPE)


def critic_stem_gemm(v: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The kernel's formulation: v padded by one voxel, each output
    position's 4 x 4 x 4 taps (kd, kh, kw; kw fastest) as a row of 64,
    times the weight as (64 taps, 64 channels), the activation on the sum,
    channels first."""
    bsz, r = v.shape[0], v.shape[2]
    o = r // 2
    vp = F.pad(v[:, 0], (1, 1, 1, 1, 1, 1))
    taps = vp.unfold(1, 4, 2).unfold(2, 4, 2).unfold(3, 4, 2)
    cols = taps.reshape(bsz, o * o * o, 64)
    out = cols @ weight.reshape(weight.shape[0], 64).t().to(v.dtype)
    out = F.leaky_relu(out, SLOPE)
    return out.transpose(1, 2).reshape(bsz, weight.shape[0], o, o, o)


def takes(v: torch.Tensor, weight: torch.Tensor) -> bool:
    """Whether K6 takes the call: v (B, 1, R, R, R) float32 at an R the
    kernel is built for, the weight (64, 1, 4, 4, 4) on v's CUDA device,
    and autograd recording nothing of the call."""
    return (v.device.type == "cuda" and weight.device == v.device
            and v.dtype == torch.float32 and v.dim() == 5
            and v.shape[1] == 1 and v.shape[2] in RESOLUTIONS
            and v.shape[2] == v.shape[3] == v.shape[4]
            and tuple(weight.shape) == (COUT, 1, 4, 4, 4)
            and not (torch.is_grad_enabled()
                     and (v.requires_grad or weight.requires_grad)))


def uses_kernel(v: torch.Tensor, weight: torch.Tensor) -> bool:
    """Whether the critic's first layer (k4 s2 p1, no bias) runs K6: the
    kernel :func:`takes` the call and bf16 autocast is on for CUDA."""
    return (takes(v, weight) and torch.is_autocast_enabled("cuda")
            and torch.get_autocast_dtype("cuda") == torch.bfloat16)


def _library():
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.critic_stem.argtypes = [p, p, p, i, i, p]
        lib.critic_stem.restype = i
        _lib = lib
    return _lib


def critic_stem(v: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """K6 on v (B, 1, R, R, R) and the layer's weight (64, 1, 4, 4, 4) as
    ``nn.Conv3d`` holds it: (B, 64, R/2, R/2, R/2) bfloat16, no gradient."""
    if not takes(v, weight):
        raise ValueError(
            f"critic_stem takes float32 v (B, 1, R, R, R), R in "
            f"{RESOLUTIONS}, and a weight ({COUT}, 1, 4, 4, 4) on one CUDA "
            f"device, with no gradient recorded (K6 has no backward); got "
            f"v {tuple(v.shape)} {v.dtype} on {v.device}, weight "
            f"{tuple(weight.shape)} on {weight.device}, grad "
            f"{torch.is_grad_enabled()}")
    v = v.contiguous()
    w = weight.float().reshape(COUT, 64).contiguous()
    bsz, r = v.shape[0], v.shape[2]
    out = torch.empty((bsz, COUT, r // 2, r // 2, r // 2),
                      dtype=torch.bfloat16, device=v.device)
    lib = _library()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())          # noqa: E731
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.critic_stem(ptr(v), ptr(w), ptr(out), bsz, r,
                              ctypes.c_void_p(stream))
        launches["critic_stem"] += 1
    if err != 0:
        raise RuntimeError(f"critic_stem: CUDA error {err} at launch")
    return out
