"""The critic's first layer and its activation as one CUDA kernel, its
plain version, its GEMM formulation and launch count.

  K6 ``critic_stem`` (csrc/critic_stem_kernel.cu) computes
     ``leaky_relu(conv3d(v, W, stride 2, padding 1), 0.2)`` for one input
     channel and 64 output channels, k4, no bias: v (B, 1, R, R, R)
     float32 (the critic's probabilities), R in {32, 64, 128} -> (B, 64,
     R/2, R/2, R/2) bfloat16 in ``channels_last_3d``, the layout the
     critic's next layers read (K7, ``critic_conv_kernel.py``).  It
     replaces no Pallas kernel: the JAX package leaves the layer to
     XLA.  On the card cuDNN runs the layer
     through its channels-last kernel with layout conversions around it,
     and the cast and the activation as passes of their own; the kernel
     reads v once and writes the activation once.

The kernel serves bfloat16 autocast on the card wherever the layer's
weight takes no gradient (:func:`uses_kernel`): inference, and ShapeHD's
fine-tuning, whose critic is frozen but passes the loss's gradient back
to its input.  It has no float32 path and no gradient for the weight, so
a float32 or CPU call, and one whose weight needs a gradient (the
WGAN-GP critic's training), runs ``nn.Conv3d`` and ``F.leaky_relu`` as
before.  It reads v as float32 and rounds it to
bfloat16 as autocast's cast would, rounds the float32 weight
to bfloat16, sums in float32, applies the activation to the float32 sum
and rounds once.  The plain version under autocast rounds the
convolution's sum and then the activation's product, so the two differ by
up to one bfloat16 rounding of the output.

The backward (:class:`_CriticStem`) returns v's gradient alone,
:func:`input_grad`: the activation's slope applied to the output's
gradient g by the sign of the saved output y (the sign of the
pre-activation, the slope being positive), written channels-first,
then the convolution's transpose, ``conv_transpose3d(., W, stride 2,
padding 1)`` from 64
channels to one, which is the function K3 computes
(``subpixel_kernel.py``; the stem's weight (64, 1, 4, 4, 4) is K3's
layout), on bfloat16 with a zero bias, then the float32 upcast that
autocast's cast of v gives its gradient.  The mask is
``F.leaky_relu``'s own backward, one pass that rounds 0.2 g to bfloat16;
on the card it is a kernel of K6's source (``critic_stem_mask``) that
reads g and y channels-last, as K7's backward and K6 leave them, and
writes the channels-first tensor K3 reads, so that no layout pass runs.
K3 sums its taps in float32 and rounds once, where cuDNN's transposed
convolution may round more often.

:func:`critic_stem_gemm` is the kernel's formulation in PyTorch (each
output position's 64 taps times the (64 taps x 64 channels) weight), so
that the CPU tests hold it, as ``deconv_final_gemm`` does for K3.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import build
from . import subpixel_kernel

SOURCE = "critic_stem_kernel.cu"
#: the R the kernel is instantiated for (the ``switch`` of its entry point)
RESOLUTIONS = (32, 64, 128)
#: the layer's output channels
COUT = 64
SLOPE = 0.2

#: launches since the last :func:`reset_launches`: K6, its backward (the
#: mask and K3 together) and the mask kernel alone
launches: Dict[str, int] = {"critic_stem": 0, "critic_stem_backward": 0,
                            "critic_stem_mask": 0}

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


def mask_plain(g: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``g`` where y > 0, ``SLOPE * g`` elsewhere (the activation's
    backward on its own output), channels-first."""
    return torch.ops.aten.leaky_relu_backward(g, y, SLOPE, True).contiguous()


def input_grad(g: torch.Tensor, y: torch.Tensor, weight: torch.Tensor,
               deconv=subpixel_kernel.deconv_final_plain,
               mask=mask_plain) -> torch.Tensor:
    """v's gradient from the gradient ``g`` of the stem's output ``y``
    (both (B, 64, S, S, S)): ``mask(g, y)``, ``g`` where y > 0, ``SLOPE *
    g`` elsewhere, channels-first (one elementwise pass), then
    ``deconv(., weight, 0)``, ``conv_transpose3d`` with stride 2 and
    padding 1 to (B, 1, 2S, 2S, 2S), in float32.  ``mask`` and ``deconv``
    are the mask kernel's and K3's launches on the card, their plain
    versions in the tests."""
    masked = mask(g, y)
    return deconv(masked, weight, weight.new_zeros(1)).float()


def takes(v: torch.Tensor, weight: torch.Tensor) -> bool:
    """Whether K6 takes the call: v (B, 1, R, R, R) float32 at an R the
    kernel is built for, the weight (64, 1, 4, 4, 4) on v's CUDA device,
    and no gradient recorded for the weight (v's may be)."""
    return (v.device.type == "cuda" and weight.device == v.device
            and v.dtype == torch.float32 and v.dim() == 5
            and v.shape[1] == 1 and v.shape[2] in RESOLUTIONS
            and v.shape[2] == v.shape[3] == v.shape[4]
            and tuple(weight.shape) == (COUT, 1, 4, 4, 4)
            and not (torch.is_grad_enabled() and weight.requires_grad))


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
        lib.critic_stem_mask.argtypes = [p, p, p, i, i, p]
        lib.critic_stem_mask.restype = i
        _lib = lib
    return _lib


def _launch(v: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """K6's launch: (B, 64, R/2, R/2, R/2) bfloat16, channels-last."""
    v = v.contiguous()
    w = weight.float().reshape(COUT, 64).contiguous()
    bsz, r = v.shape[0], v.shape[2]
    out = torch.empty((bsz, r // 2, r // 2, r // 2, COUT),
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
    return out.permute(0, 4, 1, 2, 3)


def _mask_launch(g: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The backward's mask on the card: g and y (B, 64, S, S, S) bf16,
    read channels-last -> (B, 64, S, S, S) bf16, contiguous."""
    cl = torch.channels_last_3d
    g, y = g.contiguous(memory_format=cl), y.contiguous(memory_format=cl)
    bsz, s = g.shape[0], g.shape[2]
    out = torch.empty(g.shape, dtype=torch.bfloat16, device=g.device)
    lib = _library()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())          # noqa: E731
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.critic_stem_mask(ptr(g), ptr(y), ptr(out), bsz, s,
                                   ctypes.c_void_p(stream))
        launches["critic_stem_mask"] += 1
    if err != 0:
        raise RuntimeError(f"critic_stem_mask: CUDA error {err} at launch")
    return out


class _CriticStem(torch.autograd.Function):
    """Forward: K6, its output saved.  Backward: v's gradient by
    :func:`input_grad` with the mask kernel and K3's launch on the card
    (the weight takes none)."""

    @staticmethod
    def forward(ctx, v, weight):
        y = _launch(v, weight)
        ctx.save_for_backward(y, weight)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        y, weight = ctx.saved_tensors
        mask = _mask_launch if g.is_cuda else mask_plain
        gv = input_grad(g.to(torch.bfloat16), y, weight.float(),
                        subpixel_kernel._launch, mask)
        launches["critic_stem_backward"] += 1
        return gv, None


def critic_stem(v: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """K6 on v (B, 1, R, R, R) and the layer's weight (64, 1, 4, 4, 4) as
    ``nn.Conv3d`` holds it: (B, 64, R/2, R/2, R/2) bfloat16, with v's
    gradient where autograd records one."""
    if not takes(v, weight):
        raise ValueError(
            f"critic_stem takes float32 v (B, 1, R, R, R), R in "
            f"{RESOLUTIONS}, and a weight ({COUT}, 1, 4, 4, 4) on one CUDA "
            f"device, with no gradient recorded for the weight (K6 has no "
            f"backward for it); got v {tuple(v.shape)} {v.dtype} on "
            f"{v.device}, weight {tuple(weight.shape)} on {weight.device}, "
            f"weight grad {torch.is_grad_enabled() and weight.requires_grad}")
    return _CriticStem.apply(v, weight)
