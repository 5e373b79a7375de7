"""The critic's middle convolutions and their activation as one CUDA
kernel, channels-last, its plain version, its GEMM formulation and launch
count.

  K7 ``critic_conv`` (csrc/critic_conv_kernel.cu) computes
     ``leaky_relu(conv3d(x, W, stride 2, padding 1), 0.2)``, k4, no bias:
     x (B, Cin, D, H, W) bfloat16 in ``channels_last_3d`` (NDHWC in
     memory), Cin and Cout multiples of 64, each output extent at least 4
     -> (B, Cout, D/2, H/2, W/2) bfloat16, channels-last.  At res 128 these
     are the critic's ``Conv3D_1`` .. ``Conv3D_4`` (64 -> 64, 64 -> 128,
     128 -> 256, 256 -> 512).  It replaces no Pallas kernel: the JAX
     package leaves the layers to XLA.  On the card cuDNN ran them, NCDHW,
     through its generic ``implicit_convolveNd_sgemm`` or its
     channels-last kernel with layout conversions around it; the kernel is
     an implicit GEMM on the tensor cores (``wgmma``) that reads each
     input chunk of 64 channels once per parity class of the taps.

The kernel serves bfloat16 autocast on the card wherever the layer's
weight takes no gradient (:func:`uses_kernel`): inference, and ShapeHD's
fine-tuning, whose critic is frozen but passes the loss's gradient back
to its input.  The critic takes it where its stem runs K6 (K6's guard),
continuing K6's channels-last output.  A float32 or CPU call, and a
critic whose weights need a gradient (the WGAN-GP critic's training,
whose gradient penalty needs a double backward) or that scores bf16
voxels (WGAN-GP's G phase), runs ``F.conv3d`` and ``F.leaky_relu`` as
before.  It reads x in bfloat16 (K6's and K7's outputs are), rounds the
weight to bfloat16 as autocast's cast would, sums in float32, applies the activation to the
float32 sum and rounds once; the plain version under autocast rounds the
convolution's sum and then the activation's product, so the two differ by
up to one bfloat16 rounding of the output.

The backward (:class:`_CriticConv`) returns x's gradient alone: the
activation's slope applied to the output's gradient by the sign of the
saved output (``F.leaky_relu``'s own backward), then the convolution's
transpose on channels-last tensors (``aten.convolution_backward``, the
input's gradient only).  The JAX package leaves this gradient to XLA's
autodiff.

:func:`critic_conv_gemm` is the kernel's formulation in PyTorch (each
output position's 64 taps x Cin channels, tap-major, over NDHWC, times
the weight as (64 Cin, Cout)), so that the CPU tests hold it, as
``critic_stem_gemm`` does for K6.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import build

SOURCE = "critic_conv_kernel.cu"
SLOPE = 0.2
#: the channel multiple the kernel takes, in and out
CHANNELS = 64

#: launches of the kernel since the last :func:`reset_launches`
launches: Dict[str, int] = {"critic_conv": 0, "critic_conv_backward": 0}

_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def critic_conv_plain(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x (B, Cin, D, H, W), weight (Cout, Cin, 4, 4, 4) ->
    ``leaky_relu(conv3d(x, weight, stride 2, padding 1), 0.2)``."""
    return F.leaky_relu(F.conv3d(x, weight, None, 2, 1), SLOPE)


def critic_conv_gemm(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The kernel's formulation: x as NDHWC, padded by one voxel, each
    output position's 4 x 4 x 4 taps (kd, kh, kw; kw fastest) of Cin
    channels as a row of 64 Cin, tap-major, times the weight as (64 Cin,
    Cout), the activation on the sum; (B, Cout, D/2, H/2, W/2)."""
    bsz, cin = x.shape[:2]
    cout = weight.shape[0]
    xp = F.pad(x.permute(0, 2, 3, 4, 1), (0, 0, 1, 1, 1, 1, 1, 1))
    taps = xp.unfold(1, 4, 2).unfold(2, 4, 2).unfold(3, 4, 2)
    od, oh, ow = taps.shape[1:4]
    cols = taps.permute(0, 1, 2, 3, 5, 6, 7, 4).reshape(bsz, od * oh * ow,
                                                        64 * cin)
    w = weight.permute(0, 2, 3, 4, 1).reshape(cout, 64 * cin).to(x.dtype)
    out = F.leaky_relu(cols @ w.t(), SLOPE)
    return out.reshape(bsz, od, oh, ow, cout).permute(0, 4, 1, 2, 3)


def takes(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """Whether K7 takes the call: x (B, Cin, D, H, W) bfloat16 on a CUDA
    device (K6's or K7's output), even D, H, W of at least 8, the weight (Cout,
    Cin, 4, 4, 4) on x's device, Cin and Cout multiples of 64, and no
    gradient recorded for the weight (x's may be)."""
    return (x.device.type == "cuda" and weight.device == x.device
            and x.dtype == torch.bfloat16
            and x.dim() == 5 and weight.dim() == 5
            and weight.shape[1] == x.shape[1]
            and tuple(weight.shape[2:]) == (4, 4, 4)
            and x.shape[1] % CHANNELS == 0
            and weight.shape[0] % CHANNELS == 0
            and all(n % 2 == 0 and n >= 8 for n in x.shape[2:])
            and not (torch.is_grad_enabled() and weight.requires_grad))


def uses_kernel(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """Whether a middle layer of the critic (k4 s2 p1, no bias) runs K7:
    the kernel :func:`takes` the call and bf16 autocast is on for CUDA."""
    return (takes(x, weight) and torch.is_autocast_enabled("cuda")
            and torch.get_autocast_dtype("cuda") == torch.bfloat16)


def _library():
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.critic_conv.argtypes = [p, p, p, i, i, i, i, i, i, p]
        lib.critic_conv.restype = i
        _lib = lib
    return _lib


def pack_weight(weight: torch.Tensor) -> torch.Tensor:
    """The weight (Cout, Cin, 4, 4, 4) as the kernel reads it: bfloat16
    (Cout, 64 taps, Cin), tap-major."""
    cout, cin = weight.shape[:2]
    return weight.to(torch.bfloat16).permute(0, 2, 3, 4, 1).reshape(
        cout, 64 * cin).contiguous()


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K7's launch on x (B, Cin, D, H, W) bfloat16 channels-last and the
    packed weight: (B, Cout, D/2, H/2, W/2) bfloat16, channels-last."""
    bsz, cin, d, h, wd = x.shape
    cout = w.shape[0]
    out = torch.empty((bsz, d // 2, h // 2, wd // 2, cout),
                      dtype=torch.bfloat16, device=x.device)
    lib = _library()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())          # noqa: E731
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.critic_conv(ptr(x), ptr(w), ptr(out), bsz, d, h, wd, cin,
                              cout, ctypes.c_void_p(stream))
        launches["critic_conv"] += 1
    if err != 0:
        raise RuntimeError(f"critic_conv: CUDA error {err} at launch")
    return out.permute(0, 4, 1, 2, 3)


def input_grad(g: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
               weight: torch.Tensor) -> torch.Tensor:
    """x's gradient from the gradient ``g`` of the layer's output ``y``:
    ``g`` where y > 0, ``SLOPE * g`` elsewhere (the activation's backward
    on its own output), then the convolution's transpose onto x's shape
    (``aten.convolution_backward``, the input's gradient alone), in the
    layout g and x have: channels-last on the card's path."""
    masked = torch.ops.aten.leaky_relu_backward(g, y, SLOPE, True)
    return torch.ops.aten.convolution_backward(
        masked, x, weight, None, [2, 2, 2], [1, 1, 1], [1, 1, 1], False,
        [0, 0, 0], 1, [True, False, False])[0]


class _CriticConv(torch.autograd.Function):
    """Forward: K7, x and the output saved.  Backward: x's gradient by
    :func:`input_grad` on channels-last bfloat16 tensors (the weight takes
    none)."""

    @staticmethod
    def forward(ctx, x, weight):
        x = x.contiguous(memory_format=torch.channels_last_3d)
        y = _launch(x, pack_weight(weight))
        ctx.save_for_backward(x, y, weight)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, y, weight = ctx.saved_tensors
        cl = torch.channels_last_3d
        wb = weight.to(torch.bfloat16).contiguous(memory_format=cl)
        gx = input_grad(g.to(torch.bfloat16).contiguous(memory_format=cl),
                        y, x, wb)
        launches["critic_conv_backward"] += 1
        return gx, None


def critic_conv(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """K7 on x (B, Cin, D, H, W) and the layer's weight (Cout, Cin, 4, 4, 4)
    as ``nn.Conv3d`` holds it: (B, Cout, D/2, H/2, W/2) bfloat16 in
    ``channels_last_3d``, with x's gradient where autograd records one."""
    if not takes(x, weight):
        raise ValueError(
            f"critic_conv takes x (B, Cin, D, H, W) bfloat16 "
            f"with even D, H, W >= 8, and a weight (Cout, Cin, 4, 4, 4), "
            f"Cin and Cout multiples of {CHANNELS}, on one CUDA device, with "
            f"no gradient recorded for the weight (K7 has no backward for "
            f"it); got x {tuple(x.shape)} {x.dtype} on {x.device}, weight "
            f"{tuple(weight.shape)} on {weight.device}, weight grad "
            f"{torch.is_grad_enabled() and weight.requires_grad}")
    return _CriticConv.apply(x, weight)

