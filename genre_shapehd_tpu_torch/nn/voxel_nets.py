"""3D conv building blocks and the voxel nets of the MarrNet / ShapeHD
family, NCDHW (counterpart of ``genre_shapehd_tpu/nn/voxel_nets.py``).

The JAX package's ``SubpixelTConv3D`` and ``DepthPhaseConv3D`` are TPU
layouts of a plain ``ConvTranspose3d`` / ``Conv3d`` with the same
parameters, so here each is the plain layer -- except the one-channel
``k4 s2 p1`` deconv (dec6 of the 3D U-Net, the last layer of
``VoxelDecoder`` and of ``VoxelGenerator``), which runs the hand-written
kernel K3 on CUDA tensors (``ops/cuda/subpixel_kernel.py``).  The wrapper
names (``Conv_0``, ``ConvTranspose_0``, ``Deconv3D_3``, ``BatchNorm_1``)
mirror the Flax parameter tree.

``Conv3D`` and ``Deconv3D`` also run on this rank's Z slab of a volume
that the sp ranks share (``slab=True``; ``parallel/mesh.py``, the
sharded 3D U-Net): the slab is widened by the halo planes its outputs
reach (:func:`conv_halo`, :func:`deconv_halo`), and the layer runs with
no padding along Z, so that each rank computes the outputs of its own
planes, those of one process.
"""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda import critic_conv_kernel, critic_stem_kernel
from ..ops.cuda.subpixel_kernel import deconv_final
from ..parallel import mesh
from ..utils import trace
from .resnet import batch_norm


def conv_halo(k: int, s: int, p: int):
    """(lo, hi): the planes before and after a slab of Zs input planes
    (Zs a multiple of s) that ``Conv3d(k, s, p)`` reads for the slab's
    Zs / s outputs, ``p`` and ``k - s - p``."""
    return p, k - s - p


def deconv_halo(k: int, s: int, p: int):
    """(lo, hi, pad): the input planes before and after a slab of Zs that
    ``ConvTranspose3d(k, s, p)`` reads for the slab's s Zs outputs, and
    the Z padding that crops the halo'd slab's output to them.  Output o
    takes inputs (o + p - k + 1) / s .. (o + p) / s, so the slab's outputs
    s z0 .. s (z0 + Zs) - 1 take z0 - lo .. z0 + Zs - 1 + hi."""
    lo, hi = (k - 1 - p) // s, (p - 1) // s + 1
    pad = s * lo + p
    if s * (lo + hi - 1) + k != 2 * pad:
        raise ValueError(f"ConvTranspose3d(k={k}, s={s}, p={p}) on a slab "
                         "needs an uneven crop")
    return lo, hi, pad


class Conv3D(nn.Module):
    """Conv3d(k, s, p)."""

    def __init__(self, cin: int, features: int, kernel: int = 4,
                 stride: int = 2, torch_padding: int = 1,
                 use_bias: bool = True):
        super().__init__()
        self.Conv_0 = nn.Conv3d(cin, features, kernel, stride, torch_padding,
                                bias=use_bias)

    def forward(self, x, slab: bool = False):
        if not slab:
            return self.Conv_0(x)
        c = self.Conv_0
        (k, _, _), (s, _, _), (p, _, _) = (c.kernel_size, c.stride,
                                           c.padding)
        if x.shape[4] % s:
            raise ValueError(f"a Z slab of {x.shape[4]} planes for stride "
                             f"{s}")
        x = mesh.halo(x, *conv_halo(k, s, p))
        return F.conv3d(x, c.weight, c.bias, s, (p, p, 0))


class Deconv3D(nn.Module):
    """ConvTranspose3d(k, s, p).  With one output channel and k4 s2 p1 the
    layer's weight and bias go through :func:`deconv_final`: K3 on a CUDA
    tensor, ``F.conv_transpose3d`` on a CPU tensor.  Without a bias K3
    adds a zero one, a buffer outside the ``state_dict``."""

    def __init__(self, cin: int, features: int, kernel: int = 4,
                 stride: int = 1, torch_padding: int = 0,
                 use_bias: bool = True):
        super().__init__()
        self.ConvTranspose_0 = nn.ConvTranspose3d(
            cin, features, kernel, stride, torch_padding, bias=use_bias)
        self.final = (features, kernel, stride, torch_padding) == (1, 4, 2, 1)
        if self.final and not use_bias:
            self.register_buffer("zero_bias", torch.zeros(1),
                                 persistent=False)

    def forward(self, x, slab: bool = False):
        c = self.ConvTranspose_0
        bias = self.zero_bias if self.final and c.bias is None else c.bias
        if not slab:
            if self.final:
                return deconv_final(x, c.weight, bias)
            return c(x)
        (k, _, _), (s, _, _), (p, _, _) = (c.kernel_size, c.stride,
                                           c.padding)
        zs = x.shape[4]
        lo, hi, pad = deconv_halo(k, s, p)
        if self.final:
            # K3 takes the halo'd slab in rows of whole 16-byte units
            return deconv_final(mesh.halo(x, lo, hi, align=8), c.weight,
                                bias, lo, zs)
        return F.conv_transpose3d(mesh.halo(x, lo, hi), c.weight, bias, s,
                                  (p, p, pad))


class VoxelDecoder(nn.Module):
    """Latent (N, n_dims) -> (N, res, res, res) logits: a k4 VALID deconv
    to 4³ at ``nf``, BatchNorm + ReLU, 2x deconvs halving the channels,
    and a last 2x deconv to one channel (K3) without norm or activation.
    At res 128 and nf 512 the last layer is 32 -> 1 at 64³ -> 128³."""

    def __init__(self, n_dims: int = 200, nf: int = 512, res: int = 128):
        super().__init__()
        self.n_dims = n_dims
        self.stages = stages = int(math.log2(res // 4))
        self.Deconv3D_0 = Deconv3D(n_dims, nf, 4, 1, 0)
        self.BatchNorm_0 = batch_norm(nf, 3)
        width = nf
        for i in range(1, stages):
            setattr(self, f"Deconv3D_{i}", Deconv3D(width, width // 2, 4, 2,
                                                    1))
            setattr(self, f"BatchNorm_{i}", batch_norm(width // 2, 3))
            width //= 2
        setattr(self, f"Deconv3D_{stages}", Deconv3D(width, 1, 4, 2, 1))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = z.reshape(z.shape[0], self.n_dims, 1, 1, 1)
        for i in range(self.stages):
            x = getattr(self, f"Deconv3D_{i}")(x)
            x = F.relu(getattr(self, f"BatchNorm_{i}")(x))
        return getattr(self, f"Deconv3D_{self.stages}")(x)[:, 0]


class VoxelGenerator(nn.Module):
    """Noise (N, nz) -> (N, res, res, res) in (0, 1): nz -> 8 nf at 4³,
    then 2x deconvs to nf (at res 128 one more nf -> nf stage), each with
    BatchNorm + ReLU, and a last 2x deconv to one channel (K3), then a
    sigmoid.  No layer has a bias.  At res 128 and nf 64 the last layer
    is 64 -> 1 at 64³ -> 128³."""

    WIDTHS = {128: (4, 2, 1, 1), 64: (4, 2, 1), 32: (2, 1)}

    def __init__(self, nz: int = 200, nf: int = 64, res: int = 128):
        super().__init__()
        self.nz = nz
        widths = [nf * 8] + [nf * m for m in self.WIDTHS[res]]
        self.n_mid = len(widths)
        self.Deconv3D_0 = Deconv3D(nz, widths[0], 4, 1, 0, use_bias=False)
        self.BatchNorm_0 = batch_norm(widths[0], 3)
        for i in range(1, self.n_mid):
            setattr(self, f"Deconv3D_{i}", Deconv3D(
                widths[i - 1], widths[i], 4, 2, 1, use_bias=False))
            setattr(self, f"BatchNorm_{i}", batch_norm(widths[i], 3))
        setattr(self, f"Deconv3D_{self.n_mid}", Deconv3D(
            widths[-1], 1, 4, 2, 1, use_bias=False))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = z.reshape(z.shape[0], self.nz, 1, 1, 1)
        for i in range(self.n_mid):
            x = getattr(self, f"Deconv3D_{i}")(x)
            x = F.relu(getattr(self, f"BatchNorm_{i}")(x))
        return torch.sigmoid(getattr(self, f"Deconv3D_{self.n_mid}")(x)[:, 0])


class CriticHead(Conv3D):
    """The critic's last layer, a k4 VALID convolution from 4³ to one
    score with no bias.  On a channels-last input (K7's output) it is one
    product of the flattened NDHWC input with the weight in the same
    order, with no layout pass; on a channels-first one ``nn.Conv3d``,
    so that the plain critic's scores stay bit for bit as they were."""

    def forward(self, x, slab: bool = False):
        if slab or not x.is_contiguous(memory_format=torch.channels_last_3d):
            return super().forward(x, slab)
        flat = self.Conv_0.weight.permute(0, 2, 3, 4, 1).reshape(-1)
        out = x.permute(0, 2, 3, 4, 1).reshape(x.shape[0], -1) @ flat
        return out.reshape(x.shape[0], 1, 1, 1, 1)


class VoxelDiscriminator(nn.Module):
    """(N, res, res, res) -> (N,) Wasserstein critic scores: k4 s2 p1
    convolutions with LeakyReLU(0.2), no norm and no bias (at res 128 an
    extra nf -> nf stage after the first), then a k4 VALID convolution
    from 4³ to one score.  The first convolution and its activation (one
    input channel) run the hand-written kernel K6 where
    ``critic_stem_kernel.uses_kernel`` says so: a CUDA tensor under bf16
    autocast with the layer's weight taking no gradient, as in inference
    and in ShapeHD's fine-tuning, whose frozen critic passes the
    gradient to its input through K6's backward
    (``ops/cuda/critic_stem_kernel.py``).  Where K6 runs, the middle
    convolutions run K7 where ``critic_conv_kernel.uses_kernel`` says so
    (channels in multiples of 64), channels-last from K6's output to the
    last layer (:class:`CriticHead`) with no layout pass, the frozen
    critic's input gradient through K7's backward
    (``ops/cuda/critic_conv_kernel.py``).  Either way the first layer runs
    as the stage ``shapehd.critic.stem`` and the rest as
    ``shapehd.critic.body``, their backward timed under ``.backward``
    while a profiler records."""

    WIDTHS = {128: (1, 1, 2, 4, 8), 64: (1, 2, 4, 8), 32: (1, 2, 4)}

    def __init__(self, nf: int = 64, res: int = 128):
        super().__init__()
        widths = [nf * m for m in self.WIDTHS[res]]
        self.n_mid = len(widths)
        cin = 1
        for i, w in enumerate(widths):
            setattr(self, f"Conv3D_{i}", Conv3D(cin, w, 4, 2, 1,
                                                use_bias=False))
            cin = w
        setattr(self, f"Conv3D_{self.n_mid}", CriticHead(cin, 1, 4, 1, 0,
                                                         use_bias=False))

    @staticmethod
    def stem(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        """LeakyReLU(0.2) of the first convolution (k4 s2 p1, no bias):
        K6 or the plain layer."""
        if critic_stem_kernel.uses_kernel(x, weight):
            return critic_stem_kernel.critic_stem(x, weight)
        return F.leaky_relu(F.conv3d(x, weight, None, 2, 1), 0.2)

    @staticmethod
    def middle(x: torch.Tensor, weight: torch.Tensor,
               chain: bool) -> torch.Tensor:
        """LeakyReLU(0.2) of a middle convolution (k4 s2 p1, no bias): K7
        on K6's channels-last chain (``chain``) where it takes the layer,
        else the plain layer."""
        if chain and critic_conv_kernel.uses_kernel(x, weight):
            return critic_conv_kernel.critic_conv(x, weight)
        return F.leaky_relu(F.conv3d(x, weight, None, 2, 1), 0.2)

    def body(self, chain: bool, x: torch.Tensor,
             *weights: torch.Tensor) -> torch.Tensor:
        """The middle layers on ``weights``, then the last layer (its
        module, so that its hooks see its input)."""
        for w in weights:
            x = self.middle(x, w, chain)
        return getattr(self, f"Conv3D_{self.n_mid}")(x)

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        w0 = self.Conv3D_0.Conv_0.weight
        # K7 continues K6's chain, with K6's guard: a critic whose weights
        # train, or that scores bf16 voxels (WGAN-GP's G(z)), keeps the
        # plain layers throughout
        chain = critic_stem_kernel.uses_kernel(v[:, None], w0)
        # the weights are stage inputs too, so that the backward span of a
        # critic whose weights train closes once their gradients are out
        x = trace.stage(trace.CRITIC_STEM, self.stem, v[:, None], w0)
        weights = [getattr(self, f"Conv3D_{i}").Conv_0.weight
                   for i in range(1, self.n_mid)]
        return trace.stage(trace.CRITIC_BODY, partial(self.body, chain), x,
                           *weights).reshape(v.shape[0])
