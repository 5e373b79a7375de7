"""3D conv building blocks, NCDHW (counterpart of the parts of
``genre_shapehd_tpu/nn/voxel_nets.py`` that the 3D U-Net uses).

The JAX package's ``SubpixelTConv3D`` and ``DepthPhaseConv3D`` are TPU
layouts of a plain ``ConvTranspose3d`` / ``Conv3d`` with the same
parameters, so here each is the plain layer -- except the one-channel
``k4 s2 p1`` deconv (dec6 of the 3D U-Net), which runs the hand-written
kernel K3 on CUDA tensors (``ops/cuda/subpixel_kernel.py``).  The wrapper
names (``Conv_0``, ``ConvTranspose_0``) mirror the Flax parameter tree.
"""

from __future__ import annotations

from torch import nn

from ..ops.cuda.subpixel_kernel import deconv_final


class Conv3D(nn.Module):
    """Conv3d(k, s, p)."""

    def __init__(self, cin: int, features: int, kernel: int = 4,
                 stride: int = 2, torch_padding: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv3d(cin, features, kernel, stride, torch_padding)

    def forward(self, x):
        return self.Conv_0(x)


class Deconv3D(nn.Module):
    """ConvTranspose3d(k, s, p).  With one output channel and k4 s2 p1 the
    layer's weight and bias go through :func:`deconv_final`: K3 on a CUDA
    tensor, ``F.conv_transpose3d`` on a CPU tensor."""

    def __init__(self, cin: int, features: int, kernel: int = 4,
                 stride: int = 1, torch_padding: int = 0):
        super().__init__()
        self.ConvTranspose_0 = nn.ConvTranspose3d(
            cin, features, kernel, stride, torch_padding)
        self.final = (features, kernel, stride, torch_padding) == (1, 4, 2, 1)

    def forward(self, x):
        if self.final:
            return deconv_final(x, self.ConvTranspose_0.weight,
                                self.ConvTranspose_0.bias)
        return self.ConvTranspose_0(x)
