"""3D conv building blocks, NCDHW (counterpart of the parts of
``genre_shapehd_tpu/nn/voxel_nets.py`` that the 3D U-Net uses).

The JAX package's ``SubpixelTConv3D`` and ``DepthPhaseConv3D`` are TPU
layouts of a plain ``ConvTranspose3d`` / ``Conv3d`` with the same
parameters, so here each is the plain layer.  The wrapper names
(``Conv_0``, ``ConvTranspose_0``) mirror the Flax parameter tree.
"""

from __future__ import annotations

from torch import nn


class Conv3D(nn.Module):
    """Conv3d(k, s, p)."""

    def __init__(self, cin: int, features: int, kernel: int = 4,
                 stride: int = 2, torch_padding: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv3d(cin, features, kernel, stride, torch_padding)

    def forward(self, x):
        return self.Conv_0(x)


class Deconv3D(nn.Module):
    """ConvTranspose3d(k, s, p)."""

    def __init__(self, cin: int, features: int, kernel: int = 4,
                 stride: int = 1, torch_padding: int = 0):
        super().__init__()
        self.ConvTranspose_0 = nn.ConvTranspose3d(
            cin, features, kernel, stride, torch_padding)

    def forward(self, x):
        return self.ConvTranspose_0(x)
