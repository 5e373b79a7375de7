"""Reverse (transposed-conv) ResNet-18 decoder blocks, NCHW (counterpart
of ``genre_shapehd_tpu/nn/revresnet.py``).

The Flax ``Deconv`` runs ``lax.conv_transpose`` with padding
(k-1-p, k-1-p+op) and unflipped taps; ``nn.ConvTranspose2d(k, s, p,
output_padding=op)`` computes the same map with the taps flipped, which
``core/convert.py`` does when it carries weights across.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .resnet import batch_norm


class Deconv(nn.Module):
    def __init__(self, cin: int, features: int, kernel: int, stride: int = 1,
                 torch_padding: int = 0, output_padding: int = 0,
                 use_bias: bool = False):
        super().__init__()
        self.ConvTranspose_0 = nn.ConvTranspose2d(
            cin, features, kernel, stride, torch_padding, output_padding,
            bias=use_bias)

    def forward(self, x):
        return self.ConvTranspose_0(x)


class RevBasicBlock(nn.Module):
    """deconv3x3(s1) -> bn -> relu -> deconv3x3(stride) -> bn, plus a
    1x1 deconv + bn shortcut when the stride or the width changes."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        op = 1 if stride > 1 else 0
        self.Deconv_0 = Deconv(cin, features, 3, 1, 1)
        self.BatchNorm_0 = batch_norm(features)
        self.Deconv_1 = Deconv(features, features, 3, stride, 1, op)
        self.BatchNorm_1 = batch_norm(features)
        self.project = stride != 1 or cin != features
        if self.project:
            self.Deconv_2 = Deconv(cin, features, 1, stride, 0, op)
            self.BatchNorm_2 = batch_norm(features)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Deconv_0(x)))
        y = self.BatchNorm_1(self.Deconv_1(y))
        residual = (self.BatchNorm_2(self.Deconv_2(x)) if self.project
                    else x)
        return F.relu(y + residual)


class RevLayer(nn.Module):
    """A stage of two RevBasicBlocks, the first one strided."""
    blocks = 2

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        for i in range(self.blocks):
            setattr(self, f"RevBasicBlock_{i}", RevBasicBlock(
                cin if i == 0 else features, features,
                stride if i == 0 else 1))

    def forward(self, x):
        for i in range(self.blocks):
            x = getattr(self, f"RevBasicBlock_{i}")(x)
        return x
