"""ResNet-18 feature backbone, NCHW (counterpart of
``genre_shapehd_tpu/nn/resnet.py``).

Submodule names mirror the Flax parameter tree (``Conv_0``,
``BatchNorm_0``, ``BasicBlock_3`` ...), so ``core/convert.py`` maps
checkpoints between the packages by name alone.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


def batch_norm(features: int, dims: int = 2) -> nn.Module:
    """Flax BatchNorm(momentum=0.9, eps=1e-5) == torch momentum 0.1."""
    cls = {1: nn.BatchNorm1d, 2: nn.BatchNorm2d, 3: nn.BatchNorm3d}[dims]
    return cls(features, eps=1e-5, momentum=0.1)


class ConvBN(nn.Module):
    """3x3 conv -> bn -> relu."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, features, 3, stride, 1, bias=False)
        self.BatchNorm_0 = batch_norm(features)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


class BasicBlock(nn.Module):
    """torchvision BasicBlock: 3x3(s) -> 3x3(1) + projection shortcut."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.ConvBN_0 = ConvBN(cin, features, stride)
        self.Conv_0 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.BatchNorm_0 = batch_norm(features)
        self.project = stride != 1 or cin != features
        if self.project:
            self.Conv_1 = nn.Conv2d(cin, features, 1, stride, 0, bias=False)
            self.BatchNorm_1 = batch_norm(features)

    def forward(self, x):
        y = self.BatchNorm_0(self.Conv_0(self.ConvBN_0(x)))
        residual = self.BatchNorm_1(self.Conv_1(x)) if self.project else x
        return F.relu(y + residual)


class ResNet18Features(nn.Module):
    """Stem + 4 stages -> the 5-entry pyramid the U-decoders consume; for
    a (N, C, 256, 256) input: (64@64², 64@64², 128@32², 256@16², 512@8²).
    """
    widths = (64, 128, 256, 512)
    channels = (64,) + widths

    def __init__(self, in_planes: int = 3):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_planes, 64, 7, 2, 3, bias=False)
        self.BatchNorm_0 = batch_norm(64)
        cin, i = 64, 0
        for stage, width in enumerate(self.widths):
            for b in range(2):
                stride = 2 if (stage > 0 and b == 0) else 1
                setattr(self, f"BasicBlock_{i}", BasicBlock(cin, width,
                                                            stride))
                cin, i = width, i + 1

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        x = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        feats = [x]
        for i in range(8):
            x = getattr(self, f"BasicBlock_{i}")(x)
            if i % 2 == 1:
                feats.append(x)
        return tuple(feats)
