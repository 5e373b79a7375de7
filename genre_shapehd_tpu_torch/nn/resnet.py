"""ResNet-18 feature backbone and encoder, NCHW (counterpart of
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

from ..parallel import mesh


class _FlaxStats:
    """Train mode as Flax's ``BatchNorm(momentum=0.9, epsilon=1e-5)``:
    normalise with the batch's biased variance, as torch does, but also
    move the running variance toward the biased one, where torch takes
    the unbiased (n/(n-1) larger: 4/3 for a batch of 4 in a
    BatchNorm1d).  The statistics are taken in float32, as Flax takes
    them for a bfloat16 module.  Eval mode is torch's own.

    In a group of more than one rank (``parallel/mesh.py``) the mean and
    the variance are the global batch's, with the gradient flowing
    through both, as Flax takes them inside a step jitted over a mesh:
    summed by ``mesh.all_reduce_batch``, where the sp ranks hold copies
    of the rows; or, with ``sharded`` (a layer of the 3D U-Net that runs
    on Z slabs), summed over the world, whose ranks hold every slab of
    every row once."""

    def forward(self, x, sharded: bool = False):
        if not self.training:
            return super().forward(x)
        if mesh.world() > 1:
            return self._global_forward(x, sharded)
        dims = (0,) + tuple(range(2, x.dim()))
        with torch.no_grad():
            xs = x.to(torch.promote_types(x.dtype, torch.float32))
            var, mean = torch.var_mean(xs, dim=dims, correction=0)
            self.running_mean.lerp_(mean.to(self.running_mean.dtype),
                                    self.momentum)
            self.running_var.lerp_(var.to(self.running_var.dtype),
                                   self.momentum)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True,
                             0.0, self.eps)

    def _global_forward(self, x, sharded):
        """Train mode over the ranks' global batch: the mean first, then
        the mean squared deviation from it (two passes, two all-reduces),
        in float32; the running statistics move toward the global values,
        so they stay equal on every rank."""
        reduce = (lambda t: mesh.all_reduce_sum(t, mesh.WORLD)) \
            if sharded else mesh.all_reduce_batch
        dims = (0,) + tuple(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xs = x.to(torch.promote_types(x.dtype, torch.float32))
        n_local = torch.tensor([x.numel() // x.shape[1]], dtype=xs.dtype,
                               device=x.device)
        sums = reduce(torch.cat([xs.sum(dims), n_local]))
        n = sums[-1].detach()
        mean = sums[:-1] / n
        centred = xs - mean.reshape(shape)
        var = reduce((centred * centred).sum(dims)) / n
        with torch.no_grad():
            self.running_mean.lerp_(mean.to(self.running_mean.dtype),
                                    self.momentum)
            self.running_var.lerp_(var.to(self.running_var.dtype),
                                   self.momentum)
            self.num_batches_tracked.add_(1)
        y = centred * torch.rsqrt(var + self.eps).reshape(shape)
        if self.affine:
            y = y * self.weight.reshape(shape) + self.bias.reshape(shape)
        return y.to(x.dtype)


class BatchNorm1d(_FlaxStats, nn.BatchNorm1d):
    pass


class BatchNorm2d(_FlaxStats, nn.BatchNorm2d):
    pass


class BatchNorm3d(_FlaxStats, nn.BatchNorm3d):
    pass


def batch_norm(features: int, dims: int = 2) -> nn.Module:
    """Flax BatchNorm(momentum=0.9, eps=1e-5) == torch momentum 0.1."""
    cls = {1: BatchNorm1d, 2: BatchNorm2d, 3: BatchNorm3d}[dims]
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


class ResNet18Encoder(nn.Module):
    """``ResNet18Features``, the mean over H and W of its last map, then
    ``Dense(encode_dims)``: (N, in_planes, H, W) -> (N, encode_dims)."""

    def __init__(self, in_planes: int = 3, encode_dims: int = 200):
        super().__init__()
        self.ResNet18Features_0 = ResNet18Features(in_planes)
        self.Dense_0 = nn.Linear(ResNet18Features.widths[-1], encode_dims)

    def forward(self, x):
        return self.Dense_0(self.ResNet18Features_0(x)[-1].mean(dim=(2, 3)))
