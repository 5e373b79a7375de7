"""Seeded weight init matching the JAX package's (``nn/init.py``):
conv/linear weights ~ N(0, sqrt(2 / fan_in)), biases 0, BatchNorm scale
~ N(1, 0.02), BatchNorm bias 0.  ``fan_in`` counts as the Flax kernel
does: input channels times the receptive field, for transposed
convolutions too."""

from __future__ import annotations

import math

import torch
from torch import nn

_BN = (nn.BatchNorm1d, nn.BatchNorm2d, nn.BatchNorm3d)
_CONVT = (nn.ConvTranspose2d, nn.ConvTranspose3d)
_CONV = (nn.Conv2d, nn.Conv3d)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    for m in module.modules():
        if isinstance(m, _BN):
            m.weight.copy_(1.0 + 0.02 * torch.randn(
                m.weight.shape, generator=generator))
            m.bias.zero_()
            continue
        if isinstance(m, _CONVT):
            fan_in = m.weight.shape[0] * math.prod(m.weight.shape[2:])
        elif isinstance(m, _CONV):
            fan_in = m.weight.shape[1] * math.prod(m.weight.shape[2:])
        elif isinstance(m, nn.Linear):
            fan_in = m.weight.shape[1]
        else:
            continue
        m.weight.copy_(math.sqrt(2.0 / fan_in) * torch.randn(
            m.weight.shape, generator=generator))
        if m.bias is not None:
            m.bias.zero_()
