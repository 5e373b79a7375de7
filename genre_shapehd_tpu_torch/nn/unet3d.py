"""3D U-Net voxel refinement (counterpart of
``genre_shapehd_tpu/nn/unet3d.py``): a 6-level encoder/decoder at 128³
(128 -> 64 -> 32 -> 16 -> 8 -> 4 -> 1), skip concatenation, a linear
bottleneck, BatchNorm + LeakyReLU(0.01) conv blocks.

Input (N, X, Y, Z, 2), output (N, X, Y, Z) logits; NCDHW inside.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import batch_norm
from .voxel_nets import Conv3D, Deconv3D


class UNet3D(nn.Module):
    def __init__(self, nf: int = 20, res: int = 128):
        super().__init__()
        self.n_mid = n_mid = int(math.log2(res)) - 3   # 128 -> 4 levels
        bn = 0
        # encoder: k8 s2 p3, n_mid x k4 s2 p1, then k4 s1 VALID to 1³
        enc = [(2, nf, 8, 2, 3)]          # (projected sph df, proj depth)
        width = nf
        for _ in range(n_mid):
            enc.append((width, 2 * width, 4, 2, 1))
            width *= 2
        enc.append((width, 2 * width, 4, 1, 0))
        width *= 2
        enc_widths = [e[1] for e in enc]
        for i, (cin, cout, k, s, p) in enumerate(enc):
            setattr(self, f"Conv3D_{i}", Conv3D(cin, cout, k, s, p))
            setattr(self, f"BatchNorm_{bn}", batch_norm(cout, 3))
            bn += 1
        self.n_enc = len(enc)
        self.Dense_0 = nn.Linear(width, width)
        self.width = width
        # decoder: k4 s1 VALID-transpose to 4³, k4 s2 p1 levels with
        # skips, k8 s2 p3, then k4 s2 p1 to one channel (no bn/act)
        dec = [(2 * width, width // 2, 4, 1, 0)]
        width //= 2
        for i in range(n_mid - 1):
            cin = width + enc_widths[-(i + 2)]
            dec.append((cin, width // 2, 4, 2, 1))
            width //= 2
        dec.append((width + enc_widths[1], nf, 8, 2, 3))
        dec.append((nf + enc_widths[0], 1, 4, 2, 1))
        for i, (cin, cout, k, s, p) in enumerate(dec):
            setattr(self, f"Deconv3D_{i}", Deconv3D(cin, cout, k, s, p))
            if i < len(dec) - 1:
                setattr(self, f"BatchNorm_{bn}", batch_norm(cout, 3))
                bn += 1
        self.n_dec = len(dec)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 4, 1, 2, 3)
        encs = []
        for i in range(self.n_enc):
            h = getattr(self, f"Conv3D_{i}")(h)
            h = F.leaky_relu(getattr(self, f"BatchNorm_{i}")(h), 0.01)
            encs.append(h)
        assert h.shape[2:] == (1, 1, 1), h.shape
        flat = F.leaky_relu(self.Dense_0(h.flatten(1)), 0.01)
        h = flat.reshape(h.shape[0], self.width, 1, 1, 1)
        bn = self.n_enc
        for i in range(self.n_dec):
            h = torch.cat([h, encs[-(i + 1)]], dim=1)
            h = getattr(self, f"Deconv3D_{i}")(h)
            if i < self.n_dec - 1:
                h = F.leaky_relu(getattr(self, f"BatchNorm_{bn}")(h), 0.01)
                bn += 1
        return h[:, 0]
