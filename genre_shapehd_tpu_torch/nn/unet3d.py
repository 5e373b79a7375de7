"""3D U-Net voxel refinement (counterpart of
``genre_shapehd_tpu/nn/unet3d.py``): a 6-level encoder/decoder at 128³
(128 -> 64 -> 32 -> 16 -> 8 -> 4 -> 1), skip concatenation, a linear
bottleneck, BatchNorm + LeakyReLU(0.01) conv blocks.

Input (N, X, Y, Z, 2), output (N, X, Y, Z) logits; NCDHW inside.  The
encoder (the stem down to the 1³ bottleneck and its Dense) and the
decoder (the transposed convolutions to the logits, dec6 on K3) run as
the stages ``genre.refine.encoder`` and ``genre.refine.decoder`` of
``utils/trace.py``.

**Sharded forward** (``sharded=True``; ``cli.train --sp``, where the
JAX package shards the input's Z axis over the mesh's ``sp`` axis and
GSPMD partitions the convolutions).  The input is this rank's Z slab of
the sp group (``parallel/mesh.py``); each rank runs every layer from the
stem down to the 4³ level, and back up from there, on its slab, each
convolution on the slab widened by the halo planes its kernel reaches
from the neighbours (``Conv3D`` / ``Deconv3D`` with ``slab``: 3 planes
a side for the k8 s2 p3 stem, 2 for the k8 s2 p3 deconv, 1 for the k4
s2 p1 levels and dec6, which runs on K3 with its halo).  Their
BatchNorm takes its statistics over the slabs of every rank.

The **gather point** is the 4³ level: the k4 VALID convolution to 1³,
the Dense bottleneck and the k4 VALID deconvolution back to 4³ read the
whole 4³ extent (a kernel that spans it), where every shallower layer
reads at most a plane of its neighbours'.  So the 4³ encoder output is
gathered along Z, those three layers run redundantly on every sp rank
(their BatchNorm over the global batch's copies, as the 2D nets'), and
the 4³ decoder output is cut back to this rank's slab.  Gathering any
higher would run 8³ and larger layers redundantly; the 4³ level is the
deepest one that a slab of at least one plane can split: sp divides 4.
The gather's backward sums the sp ranks' shares of the gradient, the
cut's takes this rank's own share, so that every U-Net parameter's
gradient on a rank is its slab's share (summed over sp before the
update: ``models/base.py::slab_params``).

The logits are gathered along Z at the end; the backward takes this
rank's slab of their gradient, where each rank computes the loss on the
whole volume.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh
from ..utils import trace
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

    def forward(self, x: torch.Tensor, sharded: bool = False
                ) -> torch.Tensor:
        """x (N, X, Y, Z, 2), or with ``sharded`` this rank's Z slab of
        it; the (N, X, Y, Z) logits, all of Z."""
        if sharded and 4 % mesh.size(mesh.SP):
            raise ValueError(f"--sp {mesh.size(mesh.SP)}: the sharded 3D "
                             "U-Net splits its 4³ level, so sp divides 4")
        h = x.permute(0, 4, 1, 2, 3)
        h, *encs = trace.stage(trace.REFINE_ENCODER, self._encode, h,
                               sharded)
        return trace.stage(trace.REFINE_DECODER, self._decode, h, encs,
                           sharded)

    def _encode(self, h: torch.Tensor, sharded: bool
                ) -> Tuple[torch.Tensor, ...]:
        """The stem down to the 1³ bottleneck: the bottleneck's output
        (N, C, 1, 1, 1) and every encoder level's, shallowest first."""
        encs = []
        for i in range(self.n_enc):
            slab = sharded and i < self.n_enc - 1
            if sharded and not slab:            # the gather point
                h = mesh.gather_z(h, 4, grad="sum")
            h = getattr(self, f"Conv3D_{i}")(h, slab=slab)
            h = F.leaky_relu(getattr(self, f"BatchNorm_{i}")(
                h, sharded=slab), 0.01)
            encs.append(h)
        assert h.shape[2:] == (1, 1, 1), h.shape
        flat = F.leaky_relu(self.Dense_0(h.flatten(1)), 0.01)
        return (flat.reshape(h.shape[0], self.width, 1, 1, 1), *encs)

    def _decode(self, h: torch.Tensor, encs: List[torch.Tensor],
                sharded: bool) -> torch.Tensor:
        """The transposed convolutions from the bottleneck to the logits,
        with the encoder's levels as skips (dec6 on K3)."""
        bn = self.n_enc
        for i in range(self.n_dec):
            slab = sharded and i > 0
            h = torch.cat([h, encs[-(i + 1)]], dim=1)
            h = getattr(self, f"Deconv3D_{i}")(h, slab=slab)
            if i < self.n_dec - 1:
                h = F.leaky_relu(getattr(self, f"BatchNorm_{bn}")(
                    h, sharded=slab), 0.01)
                bn += 1
            if sharded and i == 0:              # back to the slabs
                h = mesh.z_slab(h, 4, grad="local")
        if sharded:
            return mesh.gather_z(h[:, 0], 3, grad="slab")
        return h[:, 0]
