"""Plain PyTorch forward passes of the nets the benchmark runs, written
as functions of a flat weight dictionary (the benchmark's own weights,
keyed as the port's ``state_dict`` lays them out) and of nothing else.

In every convolution and dense layer the input, the weight and the
output pass through ``Net.cast``: the identity in float32, a rounding to
a lower precision in the control (``precision.py``).
BatchNorm runs on the running statistics in eval mode and on the batch's
(biased) statistics in train mode, in float32.

Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

W = Dict[str, torch.Tensor]


class Net:
    """The weights, the precision and the mode of one forward pass."""

    def __init__(self, w: W, cast, train: bool = False):
        self.w, self.cast, self.train = w, cast, train

    def sub(self, prefix: str) -> "Net":
        return _Prefixed(self, prefix)

    def get(self, key):
        return self.w.get(key)

    # layers -----------------------------------------------------------
    def _io(self, fn, x, key, **kw):
        c = self.cast
        b = self.get(key + ".bias")
        return c(fn(c(x), c(self.get(key + ".weight")), b, **kw))

    def conv(self, x, key, stride=1, padding=0):
        fn = F.conv2d if x.dim() == 4 else F.conv3d
        return self._io(fn, x, key, stride=stride, padding=padding)

    def deconv(self, x, key, stride=1, padding=0, output_padding=0):
        fn = F.conv_transpose2d if x.dim() == 4 else F.conv_transpose3d
        return self._io(fn, x, key, stride=stride, padding=padding,
                        output_padding=output_padding)

    def dense(self, x, key):
        return self._io(F.linear, x, key)

    def bn(self, x, key):
        x = x.float()
        if self.train:
            return F.batch_norm(x, None, None, self.get(key + ".weight"),
                                self.get(key + ".bias"), True, 0.0, 1e-5)
        return F.batch_norm(x, self.get(key + ".running_mean"),
                            self.get(key + ".running_var"),
                            self.get(key + ".weight"),
                            self.get(key + ".bias"), False, 0.0, 1e-5)


class _Prefixed(Net):
    def __init__(self, parent: Net, prefix: str):
        self.parent, self.prefix = parent, prefix
        self.cast, self.train = parent.cast, parent.train

    def get(self, key):
        return self.parent.get(self.prefix + "." + key)


# ---------------------------------------------------------------- ResNet-18
def basic_block(n: Net, x, stride: int):
    y = F.relu(n.bn(n.conv(x, "ConvBN_0.Conv_0", stride, 1),
                    "ConvBN_0.BatchNorm_0"))
    y = n.bn(n.conv(y, "Conv_0", 1, 1), "BatchNorm_0")
    if n.get("Conv_1.weight") is not None:
        x = n.bn(n.conv(x, "Conv_1", stride, 0), "BatchNorm_1")
    return F.relu(y + x)


def resnet18_features(n: Net, x) -> Tuple[torch.Tensor, ...]:
    """(N, C, H, W) -> the 5 maps (stem after pooling, the 4 stages)."""
    x = F.relu(n.bn(n.conv(x, "Conv_0", 2, 3), "BatchNorm_0"))
    x = F.max_pool2d(x, 3, 2, 1)
    feats = [x]
    for i in range(8):
        stride = 2 if i in (2, 4, 6) else 1
        x = basic_block(n.sub(f"BasicBlock_{i}"), x, stride)
        if i % 2:
            feats.append(x)
    return tuple(feats)


def resnet18_encoder(n: Net, x):
    f = resnet18_features(n.sub("ResNet18Features_0"), x)[-1]
    return n.dense(f.mean(dim=(2, 3)), "Dense_0")


# ---------------------------------------------------------------- U-ResNet
def rev_block(n: Net, x, stride: int):
    op = 1 if stride > 1 else 0
    y = F.relu(n.bn(n.deconv(x, "Deconv_0.ConvTranspose_0", 1, 1),
                    "BatchNorm_0"))
    y = n.bn(n.deconv(y, "Deconv_1.ConvTranspose_0", stride, 1, op),
             "BatchNorm_1")
    if n.get("Deconv_2.ConvTranspose_0.weight") is not None:
        x = n.bn(n.deconv(x, "Deconv_2.ConvTranspose_0", stride, 0, op),
                 "BatchNorm_2")
    return F.relu(y + x)


def ur_decoder(n: Net, feats, inpainting: bool):
    x = feats[-1]
    for i, stride in enumerate((2, 2, 2, 1)):
        layer = n.sub(f"RevLayer_{i}")
        x = rev_block(layer.sub("RevBasicBlock_0"), x, stride)
        x = rev_block(layer.sub("RevBasicBlock_1"), x, 1)
        x = torch.cat([x, feats[-(i + 2)]], dim=1)
    x = F.relu(n.bn(n.deconv(x, "Deconv_0.ConvTranspose_0", 2, 1, 1),
                    "BatchNorm_0"))
    if inpainting:
        return n.deconv(x, "Deconv_1.ConvTranspose_0", 2, 3, 0)
    return n.deconv(x, "Deconv_1.ConvTranspose_0", 2, 3, 1)


def minmax_head(n: Net, x):
    x = n.conv(n.conv(x, "Conv_0", 2, 0), "Conv_1", 1, 0).flatten(1)
    x = F.relu(n.bn(n.dense(x, "Dense_0"), "BatchNorm_0"))
    x = F.relu(n.bn(n.dense(x, "Dense_1"), "BatchNorm_1"))
    return n.dense(x, "Dense_2")


def uresnet(n: Net, im, names, minmax: bool = False,
            inpainting: bool = False) -> Dict[str, torch.Tensor]:
    """Channel-last image in, channel-last maps out (and ``depth_minmax``
    (N, 2) with ``minmax``)."""
    feats = resnet18_features(n.sub("ResNet18Features_0"),
                              im.permute(0, 3, 1, 2))
    out = {k: ur_decoder(n.sub(f"decoder_{k}"), feats, inpainting)
           .permute(0, 2, 3, 1) for k in names}
    if minmax:
        out["depth_minmax"] = minmax_head(n.sub("MinmaxHead_0"), feats[-1])
    return out


# ------------------------------------------------------------------ 3D nets
def unet3d(n: Net, x, res: int = 128):
    """(N, X, Y, Z, 2) -> (N, X, Y, Z) logits."""
    n_mid = int(math.log2(res)) - 3
    h = x.permute(0, 4, 1, 2, 3)
    encs = []
    for i in range(n_mid + 2):
        if i == 0:
            s, p = 2, 3
        elif i <= n_mid:
            s, p = 2, 1
        else:
            s, p = 1, 0
        h = F.leaky_relu(n.bn(n.conv(h, f"Conv3D_{i}.Conv_0", s, p),
                              f"BatchNorm_{i}"), 0.01)
        encs.append(h)
    width = h.shape[1]
    h = F.leaky_relu(n.dense(h.flatten(1), "Dense_0"), 0.01)
    h = h.reshape(h.shape[0], width, 1, 1, 1)
    n_dec = n_mid + 2
    bn = n_mid + 2
    for i in range(n_dec):
        h = torch.cat([h, encs[-(i + 1)]], dim=1)
        if i == 0:
            s, p = 1, 0
        elif i == n_dec - 2:
            s, p = 2, 3
        else:
            s, p = 2, 1
        h = n.deconv(h, f"Deconv3D_{i}.ConvTranspose_0", s, p)
        if i < n_dec - 1:
            h = F.leaky_relu(n.bn(h, f"BatchNorm_{bn}"), 0.01)
            bn += 1
    return h[:, 0]


def voxel_decoder(n: Net, z, res: int = 128):
    stages = int(math.log2(res // 4))
    x = z.reshape(z.shape[0], -1, 1, 1, 1)
    for i in range(stages):
        s, p = (1, 0) if i == 0 else (2, 1)
        x = F.relu(n.bn(n.deconv(x, f"Deconv3D_{i}.ConvTranspose_0", s, p),
                        f"BatchNorm_{i}"))
    return n.deconv(x, f"Deconv3D_{stages}.ConvTranspose_0", 2, 1)[:, 0]


def critic(n: Net, v, res: int = 128, scale: bool = False):
    """(N, R, R, R) -> (N,) scores: k4 s2 p1 convolutions with
    LeakyReLU(0.2), then a k4 VALID one.  With ``scale`` also the sum
    of the last layer's products' magnitudes per score, (N,): the size
    of a score before its terms cancel."""
    layers = {128: 5, 64: 4, 32: 3}[res]
    x = v[:, None]
    for i in range(layers):
        x = F.leaky_relu(n.conv(x, f"Conv3D_{i}.Conv_0", 2, 1), 0.2)
    key = f"Conv3D_{layers}.Conv_0"
    out = n.conv(x, key, 1, 0).reshape(v.shape[0]).float()
    if not scale:
        return out
    mag = F.conv3d(x.abs().float(), n.get(key + ".weight").abs())
    return out, mag.reshape(v.shape[0])


def marrnet2(n: Net, depth, normal, silhou, thres: float, res: int = 128):
    """2.5D sketches (channel-last) -> (N, R, R, R) logits; depth and
    normal zeroed where ``silhou <= thres``."""
    fg = (silhou > thres).to(depth.dtype)
    x = torch.cat([depth * fg, normal * fg], dim=-1).permute(0, 3, 1, 2)
    z = resnet18_encoder(n.sub("ResNet18Encoder_0"), x)
    return voxel_decoder(n.sub("VoxelDecoder_0"), z, res)
