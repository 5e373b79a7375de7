"""U-ResNet: ResNet-18 encoder + reverse-ResNet-18 decoders with skips
(counterpart of ``genre_shapehd_tpu/nn/uresnet.py``).

Public layout is the JAX package's: images in (N, H, W, C), each named
output (N, H, W, C_out), ``depth_minmax`` (N, 2).  Inside, NCHW.

``decoder_width`` scales the decoder stages' channels (1.0: the reference
revuresnet18 widths); ``head_dtype=torch.float32`` runs the decoders and
the min/max head in float32 over an encoder in the autocast dtype
(``--f32_heads``).  At 1.0 and None the parameter tree is the default
one.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import ResNet18Features, batch_norm
from .revresnet import Deconv, RevLayer


class URDecoder(nn.Module):
    """One revuresnet18 decoder head over the encoder pyramid, its
    stages' channels scaled by ``width``."""
    planes = (256, 128, 64, 64)
    strides = (2, 2, 2, 1)

    def __init__(self, feat_channels: Sequence[int], out_planes: int,
                 final_kernel: int = 7, final_torch_padding: int = 3,
                 final_output_padding: int = 1, width: float = 1.0):
        super().__init__()
        cin = feat_channels[-1]
        for i, (planes, s) in enumerate(zip(self.planes, self.strides)):
            planes = int(round(planes * width))
            setattr(self, f"RevLayer_{i}", RevLayer(cin, planes, s))
            cin = planes + feat_channels[-(i + 2)]
        last = int(round(64 * width))
        self.Deconv_0 = Deconv(cin, last, 3, 2, 1, 1, use_bias=True)
        self.BatchNorm_0 = batch_norm(last)
        self.Deconv_1 = Deconv(last, out_planes, final_kernel, 2,
                               final_torch_padding, final_output_padding)

    def forward(self, feats: Tuple[torch.Tensor, ...]):
        x = feats[-1]
        for i in range(len(self.planes)):
            x = getattr(self, f"RevLayer_{i}")(x)
            skip = feats[-(i + 2)]
            assert skip.shape[2:] == x.shape[2:], (skip.shape, x.shape)
            x = torch.cat([x, skip], dim=1)
        x = F.relu(self.BatchNorm_0(self.Deconv_0(x)))
        return self.Deconv_1(x)


class MinmaxHead(nn.Module):
    """Scalar depth min/max off the encoder bottleneck: Conv(2, s2) ->
    Conv(k) collapsing the remaining k x k extent -> 512-256-128-2 MLP
    with BatchNorm1d + ReLU between layers.  ``bottleneck`` is the
    encoder's output side (im_size / 32)."""

    def __init__(self, bottleneck: int):
        super().__init__()
        k = bottleneck // 2
        self.Conv_0 = nn.Conv2d(512, 512, 2, 2, 0, bias=True)
        self.Conv_1 = nn.Conv2d(512, 512, k, 1, 0, bias=True)
        self.Dense_0 = nn.Linear(512, 256)
        self.BatchNorm_0 = batch_norm(256, dims=1)
        self.Dense_1 = nn.Linear(256, 128)
        self.BatchNorm_1 = batch_norm(128, dims=1)
        self.Dense_2 = nn.Linear(128, 2)

    def forward(self, x):
        x = self.Conv_1(self.Conv_0(x))
        assert x.shape[2:] == (1, 1), x.shape
        x = x.flatten(1)
        x = F.relu(self.BatchNorm_0(self.Dense_0(x)))
        x = F.relu(self.BatchNorm_1(self.Dense_1(x)))
        return self.Dense_2(x)


class UResNet(nn.Module):
    """Image (N, H, W, in_planes) -> named maps (N, H', W', planes).

    ``inpainting`` selects the k8 s2 p3 final deconv of the spherical
    inpainting net; ``pred_depth_minmax`` adds the min/max head, which
    needs ``im_size``."""

    def __init__(self, in_planes: int = 3,
                 out_planes: Sequence[int] = (3, 1, 1),
                 layer_names: Sequence[str] = ("normal", "depth", "silhou"),
                 pred_depth_minmax: bool = False, inpainting: bool = False,
                 im_size: int = 256, decoder_width: float = 1.0,
                 head_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.layer_names = tuple(layer_names)
        self.head_dtype = head_dtype
        self.ResNet18Features_0 = ResNet18Features(in_planes)
        chans = ResNet18Features.channels
        for planes, name in zip(out_planes, layer_names):
            if inpainting:
                head = URDecoder(chans, planes, 8, 3, 0, width=decoder_width)
            else:
                head = URDecoder(chans, planes, width=decoder_width)
            setattr(self, f"decoder_{name}", head)
        self.pred_depth_minmax = pred_depth_minmax
        if pred_depth_minmax:
            self.MinmaxHead_0 = MinmaxHead(im_size // 32)

    def forward(self, im: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = self.ResNet18Features_0(im.permute(0, 3, 1, 2))
        heads = nullcontext()
        if self.head_dtype == torch.float32:
            feats = tuple(f.float() for f in feats)
            heads = torch.autocast(im.device.type, enabled=False)
        elif self.head_dtype is not None:
            feats = tuple(f.to(self.head_dtype) for f in feats)
            heads = torch.autocast(im.device.type, dtype=self.head_dtype)
        with heads:
            out = {name: getattr(self, f"decoder_{name}")(feats).permute(
                0, 2, 3, 1) for name in self.layer_names}
            if self.pred_depth_minmax:
                out["depth_minmax"] = self.MinmaxHead_0(feats[-1])
        return out
