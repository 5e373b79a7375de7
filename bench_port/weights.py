"""The benchmark's weights: made on the device from the seed in one
large draw, laid out as the port's nets hold them, then calibrated (a
copy of ``chip_smoke.py::calibrate``, run on the plain reference) so
that GenRe's geometry sees the unit cube.

The draw follows the port's own initialisation rule
(``nn/init.py``): convolution and dense weights ~ N(0, 2 / fan_in), fan_in
counting input channels times the receptive field (for transposed
convolutions too), biases 0, BatchNorm scales ~ N(1, 0.02), shifts 0,
running means 0 and variances 1.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

_CONVT = (nn.ConvTranspose2d, nn.ConvTranspose3d)
_CONV = (nn.Conv2d, nn.Conv3d)
_BN = (nn.BatchNorm1d, nn.BatchNorm2d, nn.BatchNorm3d)
#: streams drawn from one ``--seed``
STREAMS = {"weights": 1, "inputs": 2, "draws": 3, "sample": 4}


def stream(seed: int, name: str) -> int:
    """A seed of its own for each use of ``--seed`` (any whole number
    below 2**63 - 2**40)."""
    return (int(seed) + (STREAMS[name] << 40)) % (1 << 63)


def generator(seed: int, name: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream(seed, name))


def seeded(net: nn.Module, seed: int, device, offset: int = 0
           ) -> Dict[str, torch.Tensor]:
    """Every entry of ``net``'s ``state_dict`` (float32, on ``device``),
    drawn from ``seed``.  ``offset`` picks another stream for a second
    net of one model."""
    scales = {}
    for mod_name, m in net.named_modules():
        pre = mod_name + "." if mod_name else ""
        if isinstance(m, _BN):
            scales[pre + "weight"] = ("bn", None)
        elif isinstance(m, (_CONV + _CONVT + (nn.Linear,))):
            w = m.weight
            if isinstance(m, _CONVT):
                fan_in = w.shape[0] * math.prod(w.shape[2:])
            elif isinstance(m, _CONV):
                fan_in = w.shape[1] * math.prod(w.shape[2:])
            else:
                fan_in = w.shape[1]
            scales[pre + "weight"] = ("normal", math.sqrt(2.0 / fan_in))
    state = net.state_dict()
    drawn = [k for k in state if k in scales]
    total = sum(state[k].numel() for k in drawn)
    g = torch.Generator(device=device).manual_seed(
        stream(seed, "weights") + offset)
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for key, val in state.items():
        if key in scales:
            kind, std = scales[key]
            x = flat[at:at + val.numel()].view(val.shape)
            at += val.numel()
            out[key] = 1.0 + 0.02 * x if kind == "bn" else x * std
        elif key.endswith("running_var"):
            out[key] = torch.ones(val.shape, device=device)
        elif key.endswith("num_batches_tracked"):
            out[key] = torch.zeros((), dtype=torch.long, device=device)
        else:
            out[key] = torch.zeros(val.shape, device=device)
    return out


@torch.no_grad()
def calibrate_genre(w: Dict[str, torch.Tensor], rgb, silhou, sizes) -> None:
    """Random weights throw net1's depth and net2's spherical map far
    outside the unit cube, leaving both backprojections empty: fix the
    min/max head to (1.2, 2.2) and scale the depth / spherical output
    layers to std 30 / 1 so the geometry sees the cube (in place)."""
    from reference import models, precision
    net1, net2 = models.NET1, models.NET2
    w[f"{net1}.MinmaxHead_0.Dense_2.weight"].zero_()
    w[f"{net1}.MinmaxHead_0.Dense_2.bias"].copy_(
        torch.tensor([1.2, 2.2], device=rgb.device))
    for key, out_key, target in (
            (f"{net1}.decoder_depth.Deconv_1.ConvTranspose_0.weight",
             "depth", 30.0),
            (f"{net2}.decoder_spherical.Deconv_1.ConvTranspose_0.weight",
             "pred_sph_full", 1.0)):
        out = models.genre(w, rgb, silhou, precision.exact, **sizes)
        w[key].mul_(target / float(out[out_key].std()))


@torch.no_grad()
def calibrate_marrnet1(w: Dict[str, torch.Tensor], rgb) -> None:
    """MarrNet-1's silhouette head to std 50, so that MarrNet-2's mask at
    30 keeps part of each map and drops the rest (in place)."""
    from reference import nets, precision
    key = "decoder_silhou.Deconv_1.ConvTranspose_0.weight"
    out = nets.uresnet(nets.Net(w, precision.exact), rgb,
                       ("silhou",))["silhou"]
    w[key].mul_(50.0 / float(out.float().std()))
