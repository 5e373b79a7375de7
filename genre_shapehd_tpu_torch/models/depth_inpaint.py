"""GenRe stage 2 forward: depth prediction + spherical-map inpainting
(counterpart of ``genre_shapehd_tpu/models/depth_inpaint.py``).

  rgb --net1 (U-ResNet + minmax)--> 2.5D + minmax
      --abs depth, silhouette-masked, camera frame--> camera backprojection
      --spherical render (CUDA kernels K1, K2)--> partial spherical map
      --wrap/replicate pad--> net2 (inpainting U-ResNet) --> full map

The nets run in the compute dtype; the geometry between them in float32.
Each stage runs under a ``torch.profiler.record_function`` span named
``genre.<stage>`` (no cost unless a profiler is recording), which
``chip_smoke.py`` reads for its per-stage device times.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn
from torch.profiler import record_function

from .. import ops
from ..nn import UResNet
from .base import net_autocast, to_abs_depth


class DepthInpaintNet(nn.Module):
    def __init__(self, im_size: int = 256, vox_res: int = 128,
                 sph_res: int = 128, z_res: int = 256,
                 padding_margin: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vox_res, self.sph_res, self.z_res = vox_res, sph_res, z_res
        self.padding_margin = padding_margin
        self.dtype = dtype
        self.net1 = UResNet(3, (3, 1, 1), ("normal", "depth", "silhou"),
                            pred_depth_minmax=True, im_size=im_size)
        self.net2 = UResNet(1, (1,), ("spherical",), inpainting=True)

    @staticmethod
    def get_abs_depth(out1: Dict[str, torch.Tensor],
                      silhou_in: torch.Tensor) -> torch.Tensor:
        pred_depth = out1["depth"].float() / 100.0
        minmax = out1["depth_minmax"].float()
        abs_depth = to_abs_depth(1.0 - pred_depth, minmax)
        silhou = silhou_in / 100.0
        abs_depth = torch.where(silhou < 0.5, 0.0, abs_depth)
        return ops.coords.depth_image_to_cambp_frame(abs_depth[..., 0])

    def forward(self, rgb: torch.Tensor, silhou: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        """rgb (N, H, W, 3), silhou (N, H, W, 1) in [0, 100]."""
        with record_function("genre.net1"), \
                net_autocast(rgb.device, self.dtype):
            out1 = self.net1(rgb)
        with record_function("genre.camera_bp"):
            abs_depth = self.get_abs_depth(out1, silhou)
            proj = ops.camera_backproject_shifted(
                abs_depth, ops.FL_GENRE, ops.CAM_DIST, self.vox_res)
        with record_function("genre.render"):
            clipped = torch.clamp(proj * 50.0, 1e-5, 1.0 - 1e-5)
            sph_in = ops.render_spherical_fast(
                clipped, self.sph_res, self.z_res, compute_dtype=self.dtype)
        with record_function("genre.net2"), \
                net_autocast(rgb.device, self.dtype):
            sph_in = ops.sph_pad(sph_in[..., None], self.padding_margin)
            out2 = self.net2(sph_in.to(self.dtype))
        out1["proj_depth"] = proj * 50.0
        out1["pred_sph_partial"] = sph_in
        out1["pred_sph_full"] = out2["spherical"]
        return out1
