"""GenRe full model, inference (counterpart of
``genre_shapehd_tpu/models/genre_full.py``): stage 2 (depth + spherical
inpainting), then spherical backprojection of the full map and the 3D
U-Net refinement to 128³ voxel logits."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from .. import ops
from ..core.convert import jax_to_torch
from ..nn import UNet3D, init_weights
from .base import ModelBase, net_autocast
from .depth_inpaint import DepthInpaintNet
from .test_base import TestMixin


class GenreNet(nn.Module):
    def __init__(self, im_size: int = 256, vox_res: int = 128,
                 sph_res: int = 128, z_res: int = 256,
                 padding_margin: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vox_res, self.padding_margin, self.dtype = (
            vox_res, padding_margin, dtype)
        self.depth_and_inpaint = DepthInpaintNet(
            im_size, vox_res, sph_res, z_res, padding_margin, dtype)
        self.refine_net = UNet3D(nf=20, res=vox_res)

    def forward(self, rgb: torch.Tensor, silhou: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        out1 = self.depth_and_inpaint(rgb, silhou)
        with record_function("genre.spherical_bp"):
            pred_proj_sph = ops.backproject_spherical_masked(
                out1["pred_sph_full"][..., 0].float(), self.padding_margin,
                self.vox_res)
        with record_function("genre.refine"), \
                net_autocast(rgb.device, self.dtype):
            proj_depth = torch.clamp(out1["proj_depth"] / 50.0, 1e-5,
                                     1.0 - 1e-5)
            refine_in = torch.stack([pred_proj_sph, proj_depth], dim=-1)
            pred_voxel = self.refine_net(refine_in.to(self.dtype))
        out1["pred_proj_depth"] = proj_depth
        out1["pred_voxel"] = pred_voxel
        out1["pred_proj_sph_full"] = pred_proj_sph
        return out1


class Model(ModelBase):
    """GenreNet on ``opt.device`` in ``opt.dtype``, eval mode."""

    def __init__(self, opt):
        super().__init__(opt)
        self.net = GenreNet(
            im_size=opt.im_size, vox_res=opt.vox_res, sph_res=opt.sph_res,
            z_res=opt.z_res, padding_margin=opt.padding_margin,
            dtype=self.dtype).eval()
        init_weights(self.net, torch.Generator().manual_seed(0))
        self.net.to(self.device)

    def load_weights(self, params: Dict, batch_stats: Dict) -> None:
        """Load a JAX-layout parameter tree (``core/convert.py``)."""
        self.net.load_state_dict(jax_to_torch(params, batch_stats))

    def predict_step(self, batch: Dict[str, np.ndarray]
                     ) -> Dict[str, torch.Tensor]:
        rgb = torch.as_tensor(batch["rgb"], dtype=torch.float32,
                              device=self.device)
        silhou = torch.as_tensor(batch["silhou"], dtype=torch.float32,
                                 device=self.device)
        with torch.inference_mode():
            pred = self.net(rgb, silhou)
            # back to the dataset's voxel orientation
            pred["pred_voxel_canonical"] = \
                ops.coords.train_frame_to_gt_voxel(pred["pred_voxel"])
        return pred

    def pack_output(self, pred: Dict[str, np.ndarray], batch: Dict) -> Dict:
        return {"pred_voxel": pred["pred_voxel"],
                "pred_proj_depth": pred["pred_proj_depth"],
                "pred_proj_sph_full": pred["pred_proj_sph_full"],
                "rgb_path": batch.get("rgb_path")}


class ModelTest(TestMixin, Model):
    """Photo -> full GenRe reconstruction."""

    def __init__(self, opt):
        Model.__init__(self, opt)
        self.requires = ["rgb", "mask"]
        self.init_test(opt)
        self.load_net_file(opt.net_file)
