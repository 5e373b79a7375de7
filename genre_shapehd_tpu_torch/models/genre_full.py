"""GenRe full model (counterpart of
``genre_shapehd_tpu/models/genre_full.py``): stage 2 (depth + spherical
inpainting), then spherical backprojection of the full map and the 3D
U-Net refinement to 128³ voxel logits.

Loss: BCE-with-logits on the ground-truth voxels plus ``surface_weight``
times BCE(sigmoid(pred) * shell, shell) on their surface shell (two
erosions, ``ops/voxel.py``), plus ``joint_w25d`` times the 2.5D and
spherical losses under ``joint_train``.  Without ``joint_train`` stage 2
runs without a gradient (net2 in train mode, net1 in eval mode) and only
the refine net learns.

Under ``cli.train --sp`` (``parallel/mesh.py``) the sp ranks of a dp
index run everything before the 3D U-Net on the same rows, then each
runs the U-Net on its Z slab of the refine net's input and gathers the
logits (``nn/unet3d.py``); the slab cut's backward assembles the input
gradient, so that the redundant 2D nets of every sp rank receive the
whole voxel loss's gradient.  Only the refine net shards, as in the JAX
package.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import ops
from ..nn import UNet3D, init_weights
from ..parallel import mesh
from ..utils import trace
from .base import ModelBase, as_numpy, bce_with_logits, net_autocast
from .depth_inpaint import DepthInpaintNet, Model as DepthInpaintModel
from .test_base import TestMixin


class GenreNet(nn.Module):
    """Stage 2 (``DepthInpaintNet``, its flags as keywords) and the
    refinement.  ``gt_sph_full``: the refine net backprojects the
    ground-truth full spherical map instead of net2's (an oracle of the
    quality benchmark)."""

    def __init__(self, im_size: int = 256, vox_res: int = 128,
                 sph_res: int = 128, z_res: int = 256,
                 padding_margin: int = 16, joint_train: bool = False,
                 refine_nf: int = 20, dtype: torch.dtype = torch.float32,
                 gt_sph_full: bool = False, **depth_inpaint_flags):
        super().__init__()
        self.vox_res, self.padding_margin, self.dtype = (
            vox_res, padding_margin, dtype)
        self.joint_train = joint_train
        self.gt_sph_full = gt_sph_full
        self.depth_and_inpaint = DepthInpaintNet(
            im_size, vox_res, sph_res, z_res, padding_margin, joint_train,
            dtype, **depth_inpaint_flags)
        self.refine_net = UNet3D(nf=refine_nf, res=vox_res)

    def forward(self, rgb: torch.Tensor, silhou: torch.Tensor,
                spherical_depth: Optional[torch.Tensor] = None,
                gt_depth: Optional[torch.Tensor] = None,
                gt_minmax: Optional[torch.Tensor] = None,
                gt_sph: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and self.joint_train):
            out1 = self.depth_and_inpaint(rgb, silhou, spherical_depth,
                                          gt_depth, gt_minmax)
        if self.gt_sph_full and gt_sph is not None:
            # padded by the model's preprocess, as net2's output is
            out1["pred_sph_full"] = gt_sph.detach()
        pred_proj_sph = trace.stage(trace.SPHERICAL_BP, self._spherical_bp,
                                    out1["pred_sph_full"])
        proj_depth, pred_voxel = trace.stage(
            trace.REFINE, self._refine, pred_proj_sph, out1["proj_depth"])
        out1["pred_proj_depth"] = proj_depth
        out1["pred_voxel"] = pred_voxel
        out1["pred_proj_sph_full"] = pred_proj_sph
        return out1

    def _spherical_bp(self, sph_full: torch.Tensor) -> torch.Tensor:
        return ops.backproject_spherical_masked(
            sph_full[..., 0].float(), self.padding_margin, self.vox_res)

    def _refine(self, pred_proj_sph: torch.Tensor, proj_depth: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The clipped projected depth and the voxel logits."""
        with net_autocast(pred_proj_sph.device, self.dtype):
            proj_depth = torch.clamp(proj_depth / 50.0, 1e-5, 1.0 - 1e-5)
            refine_in = torch.stack([pred_proj_sph, proj_depth], dim=-1)
            sharded = mesh.size(mesh.SP) > 1
            if sharded:
                refine_in = mesh.z_slab(refine_in, 3, grad="gather")
            return proj_depth, self.refine_net(refine_in.to(self.dtype),
                                               sharded=sharded)


class Model(DepthInpaintModel):
    """GenreNet on ``opt.device`` in ``opt.dtype``, eval mode until a
    step; ``init_state`` gives it a seeded start and Adam."""

    @classmethod
    def add_arguments(cls, parser):
        parser, unique = DepthInpaintModel.add_arguments(parser)
        parser.add_argument("--inpaint_path", default=None, type=str,
                            help="pretrained inpainting module checkpoint")
        parser.add_argument("--gt_sph_full", action="store_true",
                            help="oracle: the refine net backprojects the "
                                 "ground-truth full spherical map, not "
                                 "net2's")
        parser.add_argument("--surface_weight", default=1.0, type=float,
                            help="weight for voxel surface prediction")
        parser.add_argument("--joint_w25d", default=0.01, type=float,
                            help="weight on the 2.5D+spherical supervision "
                                 "under --joint_train")
        return parser, unique | {"surface_weight", "joint_train",
                                 "inpaint_path", "joint_w25d"}

    def __init__(self, opt):
        self.gt_sph_full = bool(getattr(opt, "gt_sph_full", False))
        super().__init__(opt)
        if self.joint_train:
            self.requires = self.requires + ["voxel"]
        else:
            self.requires = ["rgb", "silhou", "voxel"]
            if self.gt_depth_input:
                self.requires = self.requires + ["depth", "depth_minmax"]
            if self.gt_minmax_input \
                    and "depth_minmax" not in self.requires:
                self.requires = self.requires + ["depth_minmax"]
            if self.load_offline or self.gt_sph_full:
                # the oracles read the ground-truth spherical maps
                self.requires = self.requires + ["spherical"]
        self.gt_names = self.gt_names + ["voxel"]
        self.metrics = self.metrics + ["voxel_loss", "surface_loss"]
        self.surface_weight = float(getattr(opt, "surface_weight", 1.0))
        self.joint_w25d = float(getattr(opt, "joint_w25d", 0.01))
        init_weights(self.net, torch.Generator().manual_seed(0))
        self.net.to(self.device)

    def build_net(self) -> nn.Module:
        return GenreNet(gt_sph_full=self.gt_sph_full,
                        **self.depth_inpaint_kwargs())

    def slab_params(self):
        """Under sp the refine net's gradients are its Z slab's share."""
        if mesh.size(mesh.SP) == 1:
            return []
        return list(self.net.refine_net.parameters())

    def init_state(self, seed: int = 0) -> None:
        ModelBase.init_state(self, seed)   # net1_path is stage 2's
        if getattr(self.opt, "inpaint_path", None):
            self.load_subnet("depth_and_inpaint", self.opt.inpaint_path)

    def compute_loss(self, pred, batch) -> Tuple[torch.Tensor, Dict]:
        loss, loss_data = (DepthInpaintModel.compute_loss(self, pred, batch)
                           if self.joint_train else (0.0, {}))
        loss = loss * self.joint_w25d
        gt = ops.voxel.surface_from_solid(batch["voxel"])
        logits = pred["pred_voxel"].float()
        voxel_loss = bce_with_logits(logits, gt)
        sig = torch.clamp(torch.sigmoid(logits) * gt, 1e-7, 1.0 - 1e-7)
        # BCE(sig*gt, gt): nonzero only where gt == 1, -log(sigmoid)
        surface_loss = -(gt * torch.log(sig)
                         + (1.0 - gt) * torch.log1p(-sig)).mean()
        loss = loss + voxel_loss + surface_loss * self.surface_weight
        loss_data["voxel_loss"] = voxel_loss
        loss_data["surface_loss"] = surface_loss * self.surface_weight
        loss_data["loss"] = loss
        return loss, loss_data

    def preprocess(self, data, mode="train", rng=None):
        """The ground-truth voxels (X, Y, Z) to the train frame: swap the
        last two axes, flip the last."""
        out = super().preprocess(data, mode, rng)
        if "voxel" in out:
            val = np.asarray(out["voxel"], dtype=np.float32)
            if val.ndim == 4:
                val = val[0]
            out["voxel"] = np.ascontiguousarray(
                np.flip(np.transpose(val, (0, 2, 1)), 2))
        return out

    def predict_step(self, batch: Dict[str, np.ndarray]
                     ) -> Dict[str, torch.Tensor]:
        with trace.span(trace.GENRE_UPLOAD):
            rgb = torch.as_tensor(batch["rgb"], dtype=torch.float32,
                                  device=self.device)
            silhou = torch.as_tensor(batch["silhou"], dtype=torch.float32,
                                     device=self.device)
        self.net.eval()
        with torch.inference_mode():
            pred = self.net(rgb, silhou)
            # back to the dataset's voxel orientation
            pred["pred_voxel_canonical"] = \
                ops.coords.train_frame_to_gt_voxel(pred["pred_voxel"])
        return pred

    def pack_output(self, pred: Dict, batch: Dict, add_gt: bool = True
                    ) -> Dict:
        pack = {}
        if self.joint_train:
            pack = DepthInpaintModel.pack_output(self, pred, batch,
                                                 add_gt=add_gt)
        for k in ("pred_voxel", "pred_proj_depth", "pred_proj_sph_full"):
            pack[k] = as_numpy(pred[k])
        pack["rgb_path"] = batch.get("rgb_path")
        if add_gt and "voxel" in batch:
            pack["gt_voxel"] = as_numpy(batch["voxel"])
        return pack


class ModelTest(TestMixin, Model):
    """Photo -> full GenRe reconstruction."""
    keep_silhou = True

    def __init__(self, opt):
        Model.__init__(self, opt)
        self.requires = ["rgb", "mask"]
        self.init_test(opt)
        self.load_net_file(opt.net_file)
