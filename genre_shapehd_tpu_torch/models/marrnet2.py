"""MarrNet-2: 2.5D sketches (depth and normal, masked by the silhouette)
-> voxels (counterpart of ``genre_shapehd_tpu/models/marrnet2.py``).

A ResNet-18 encoder over the 4-channel (depth, normal) stack -> a 200-d
latent -> the 3D deconv decoder -> res³ logits, its last layer on K3;
BCE-with-logits against the view-space voxels (or the canonical ones,
``--canon_sup``).  ShapeHD finetunes this net, and MarrNet runs it on
MarrNet-1's predictions.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..nn import ResNet18Encoder, VoxelDecoder
from ..utils import trace
from .base import ModelBase, as_numpy, bce_with_logits, net_autocast


class Marrnet2Net(nn.Module):
    """Encoder and decoder with the input masking: depth and normal are
    zeroed where ``silhou <= silhou_thres`` (0 in training; 0.3 x 100 on
    MarrNet-1's predicted silhouette).  Inputs channel-last (N, H, W, C),
    output (N, res, res, res) logits."""

    def __init__(self, encode_dims: int = 200, nf: int = 512,
                 vox_res: int = 128, silhou_thres: float = 0.0):
        super().__init__()
        self.silhou_thres = silhou_thres
        self.ResNet18Encoder_0 = ResNet18Encoder(4, encode_dims)
        self.VoxelDecoder_0 = VoxelDecoder(encode_dims, nf, vox_res)

    def forward(self, depth: torch.Tensor, normal: torch.Tensor,
                silhou: torch.Tensor) -> torch.Tensor:
        is_fg = (silhou > self.silhou_thres).to(depth.dtype)
        x = torch.cat([depth * is_fg, normal * is_fg], dim=-1)
        return self.VoxelDecoder_0(self.ResNet18Encoder_0(
            x.permute(0, 3, 1, 2)))


class Model(ModelBase):
    """MarrNet-2 on ``opt.device`` in ``opt.dtype``.  Its predictions are
    ``{"voxel": logits}``."""
    requires = ["rgb", "depth", "normal", "silhou", "voxel"]
    gt_names = ["voxel"]
    metrics = ["loss"]

    @classmethod
    def add_arguments(cls, parser):
        parser.add_argument(
            "--canon_sup", action="store_true",
            help="use canonical-pose voxels as supervision")
        return parser, set()

    def __init__(self, opt, silhou_thres: float = 0.0):
        super().__init__(opt)
        self.voxel_key = "voxel_canon" if getattr(opt, "canon_sup", False) \
            else "voxel"
        self.requires = ["rgb", "depth", "normal", "silhou", self.voxel_key]
        self.gt_names = [self.voxel_key]
        # the net's input mask; ``silhou_thres`` stays the dataset's
        # binarization threshold of ``preprocess``
        self.mask_thres = silhou_thres
        self.net = self.build_net().eval()

    def build_net(self) -> nn.Module:
        return Marrnet2Net(vox_res=self.opt.vox_res,
                           silhou_thres=self.mask_thres)

    def forward_batch(self, batch: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        return {"voxel": trace.stage(trace.MARRNET2, self._marrnet2,
                                     batch["depth"], batch["normal"],
                                     batch["silhou"])}

    def _marrnet2(self, depth: torch.Tensor, normal: torch.Tensor,
                  silhou: torch.Tensor) -> torch.Tensor:
        with net_autocast(depth.device, self.dtype):
            return self.net(depth, normal, silhou)

    def compute_loss(self, pred, batch) -> Tuple[torch.Tensor, Dict]:
        loss = bce_with_logits(pred["voxel"].float(), batch[self.voxel_key])
        return loss, {"loss": loss}

    def pack_output(self, pred: Dict, batch: Dict, add_gt: bool = True
                    ) -> Dict:
        out = {"rgb_path": batch.get("rgb_path"),
               "pred_voxel": as_numpy(pred["voxel"])}
        if add_gt and self.voxel_key in batch:
            out["gt_voxel"] = as_numpy(batch[self.voxel_key])
        return out
