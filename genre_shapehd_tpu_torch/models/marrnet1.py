"""MarrNet-1: RGB -> 2.5D sketches (normal, depth, silhouette [+ min/max])
(counterpart of ``genre_shapehd_tpu/models/marrnet1.py``).

One U-ResNet with three decoder heads and, under ``--pred_depth_minmax``,
the scalar depth min/max head.  Loss: foreground-masked MSE on the normal
and depth maps, full MSE on the silhouette, plus the (256²/2)-weighted
min/max MSE.  GenRe's stage 2 trains on top of this net (``--net1_path``)
and its joint loss reuses :meth:`Model.compute_loss`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..core.checkpoint import load_checkpoint
from ..core.convert import jax_to_torch
from ..nn import UResNet
from ..utils import trace
from .base import ModelBase, as_numpy, masked_mse, net_autocast

#: weight of the depth min/max term
W_MINMAX = (256.0 ** 2) / 2.0


class Model(ModelBase):
    requires = ["rgb", "depth", "silhou", "normal"]
    gt_names = ["depth", "silhou", "normal"]
    metrics = ["loss", "depth", "silhou", "normal"]

    @classmethod
    def add_arguments(cls, parser):
        parser.add_argument(
            "--pred_depth_minmax", action="store_true",
            help="also predict the depth min/max (for GenRe)")
        parser.add_argument(
            "--f32_heads", action="store_true",
            help="run the 2.5D decoders and the min/max head in float32 "
                 "over the encoder in --dtype")
        parser.add_argument(
            "--decoder_width", type=float, default=1.0,
            help="decoder channel multiplier (1.0: the reference "
                 "revuresnet18 widths)")
        parser.add_argument(
            "--no_aug", action="store_true",
            help="disable train-time photometric augmentation")
        return parser, set()

    def __init__(self, opt):
        super().__init__(opt)
        self.pred_depth_minmax = bool(getattr(opt, "pred_depth_minmax",
                                              False))
        if self.pred_depth_minmax:
            self.requires = self.requires + ["depth_minmax"]
            self.gt_names = self.gt_names + ["depth_minmax"]
            self.metrics = self.metrics + ["depth_minmax"]
        self.net = self.build_net().eval()

    def net1_kwargs(self) -> Dict:
        """The U-ResNet's capacity and precision flags (a checkpoint loads
        only into a net built with the same ones)."""
        opt = self.opt
        return dict(im_size=opt.im_size,
                    decoder_width=float(opt.decoder_width),
                    head_dtype=torch.float32 if opt.f32_heads else None)

    def build_net(self) -> nn.Module:
        return UResNet(3, (3, 1, 1), ("normal", "depth", "silhou"),
                       pred_depth_minmax=self.pred_depth_minmax,
                       **self.net1_kwargs())

    def init_state(self, seed: int = 0) -> None:
        super().init_state(seed)
        self.load_backbone()

    def load_backbone(self) -> None:
        """Under ``--backbone_init`` the encoder's weights and batch
        statistics come from that checkpoint's first net, a ResNet-18
        encoder in the JAX package's layout (its ``ResNet18Features``
        tree)."""
        if getattr(self.opt, "backbone_init", None):
            net = load_checkpoint(self.opt.backbone_init)["nets"][0]
            self.net.ResNet18Features_0.load_state_dict(jax_to_torch(
                net["params"], net.get("batch_stats") or {}))

    def forward_batch(self, batch: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        return trace.stage(trace.NET1, self._net1, batch["rgb"])

    def _net1(self, rgb: torch.Tensor) -> Dict[str, torch.Tensor]:
        with net_autocast(rgb.device, self.dtype):
            return self.net(rgb)

    def compute_loss(self, pred: Dict[str, torch.Tensor],
                     batch: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        is_fg = (batch["silhou"] != 0).float()                # (N,H,W,1)
        loss_normal = masked_mse(pred["normal"].float(), batch["normal"],
                                 is_fg)
        loss_depth = masked_mse(pred["depth"].float(), batch["depth"], is_fg)
        loss_silhou = ((pred["silhou"].float() - batch["silhou"]) ** 2).mean()
        loss = loss_normal + loss_depth + loss_silhou
        loss_data = {"normal": loss_normal, "depth": loss_depth,
                     "silhou": loss_silhou}
        if self.pred_depth_minmax:
            loss_minmax = W_MINMAX * ((pred["depth_minmax"].float()
                                       - batch["depth_minmax"]) ** 2).mean()
            loss = loss + loss_minmax
            loss_data["depth_minmax"] = loss_minmax
        loss_data["loss"] = loss
        return loss, loss_data

    def pack_output(self, pred: Dict, batch: Dict, add_gt: bool = True
                    ) -> Dict:
        """The 2.5D maps back in [0, 1] on the host: normal on a white and
        depth on a black background outside the ground-truth silhouette."""
        out = {"rgb_path": batch.get("rgb_path")}
        gt_silhou = self.postprocess(as_numpy(batch["silhou"]))
        out["pred_normal"] = self.postprocess(
            as_numpy(pred["normal"]), bg=1.0, input_mask=gt_silhou)
        out["pred_silhou"] = self.postprocess(as_numpy(pred["silhou"]))
        out["pred_depth"] = self.postprocess(
            as_numpy(pred["depth"]), bg=0.0, input_mask=gt_silhou)
        if self.pred_depth_minmax and "depth_minmax" in pred:
            out["pred_depth_minmax"] = as_numpy(pred["depth_minmax"])
            if add_gt and "depth_minmax" in batch:
                out["gt_depth_minmax"] = as_numpy(batch["depth_minmax"])
        return out
