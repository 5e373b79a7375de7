"""MarrNet-1's loss (counterpart of ``compute_loss`` in
``genre_shapehd_tpu/models/marrnet1.py``): foreground-masked MSE on the
normal and depth maps, full MSE on the silhouette, plus the
(256²/2)-weighted min/max MSE.  GenRe's joint loss uses it; the MarrNet-1
model itself is not ported yet."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .base import ModelBase, masked_mse

#: weight of the depth min/max term
W_MINMAX = (256.0 ** 2) / 2.0


class Model(ModelBase):
    requires = ["rgb", "depth", "silhou", "normal"]
    metrics = ["loss", "depth", "silhou", "normal"]
    pred_depth_minmax = False

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
