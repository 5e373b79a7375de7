"""MarrNet end to end: a frozen MarrNet-1 feeding a finetuned MarrNet-2
(counterpart of ``genre_shapehd_tpu/models/marrnet.py``).

MarrNet-1 runs in eval mode and without a gradient; its predicted
silhouette, thresholded at ``pred_silhou_thres * scale_25d`` (0.3 x 100),
masks its predicted depth and normal, which MarrNet-2 maps to voxels.
Loss: BCE-with-logits on the voxels.  Adam holds every parameter, as the
JAX package's optimizer does; MarrNet-1's gradients are 0, so its weights
stay bit for bit (``--wdecay`` would move them, as there).  Across ranks
(``cli.train --multihost``) their zero gradients are averaged with the
rest, and MarrNet-1's statistics, in eval mode, stay as loaded.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from ..data import preprocess as pp
from ..nn import UResNet
from ..utils import trace
from .base import ModelBase, as_numpy, bce_with_logits, net_autocast
from .marrnet2 import Marrnet2Net, Model as Marrnet2Model
from .test_base import TestMixin


def marrnet1_net(im_size: int) -> UResNet:
    """MarrNet-1 as MarrNet and ShapeHD run it: with the min/max head."""
    return UResNet(3, (3, 1, 1), ("normal", "depth", "silhou"),
                   pred_depth_minmax=True, im_size=im_size)


class MarrnetNet(nn.Module):
    """rgb (N, H, W, 3) -> MarrNet-1's maps and ``voxel`` logits."""

    def __init__(self, pred_silhou_thres: float = 30.0, vox_res: int = 128,
                 im_size: int = 256):
        super().__init__()
        self.marrnet1 = marrnet1_net(im_size)
        self.marrnet2 = Marrnet2Net(vox_res=vox_res,
                                    silhou_thres=pred_silhou_thres)

    def train(self, mode: bool = True):
        super().train(mode)
        self.marrnet1.train(False)           # frozen, in eval mode
        return self

    def forward(self, rgb: torch.Tensor) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            pred = trace.stage(trace.MARRNET1, self.marrnet1, rgb)
        vox = trace.stage(trace.MARRNET2, self.marrnet2, pred["depth"],
                          pred["normal"], pred["silhou"])
        return {**pred, "voxel": vox}


def pack_2d(model: ModelBase, pred: Dict, batch: Dict) -> Dict:
    """The photo and MarrNet-1's maps on the host: the silhouette in
    [0, 1], normal on a white and depth on a black background outside
    it."""
    out = {"rgb_path": batch.get("rgb_path")}
    if "rgb" in batch:
        out["rgb"] = pp.denormalize_colors(np.asarray(batch["rgb"]))
    silhou = np.clip(as_numpy(pred["silhou"]) / model.scale_25d, 0, 1)
    out["pred_silhou"] = silhou
    out["pred_normal"] = model.postprocess(as_numpy(pred["normal"]), bg=1.0,
                                           input_mask=silhou)
    out["pred_depth"] = model.postprocess(as_numpy(pred["depth"]), bg=0.0,
                                          input_mask=silhou)
    return out


class Model(Marrnet2Model):
    """MarrNet-1 from ``--marrnet1``, MarrNet-2 from ``--marrnet2``
    (checkpoints of either package), MarrNet-2 trained."""
    requires = ["rgb", "voxel"]
    metrics = ["loss"]

    @classmethod
    def add_arguments(cls, parser):
        parser.add_argument("--canon_sup", action="store_true",
                            help="use canonical-pose voxel supervision")
        parser.add_argument("--marrnet1", type=str, default=None,
                            help="pretrained MarrNet-1 checkpoint")
        parser.add_argument("--marrnet2", type=str, default=None,
                            help="pretrained MarrNet-2 checkpoint to "
                                 "finetune")
        return parser, set()

    def __init__(self, opt):
        super().__init__(opt)
        self.requires = ["rgb", self.voxel_key]

    def build_net(self) -> nn.Module:
        return MarrnetNet(self.pred_silhou_thres * self.scale_25d,
                          self.opt.vox_res, self.opt.im_size)

    def init_state(self, seed: int = 0) -> None:
        super().init_state(seed)
        for sub in ("marrnet1", "marrnet2"):
            if getattr(self.opt, sub, None):
                self.load_subnet(sub, getattr(self.opt, sub))

    def forward_batch(self, batch: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        rgb = batch["rgb"]
        with net_autocast(rgb.device, self.dtype):
            return self.net(rgb)

    def compute_loss(self, pred, batch) -> Tuple[torch.Tensor, Dict]:
        loss = bce_with_logits(pred["voxel"].float(), batch[self.voxel_key])
        return loss, {"loss": loss}

    def predict_step(self, batch: Dict[str, np.ndarray]
                     ) -> Dict[str, torch.Tensor]:
        with trace.span(trace.MARRNET_UPLOAD):
            rgb = torch.as_tensor(batch["rgb"], dtype=torch.float32,
                                  device=self.device)
        self.net.eval()
        with torch.inference_mode():
            return self.forward_batch({"rgb": rgb})

    def pack_output(self, pred: Dict, batch: Dict, add_gt: bool = True
                    ) -> Dict:
        out = pack_2d(self, pred, batch)
        out["pred_voxel"] = as_numpy(pred["voxel"])
        if add_gt and self.voxel_key in batch:
            out["gt_voxel"] = as_numpy(batch[self.voxel_key])
        return out


class ModelTest(TestMixin, Model):
    """Photo -> voxels."""

    def __init__(self, opt):
        Model.__init__(self, opt)
        self.requires = ["rgb", "mask"]
        self.init_test(opt)
        self.net.to(self.device)
        self.load_net_file(opt.net_file)
