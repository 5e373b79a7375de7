"""ShapeHD: MarrNet-2 finetuned with a frozen WGAN-GP critic as its shape
prior (counterpart of ``genre_shapehd_tpu/models/shapehd.py``).

Three nets: ``net``, the finetuned MarrNet-2 (from ``--marrnet2``);
``net_noft``, a frozen copy of it as loaded; ``net_d``, the frozen critic
(``--gan``'s ``nets[1]``).  Loss: BCE(pred, gt) - ``w_gan_loss`` * mean
D(sigmoid(pred)); only ``net`` is optimised, the critic passing the
gradient to its input only.  A train step computes what the loss reads
(``net`` and the critic on its output); an eval or test batch also runs
``net_noft`` and scores its output.  On the card in bfloat16 the
decoders' last layer runs K3, and the critic's first layer K6 with no
gradient recorded or, in a train step, with its backward to the
critic's input, whose transposed convolution is K3 again: a train step
launches K3 twice and K6 once each way, an eval or test batch K3 and K6
twice each.  Across ranks
(``cli.train --multihost``) only ``net``'s gradients are averaged; the
frozen copy and the critic take no gradient and run in eval mode, so
their parameters and statistics stay as loaded on every rank.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..core.checkpoint import load_checkpoint
from ..core.convert import jax_to_torch
from ..nn import VoxelDiscriminator, init_weights
from ..utils import trace
from .base import ModelBase, as_numpy, bce_with_logits, net_autocast
from .marrnet import marrnet1_net, pack_2d
from .marrnet2 import Model as Marrnet2Model
from .test_base import TestMixin


class Model(Marrnet2Model):
    metrics = ["loss", "sup", "gan"]

    @classmethod
    def add_arguments(cls, parser):
        parser.add_argument("--canon_sup", action="store_true",
                            help="use canonical-pose voxel supervision")
        parser.add_argument("--marrnet2", type=str, default=None,
                            help="pretrained MarrNet-2 checkpoint to "
                                 "finetune")
        parser.add_argument("--gan", type=str, default=None,
                            help="pretrained WGAN-GP checkpoint")
        parser.add_argument("--w_gan_loss", type=float, default=0.0,
                            help="perceptual (critic) loss weight")
        return parser, set()

    def __init__(self, opt, silhou_thres: float = 0.0):
        super().__init__(opt, silhou_thres=silhou_thres)
        if not getattr(opt, "canon_sup", False):
            raise ValueError("ShapeHD uses canonical-pose voxels: pass "
                             "--canon_sup")
        self.w_gan_loss = float(getattr(opt, "w_gan_loss", 0.0))
        if self.w_gan_loss < 0:
            raise ValueError(f"--w_gan_loss {self.w_gan_loss} < 0")
        self.net_noft = self.build_net().eval().requires_grad_(False)
        self.net_d = VoxelDiscriminator(64, opt.vox_res).eval() \
            .requires_grad_(False)

    @property
    def net_names(self):
        return ["net", "net_noft", "net_d"]

    def net_modules(self):
        return {"net": self.net, "net_noft": self.net_noft,
                "net_d": self.net_d}

    def init_state(self, seed: int = 0) -> None:
        ModelBase.init_state(self, seed)
        if getattr(self.opt, "marrnet2", None):
            self.load_subnet("", self.opt.marrnet2)
        self.net_noft.load_state_dict(self.net.state_dict())
        init_weights(self.net_d, torch.Generator().manual_seed(seed + 1))
        if getattr(self.opt, "gan", None):
            # a WGAN-GP checkpoint holds (net_g, net_d)
            critic = load_checkpoint(self.opt.gan)["nets"][1]
            self.net_d.load_state_dict(jax_to_torch(critic["params"], {}))
        self.net_noft.to(self.device)
        self.net_d.to(self.device)

    def critic(self, voxel_logits: torch.Tensor) -> torch.Tensor:
        return trace.stage(trace.CRITIC, self._critic, voxel_logits)

    def _critic(self, voxel_logits: torch.Tensor) -> torch.Tensor:
        with net_autocast(voxel_logits.device, self.dtype):
            return self.net_d(torch.sigmoid(voxel_logits.float()))

    def forward_batch(self, batch: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        pred = super().forward_batch(batch)
        pred["is_real"] = self.critic(pred["voxel"])
        if not self.net.training:
            args = (batch["depth"], batch["normal"], batch["silhou"])
            with trace.span(trace.NET_NOFT), torch.no_grad(), \
                    net_autocast(args[0].device, self.dtype):
                pred["voxel_noft"] = self.net_noft(*args)
            with torch.no_grad():
                pred["is_real_noft"] = self.critic(pred["voxel_noft"])
        return pred

    def compute_loss(self, pred, batch) -> Tuple[torch.Tensor, Dict]:
        sup = bce_with_logits(pred["voxel"].float(), batch[self.voxel_key])
        gan = -pred["is_real"].float().mean() * self.w_gan_loss
        loss = sup + gan
        return loss, {"loss": loss, "sup": sup, "gan": gan}

    def pack_output(self, pred, batch, add_gt=True):
        out = {"rgb_path": batch.get("rgb_path"),
               "pred_voxel": as_numpy(pred["voxel"]),
               "pred_voxel_noft": as_numpy(pred["voxel_noft"])}
        if add_gt and self.voxel_key in batch:
            out["gt_voxel"] = as_numpy(batch[self.voxel_key])
        return out


class ModelTest(TestMixin, Model):
    """Photo -> 2.5D sketches (MarrNet-1 from ``--marrnet1_file``) ->
    voxels of the finetuned and the frozen MarrNet-2, and their critic
    scores."""

    def __init__(self, opt):
        if not getattr(opt, "marrnet1_file", None):
            raise ValueError("ShapeHD's test path needs --marrnet1_file")
        opt.canon_sup = True             # the net needs no ground truth here
        Model.__init__(self, opt,
                       silhou_thres=self.pred_silhou_thres * self.scale_25d)
        self.requires = ["rgb", "mask"]
        self.marrnet1 = marrnet1_net(opt.im_size).eval()
        self.init_test(opt)
        for net in (self.net, self.net_noft, self.net_d, self.marrnet1):
            net.to(self.device)
        self.load_net_file(opt.net_file)
        src = load_checkpoint(opt.marrnet1_file)["nets"][0]
        self.marrnet1.load_state_dict(jax_to_torch(
            src["params"], src.get("batch_stats") or {}))

    def predict_step(self, batch: Dict[str, np.ndarray]
                     ) -> Dict[str, torch.Tensor]:
        with trace.span(trace.SHAPEHD_UPLOAD):
            rgb = torch.as_tensor(batch["rgb"], dtype=torch.float32,
                                  device=self.device)
        self.net.eval()
        with torch.inference_mode():
            with trace.span(trace.MARRNET1), \
                    net_autocast(rgb.device, self.dtype):
                pred1 = self.marrnet1(rgb)
            pred2 = self.forward_batch(pred1)
        return {**pred1, **pred2}

    def pack_output(self, pred, batch, add_gt=True):
        out = pack_2d(self, pred, batch)
        out["pred_voxel"] = as_numpy(pred["voxel"])
        out["pred_voxel_noft"] = as_numpy(pred["voxel_noft"])
        return out
