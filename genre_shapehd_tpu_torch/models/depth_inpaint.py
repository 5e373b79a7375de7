"""GenRe stage 2: depth prediction + spherical-map inpainting
(counterpart of ``genre_shapehd_tpu/models/depth_inpaint.py``).

  rgb --net1 (U-ResNet + minmax)--> 2.5D + minmax
      --abs depth, silhouette-masked, camera frame--> camera backprojection
      --spherical render (CUDA kernels K1, K2; ``exact_render``: the
        trilinear ray sampler of ``ops/render_sph.py``)--> partial map
      --wrap/replicate pad--> net2 (inpainting U-ResNet) --> full map

The nets run in the compute dtype; the geometry between them in float32.
Each stage runs as a stage of ``utils/trace.py``: under a span named
``genre.<stage>`` and, while a profiler records a training step, with its
backward under ``genre.<stage>.backward`` (no cost unless a profiler is
recording); ``bench_port/metrics/`` reads them for the per-stage device
times.

Training: without ``joint_train`` net1 runs in eval mode and without a
gradient (the JAX package's ``train=train and joint_train`` and its
stop-gradient), while net2 follows the module's mode.  With it, the
loss reaches net1 through the renderer and the camera backprojection;
the depth min/max and the silhouette stay detached, as there.

Oracle inputs of the quality benchmark: ``gt_depth_input`` feeds the
ground-truth depth and min/max into the geometry chain instead of net1's,
``gt_minmax_input`` the ground-truth min/max alone, and ``load_offline``
gives net2 the dataset's spherical map instead of the rendered one.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import ops
from ..nn import UResNet
from ..utils import trace
from .base import as_numpy, net_autocast, to_abs_depth
from .marrnet1 import Model as DepthModel


class DepthInpaintNet(nn.Module):
    """net1 + net2 + the geometry chain between them.  ``net1_width`` and
    ``net1_head_dtype`` are net1's ``decoder_width`` and ``head_dtype``."""

    def __init__(self, im_size: int = 256, vox_res: int = 128,
                 sph_res: int = 128, z_res: int = 256,
                 padding_margin: int = 16, joint_train: bool = False,
                 dtype: torch.dtype = torch.float32, *,
                 load_offline: bool = False, exact_render: bool = False,
                 gt_depth_input: bool = False,
                 gt_minmax_input: bool = False, net1_width: float = 1.0,
                 net1_head_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.vox_res, self.sph_res, self.z_res = vox_res, sph_res, z_res
        self.padding_margin = padding_margin
        self.joint_train = joint_train
        self.dtype = dtype
        self.load_offline = load_offline
        self.exact_render = exact_render
        self.gt_depth_input = gt_depth_input
        self.gt_minmax_input = gt_minmax_input
        self.net1 = UResNet(3, (3, 1, 1), ("normal", "depth", "silhou"),
                            pred_depth_minmax=True, im_size=im_size,
                            decoder_width=net1_width,
                            head_dtype=net1_head_dtype)
        self.net2 = UResNet(1, (1,), ("spherical",), inpainting=True)

    def train(self, mode: bool = True):
        super().train(mode)
        self.net1.train(mode and self.joint_train)
        return self

    @staticmethod
    def get_abs_depth(out1: Dict[str, torch.Tensor],
                      silhou_in: torch.Tensor) -> torch.Tensor:
        pred_depth = out1["depth"].float() / 100.0
        minmax = out1["depth_minmax"].float().detach()
        abs_depth = to_abs_depth(1.0 - pred_depth, minmax)
        silhou = silhou_in / 100.0
        abs_depth = torch.where(silhou < 0.5, 0.0, abs_depth)
        return ops.coords.depth_image_to_cambp_frame(abs_depth[..., 0])

    def forward(self, rgb: torch.Tensor, silhou: torch.Tensor,
                spherical_depth: Optional[torch.Tensor] = None,
                gt_depth: Optional[torch.Tensor] = None,
                gt_minmax: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """rgb (N, H, W, 3), silhou (N, H, W, 1) in [0, 100]; the oracle
        inputs as the dataset gives them: spherical_depth (N, R, R, 1),
        gt_depth (N, H, W, 1) in [0, 100], gt_minmax (N, 2)."""
        out1 = trace.stage(trace.NET1, self._net1, rgb)
        if self.gt_depth_input and gt_depth is not None:
            out1["depth"] = gt_depth.detach()
            out1["depth_minmax"] = gt_minmax.detach()
        elif self.gt_minmax_input and gt_minmax is not None:
            out1["depth_minmax"] = gt_minmax.detach()
        proj = trace.stage(trace.CAMERA_BP, self._camera_bp, out1, silhou)
        sph_in = trace.stage(trace.RENDER, self._render, proj,
                             spherical_depth)
        sph_in, sph_full = trace.stage(trace.NET2, self._net2, sph_in)
        out1["proj_depth"] = proj * 50.0
        out1["pred_sph_partial"] = sph_in
        out1["pred_sph_full"] = sph_full
        return out1

    def _net1(self, rgb: torch.Tensor) -> Dict[str, torch.Tensor]:
        with net_autocast(rgb.device, self.dtype), torch.set_grad_enabled(
                torch.is_grad_enabled() and self.joint_train):
            return self.net1(rgb)

    def _camera_bp(self, out1: Dict[str, torch.Tensor],
                   silhou: torch.Tensor) -> torch.Tensor:
        abs_depth = self.get_abs_depth(out1, silhou)
        return ops.camera_backproject_shifted(
            abs_depth, ops.FL_GENRE, ops.CAM_DIST, self.vox_res)

    def _render(self, proj: torch.Tensor,
                spherical_depth: Optional[torch.Tensor]) -> torch.Tensor:
        if self.load_offline and spherical_depth is not None:
            return spherical_depth[..., 0]
        clipped = torch.clamp(proj * 50.0, 1e-5, 1.0 - 1e-5)
        if self.exact_render:
            return ops.render_spherical(clipped, self.sph_res, self.z_res)
        return ops.render_spherical_fast(clipped, self.sph_res, self.z_res,
                                         compute_dtype=self.dtype)

    def _net2(self, sph_in: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The padded partial map and net2's full map."""
        with net_autocast(sph_in.device, self.dtype):
            sph_in = ops.sph_pad(sph_in[..., None], self.padding_margin)
            return sph_in, self.net2(sph_in.to(self.dtype))["spherical"]


class Model(DepthModel):
    """GenRe stage 2 (``depth_pred_with_sph_inpaint``): net1 (frozen unless
    ``--joint_train``, loaded from ``--net1_path``) and net2 trained on the
    spherical MSE (plus MarrNet-1's losses under ``--joint_train``).
    ``genre_full.Model`` builds on it."""
    gt_sph_full = False

    @classmethod
    def add_arguments(cls, parser):
        parser.add_argument("--pred_depth_minmax", action="store_true",
                            default=True,
                            help="GenRe needs the min/max prediction")
        parser.add_argument("--load_offline", action="store_true",
                            help="oracle: net2 reads the dataset's "
                                 "spherical map, not the rendered one")
        parser.add_argument("--joint_train", action="store_true",
                            help="jointly train net1 and net2")
        parser.add_argument("--net1_path", default=None, type=str,
                            help="pretrained net1 (marrnet1) checkpoint")
        parser.add_argument("--padding_margin", default=16, type=int)
        parser.add_argument("--exact_render", action="store_true",
                            help="render with the trilinear ray sampler "
                                 "(ops/render_sph.py) instead of the "
                                 "kernels K1 and K2")
        parser.add_argument("--gt_depth_input", action="store_true",
                            help="oracle: the ground-truth depth and "
                                 "min/max feed the geometry chain")
        parser.add_argument("--gt_minmax_input", action="store_true",
                            help="oracle: net1's depth map with the "
                                 "ground-truth min/max")
        parser.add_argument("--f32_heads", action="store_true",
                            help="net1's decoders and heads in float32 "
                                 "(must match the net1 checkpoint)")
        parser.add_argument("--decoder_width", type=float, default=1.0,
                            help="net1's decoder channel multiplier (must "
                                 "match the net1 checkpoint)")
        parser.add_argument("--no_aug", action="store_true",
                            help="disable train-time photometric "
                                 "augmentation")
        return parser, {"joint_train"}

    def __init__(self, opt):
        opt.pred_depth_minmax = True
        self.joint_train = bool(getattr(opt, "joint_train", False))
        self.load_offline = bool(getattr(opt, "load_offline", False))
        self.exact_render = bool(opt.exact_render)
        self.gt_depth_input = bool(getattr(opt, "gt_depth_input", False))
        self.gt_minmax_input = bool(getattr(opt, "gt_minmax_input", False))
        super().__init__(opt)
        if self.joint_train:
            self.requires = ["rgb", "depth", "silhou", "normal",
                             "depth_minmax", "spherical"]
            self.gt_names = ["depth", "silhou", "normal", "depth_minmax",
                             "spherical_object"]
            self.metrics = ["loss", "depth", "silhou", "normal",
                            "depth_minmax", "spherical"]
        else:
            self.requires = ["silhou", "rgb", "spherical"]
            self.gt_names = ["spherical_object"]
            self.metrics = ["loss", "spherical"]
        if self.gt_depth_input:
            for key in ("depth", "depth_minmax"):
                if key not in self.requires:
                    self.requires = self.requires + [key]
        if self.gt_minmax_input and "depth_minmax" not in self.requires:
            self.requires = self.requires + ["depth_minmax"]

    def depth_inpaint_kwargs(self) -> Dict:
        opt = self.opt
        kw = self.net1_kwargs()
        return dict(im_size=opt.im_size, vox_res=opt.vox_res,
                    sph_res=opt.sph_res, z_res=opt.z_res,
                    padding_margin=opt.padding_margin,
                    joint_train=self.joint_train, dtype=self.dtype,
                    load_offline=self.load_offline,
                    exact_render=self.exact_render,
                    gt_depth_input=self.gt_depth_input,
                    gt_minmax_input=self.gt_minmax_input,
                    net1_width=kw["decoder_width"],
                    net1_head_dtype=kw["head_dtype"])

    def build_net(self) -> nn.Module:
        return DepthInpaintNet(**self.depth_inpaint_kwargs())

    def init_state(self, seed: int = 0) -> None:
        super().init_state(seed)
        if getattr(self.opt, "net1_path", None):
            self.load_subnet("net1", self.opt.net1_path)

    def load_backbone(self) -> None:
        """None: net1 starts from ``--net1_path``; ``--backbone_init`` is
        MarrNet-1's alone, as in the JAX package."""

    def oracle_inputs(self, batch: Dict[str, torch.Tensor]) -> Dict:
        """The batch's tensors that the oracle flags feed into the net."""
        kw = {}
        if self.load_offline:
            kw["spherical_depth"] = batch.get("spherical_depth")
        if self.gt_depth_input:
            kw["gt_depth"] = batch.get("depth")
            kw["gt_minmax"] = batch.get("depth_minmax")
        elif self.gt_minmax_input:
            kw["gt_minmax"] = batch.get("depth_minmax")
        if self.gt_sph_full:
            kw["gt_sph"] = batch.get("spherical_object")
        return kw

    def forward_batch(self, batch: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        return self.net(batch["rgb"], batch["silhou"],
                        **self.oracle_inputs(batch))

    def compute_loss(self, pred, batch) -> Tuple[torch.Tensor, Dict]:
        loss, loss_data = (super().compute_loss(pred, batch)
                           if self.joint_train else (0.0, {}))
        sph_loss = ((pred["pred_sph_full"].float()
                     - batch["spherical_object"]) ** 2).mean()
        loss = loss + sph_loss
        loss_data["spherical"] = sph_loss
        loss_data["loss"] = loss
        return loss, loss_data

    def preprocess(self, data, mode="train", rng=None):
        """Adds the wrap / edge padding of the ground-truth spherical map;
        spherical arrays are stored channel-last (H+2m, W+2m, 1)."""
        out = super().preprocess(data, mode, rng)
        if "spherical_object" in out:
            val = np.asarray(out["spherical_object"])          # (1, R, R)
            padded = ops.sph_pad_numpy(val, self.opt.padding_margin)
            out["spherical_object"] = np.moveaxis(
                padded, 0, -1).astype(np.float32)
        if "spherical_depth" in out:
            out["spherical_depth"] = np.moveaxis(
                np.asarray(out["spherical_depth"]), 0, -1).astype(np.float32)
        return out

    def pack_output(self, pred, batch, add_gt=True):
        pack = {}
        if self.joint_train:
            pack = super().pack_output(pred, batch, add_gt=False)
        pack["pred_spherical_full"] = as_numpy(pred["pred_sph_full"])
        pack["pred_spherical_partial"] = as_numpy(pred["pred_sph_partial"])
        pack["proj_depth"] = as_numpy(pred["proj_depth"])
        pack["rgb_path"] = batch.get("rgb_path")
        if add_gt and "spherical_object" in batch:
            pack["gt_spherical_full"] = as_numpy(batch["spherical_object"])
        return pack
