"""The models' forward passes, losses and training steps in plain
PyTorch, float32 unless the control's cast says otherwise: GenRe
(net1, the geometry, net2, the 3D U-Net), the ShapeHD test path
(MarrNet-1, MarrNet-2 twice, the critic), and Adam.

Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from . import geometry as geo
from .nets import Net, critic, marrnet2, unet3d, uresnet

NET1 = "depth_and_inpaint.net1"
NET2 = "depth_and_inpaint.net2"
W_MINMAX = 256.0 ** 2 / 2.0


def net1(w, rgb, cast, train: bool = False) -> Dict[str, torch.Tensor]:
    """net1 on the photo: the 2.5D maps (channel-last, on the scale of
    100) and the depth's (N, 2) min/max, in float32."""
    out = uresnet(Net(w, cast, train).sub(NET1), rgb,
                  ("normal", "depth", "silhou"), minmax=True)
    return {k: v.float() for k, v in out.items()}


def camera(depth, minmax, silhou, vox_res: int):
    """net1's depth and min/max, the input silhouette -> the camera
    backprojection (N, res³), ``1 - res * tdf``."""
    return geo.camera_backproject(geo.abs_depth(depth, minmax, silhou),
                                  vox_res)


def partial(proj, sph_res: int, z_res: int, margin: int, cast):
    """The backprojection -> the rendered spherical map, padded: (N, R +
    2m, R + 2m, 1)."""
    sph = geo.render(torch.clamp(proj * 50.0, 1e-5, 1.0 - 1e-5), sph_res,
                     z_res, cast=cast)
    return geo.sph_pad(sph[..., None], margin)


def net2(w, padded, cast, train: bool = False):
    """The padded partial map -> net2's full map, float32."""
    return uresnet(Net(w, cast, train).sub(NET2), padded, ("spherical",),
                   inpainting=True)["spherical"].float()


def refine(w, proj_sph, proj, cast, train: bool = False,
           vox_res: int = 128):
    """The spherical and the camera backprojections -> voxel logits."""
    x = torch.stack([proj_sph, proj.clamp(1e-5, 1.0 - 1e-5)], -1)
    return unet3d(Net(w, cast, train).sub("refine_net"), x, vox_res).float()


def genre(w, rgb, silhou, cast, train: bool = False, vox_res: int = 128,
          sph_res: int = 128, z_res: int = 256, margin: int = 16
          ) -> Dict[str, torch.Tensor]:
    """Photo (N, H, W, 3) and silhouette (N, H, W, 1) on [0, 100] -> the
    2.5D maps and min/max, ``proj_depth`` (the camera backprojection
    times 50), the padded partial and the full spherical maps, the
    latter's backprojection and the voxel logits, each in float32."""
    out = net1(w, rgb, cast, train)
    proj = camera(out["depth"], out["depth_minmax"].detach(), silhou,
                  vox_res)
    part = partial(proj, sph_res, z_res, margin, cast)
    full = net2(w, part, cast, train)
    proj_sph = geo.spherical_backproject(full[..., 0], margin, vox_res)
    out.update(proj_depth=proj * 50.0, pred_sph_partial=part,
               pred_sph_full=full, pred_proj_sph_full=proj_sph,
               pred_voxel=refine(w, proj_sph, proj, cast, train, vox_res))
    return out


def _masked_mse(pred, gt, mask):
    mask = torch.broadcast_to(mask, pred.shape)
    return (mask * (pred - gt) ** 2).sum() / mask.sum().clamp(min=1.0)


def genre_joint_loss(out, batch, joint_w25d: float, surface_weight: float
                     ) -> Dict[str, torch.Tensor]:
    """GenRe's joint loss: the 2.5D, min/max and spherical terms weighted
    by ``joint_w25d``, BCE on the voxels' surface shell and the surface
    term weighted by ``surface_weight``.  Returns every term and ``loss``
    (the 2.5D and spherical terms unweighted, the surface term
    weighted, as the program reports them)."""
    fg = (batch["silhou"] != 0).float()
    terms = {
        "normal": _masked_mse(out["normal"], batch["normal"], fg),
        "depth": _masked_mse(out["depth"], batch["depth"], fg),
        "silhou": ((out["silhou"] - batch["silhou"]) ** 2).mean(),
        "depth_minmax": W_MINMAX * ((out["depth_minmax"]
                                     - batch["depth_minmax"]) ** 2).mean(),
        "spherical": ((out["pred_sph_full"]
                       - batch["spherical_object"]) ** 2).mean(),
    }
    loss = sum(terms.values()) * joint_w25d
    shell = (batch["voxel"] - geo.erode(batch["voxel"])).clamp(0.0, 1.0)
    logits = out["pred_voxel"]
    terms["voxel_loss"] = F.binary_cross_entropy_with_logits(logits, shell)
    sig = (torch.sigmoid(logits) * shell).clamp(1e-7, 1.0 - 1e-7)
    terms["surface_loss"] = -(shell * torch.log(sig) + (1.0 - shell)
                              * torch.log1p(-sig)).mean() * surface_weight
    terms["loss"] = loss + terms["voxel_loss"] + terms["surface_loss"]
    return terms


def shapehd_test(w: Dict[str, Dict], rgb, cast, vox_res: int = 128,
                 thres: float = 30.0) -> Dict[str, torch.Tensor]:
    """MarrNet-1 on the photo, the fine-tuned (``net``) and the frozen
    (``net_noft``) MarrNet-2 on its maps masked where its silhouette is at
    most ``thres``, and the critic (``net_d``) on the sigmoid of each."""
    m1 = uresnet(Net(w["marrnet1"], cast), rgb,
                 ("normal", "depth", "silhou"), minmax=True)
    m1 = {k: v.float() for k, v in m1.items()}
    d = Net(w["net_d"], cast)
    out = dict(m1)
    for key, suffix in (("net", ""), ("net_noft", "_noft")):
        vox = marrnet2(Net(w[key], cast), m1["depth"], m1["normal"],
                       m1["silhou"], thres, vox_res).float()
        out["voxel" + suffix] = vox
        out["is_real" + suffix] = critic(d, torch.sigmoid(vox), vox_res)
    return out


# ----------------------------------------------------------------- training
class Adam:
    """Adam over a list of leaf tensors (weight decay 0): the update
    ``lr * m_hat / (sqrt(v_hat) + eps)`` for every leaf, also those
    whose gradient is 0."""

    def __init__(self, params: List[torch.Tensor], lr: float, b1: float,
                 b2: float, eps: float = 1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = (
            params, lr, b1, b2, eps)
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            g = torch.zeros_like(p) if g is None else g.float()
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))

    def first_gradients(self) -> List[torch.Tensor]:
        """The gradient of the first step, from the first moment."""
        return [m / (1.0 - self.b1) for m in self.m]


def leaves(w: Dict[str, torch.Tensor], names: List[str]
           ) -> List[torch.Tensor]:
    return [w[k] for k in names]


def genre_steps(w, batches, opt, cast) -> Tuple[List[Dict], Dict, Dict]:
    """GenRe's joint training steps on ``batches``: the loss terms of each
    step, the first step's gradient norm of every parameter, and every
    parameter's change over the steps (by name)."""
    names = opt["params"]
    w = {k: v.clone() for k, v in w.items()}
    params = leaves(w, names)
    for p in params:
        p.requires_grad_(True)
    adam = Adam(params, opt["lr"], *opt["betas"])
    start = [p.detach().clone() for p in params]
    losses = []
    for i, batch in enumerate(batches):
        out = genre(w, batch["rgb"], batch["silhou"], cast, train=True,
                    **opt["sizes"])
        terms = genre_joint_loss(out, batch, opt["joint_w25d"],
                                 opt["surface_weight"])
        grads = torch.autograd.grad(terms["loss"], params,
                                    allow_unused=True)
        losses.append({k: float(v.detach()) for k, v in terms.items()})
        adam.step(list(grads))
        if i == 0:
            g1 = {k: float(g.norm()) for k, g in
                  zip(names, adam.first_gradients())}
    change = {k: float((p.detach() - s).norm())
              for k, p, s in zip(names, params, start)}
    return losses, g1, change
