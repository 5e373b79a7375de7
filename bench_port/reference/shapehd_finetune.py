"""ShapeHD's fine-tuning step in plain PyTorch, float32 unless the
control's cast says otherwise: MarrNet-2 in train mode on the masked
depth and normal, the frozen 3D-WGAN-GP critic on the sigmoid of its
logits, the loss ``BCE(logits, voxel_canon) - w_gan_loss * mean D``,
MarrNet-2's gradients and Adam; and the critic term's gradient with
respect to the logits alone.

As the GenRe-ShapeHD repository's ``models/shapehd.py`` (lines 67-79)
computes the step, but:

- the weights are the benchmark's (seeded, calibrated), not a trained
  MarrNet-2 and critic;
- MarrNet-2's input mask is the ground truth's silhouette above 0 (the
  preprocessed silhouette is 0 or 100), as the port's ``--canon_sup``
  training masks it;
- BatchNorm normalises with the batch's biased statistics and its
  running statistics are not kept: no number compared reads them;
- Adam updates every MarrNet-2 parameter in every step (weight decay
  0), a parameter that no loss reaches too, as the port's optimizer
  does; the critic takes no gradient;
- each convolution's input, weight and output pass through the cast
  (``nets.Net``): the identity here, fp8 in the control.

Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .models import Adam, leaves
from .nets import Net, critic, marrnet2


def gan_term(w_d, logits, cast, res: int, w_gan: float
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``-w_gan * mean D(sigmoid(logits))`` and its size before the
    scores cancel: ``w_gan`` times the mean of each score's summed
    magnitudes of the last layer's products."""
    score, mag = critic(Net(w_d, cast), torch.sigmoid(logits), res,
                        scale=True)
    return -score.mean() * w_gan, mag.mean().detach() * w_gan


def critic_grad(w_d, logits, cast, res: int, w_gan: float) -> torch.Tensor:
    """The gradient of the critic's term of the loss with respect to the
    logits (N, R, R, R), through the frozen critic."""
    x = logits.detach().clone().requires_grad_(True)
    gan, _ = gan_term(w_d, x, cast, res, w_gan)
    (g,) = torch.autograd.grad(gan, x)
    return g


def shapehd_steps(w, w_d, batches, opt, cast
                  ) -> Tuple[List[Dict], Dict, Dict, List[float]]:
    """ShapeHD's fine-tuning steps on ``batches`` (depth, normal, silhou,
    voxel_canon): each step's loss terms (``loss``, ``sup``, ``gan``),
    each MarrNet-2 parameter's first gradient norm and change over the
    steps (by name), and each step's size of the ``gan`` term."""
    names = opt["params"]
    w = {k: v.clone() for k, v in w.items()}
    params = leaves(w, names)
    for p in params:
        p.requires_grad_(True)
    adam = Adam(params, opt["lr"], *opt["betas"])
    start = [p.detach().clone() for p in params]
    res, w_gan = opt["vox_res"], opt["w_gan_loss"]
    losses, scales = [], []
    for i, batch in enumerate(batches):
        logits = marrnet2(Net(w, cast, train=True), batch["depth"],
                          batch["normal"], batch["silhou"], 0.0,
                          res).float()
        sup = F.binary_cross_entropy_with_logits(logits,
                                                 batch["voxel_canon"])
        gan, scale = gan_term(w_d, logits, cast, res, w_gan)
        loss = sup + gan
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        losses.append({"loss": float(loss.detach()),
                       "sup": float(sup.detach()),
                       "gan": float(gan.detach())})
        scales.append(float(scale))
        adam.step(list(grads))
        if i == 0:
            g1 = {k: float(g.norm()) for k, g in
                  zip(names, adam.first_gradients())}
    change = {k: float((p.detach() - s).norm())
              for k, p, s in zip(names, params, start)}
    return losses, g1, change, scales
