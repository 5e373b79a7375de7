"""3D-WGAN-GP shape prior on canonical-pose voxels (counterpart of
``genre_shapehd_tpu/models/wgangp.py``).

One train step computes what the JAX package's step computes:

  * D phase: fake = G(z1), detached; D loss = mean D(fake) - mean D(real)
    + lambda * mean((||grad_x D(interp)||_2 - norm)^2), the norm taken
    as sqrt(sum + 1e-16), interp = alpha * real + (1 - alpha) * fake.  The
    input gradient comes from ``torch.autograd.grad(create_graph=True)``,
    so D's update differentiates through it (cuDNN's convolutions; K3 is
    not on this path, the fake being detached).
  * G phase, when ``step % gan_d_iter == 0`` (from step 0): G's loss is
    -mean D(G(z2)) under the updated D, whose parameters take no gradient.
  * G stays in train mode in both phases, so its BatchNorm statistics
    move twice a step (once when the G phase is skipped).

Metrics keep the reference's names and signs: err_d_real = -mean D(real),
err_d_fake = mean D(fake), err_d_gp, err_d = loss = D's loss, err_g =
-mean D(G(z2)), carried as ``last_err_g`` (a checkpoint's ``extra``)
through the steps that skip G.

The draws z1, alpha and z2 come from the model's ``torch.Generator`` on
its device, seeded by ``--manual_seed``; ``train_step`` takes them as an
argument instead (the parity tests hand it the JAX step's draws).  They
are drawn for the global batch: in a group of ranks (``cli.train
--multihost``) every rank draws all of them alike, as the JAX package
draws them from one replicated key, and uses its dp index's slice (the
sp ranks of ``--sp`` hold copies); the gradients are averaged over the
ranks before each optimizer's step.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..nn import VoxelDiscriminator, VoxelGenerator, init_weights
from ..parallel import mesh
from ..utils import trace
from .base import ModelBase, as_numpy, keep_batch_stats, net_autocast


class Model(ModelBase):
    requires = ["voxel_canon"]
    gt_names: list = []
    metrics = ["err_d_real", "err_d_fake", "err_d_gp", "err_d", "err_g",
               "loss"]
    nz = 200

    @classmethod
    def add_arguments(cls, parser):
        parser.add_argument("--canon_voxel", action="store_true",
                            help="generate/discriminate canonical voxels")
        parser.add_argument("--wgangp_lambda", type=float, default=10.0,
                            help="gradient penalty coefficient")
        parser.add_argument("--wgangp_norm", type=float, default=1.0,
                            help="gradient penalty target norm")
        parser.add_argument("--gan_d_iter", type=int, default=1,
                            help="D iterations per G iteration")
        return parser, set()

    def __init__(self, opt):
        super().__init__(opt)
        self.preprocess = None               # the dataset's voxels as they are
        self.net_g = VoxelGenerator(self.nz, 64, opt.vox_res)
        self.net_d = VoxelDiscriminator(64, opt.vox_res)
        self.gp_lambda = float(getattr(opt, "wgangp_lambda", 10.0))
        self.gp_norm = float(getattr(opt, "wgangp_norm", 1.0))
        self.gan_d_iter = int(getattr(opt, "gan_d_iter", 1))
        self.generator = torch.Generator(device=self.device).manual_seed(
            getattr(opt, "manual_seed", None) or 0)
        self.opt_g = self.opt_d = None
        self.last_err_g = torch.zeros((), device=self.device)

    # ------------------------------------------------------------- state
    def init_state(self, seed: int = 0) -> None:
        for i, net in enumerate((self.net_g, self.net_d)):
            init_weights(net, torch.Generator().manual_seed(seed + i))
            net.to(self.device)
        self.opt_g = self.adam(self.net_g.parameters())
        self.opt_d = self.adam(self.net_d.parameters())
        self.last_err_g = torch.zeros((), device=self.device)
        self.step = 0

    @property
    def net_names(self):
        return ["net_g", "net_d"]

    @property
    def optimizer_names(self):
        return ["net_g", "net_d"]

    def net_modules(self):
        return {"net_g": self.net_g, "net_d": self.net_d}

    def optimizer_entries(self):
        return {"net_g": (self.opt_g, self.net_g),
                "net_d": (self.opt_d, self.net_d)}

    def extra_state(self) -> Dict:
        return {"last_err_g": self.last_err_g.float()}

    def load_extra_state(self, extra: Dict) -> None:
        if "last_err_g" in extra:
            self.last_err_g = torch.as_tensor(
                np.asarray(extra["last_err_g"], np.float32),
                device=self.device)

    # ------------------------------------------------------------- steps
    def draw(self, b: int) -> Tuple[torch.Tensor, ...]:
        """z1 (b, nz), alpha (b, 1, 1, 1), z2 (b, nz) from the model's
        generator, for a global batch of ``b``."""
        kw = dict(generator=self.generator, device=self.device)
        return (torch.randn((b, self.nz), **kw),
                torch.rand((b, 1, 1, 1), **kw),
                torch.randn((b, self.nz), **kw))

    def critic(self, vox: torch.Tensor) -> torch.Tensor:
        """D's scores (N,) in float32."""
        with net_autocast(vox.device, self.dtype):
            return self.net_d(vox).float()

    def generate(self, z: torch.Tensor) -> torch.Tensor:
        with net_autocast(z.device, self.dtype):
            return self.net_g(z)

    def train_step(self, batch: Dict, draws: Optional[Tuple] = None
                   ) -> Dict[str, torch.Tensor]:
        """One D update and, every ``gan_d_iter`` steps, one G update;
        ``draws``: (z1, alpha, z2) for the global batch, else drawn from
        the generator."""
        if not isinstance(next(iter(batch.values())), torch.Tensor):
            batch = self.device_batch(batch)
        real = batch["voxel_canon"]
        b = real.shape[0]
        if draws is None:
            draws = self.draw(self.global_batch(b))
        z1, alpha, z2 = (mesh.local_slice(d) for d in draws)
        self.net_g.train()
        self.net_d.train()

        with trace.span(trace.WGANGP_D):
            with torch.no_grad():
                fake = self.generate(z1).float()
            self.opt_d.zero_grad(set_to_none=False)
            d_real = self.critic(real).mean()
            d_fake = self.critic(fake).mean()
            inter = (alpha * real + (1.0 - alpha) * fake).requires_grad_(True)
            grad_x, = torch.autograd.grad(self.critic(inter).sum(), inter,
                                          create_graph=True)
            gnorm = torch.sqrt((grad_x.float().reshape(b, -1) ** 2).sum(1)
                               + 1e-16)
            gp = self.gp_lambda * ((gnorm - self.gp_norm) ** 2).mean()
            loss_d = d_fake - d_real + gp
            loss_d.backward()
            mesh.all_reduce_grads(self.net_d.parameters())
            self.opt_d.step()
        metrics = {"err_d_real": -d_real.detach(),
                   "err_d_fake": d_fake.detach(), "err_d_gp": gp.detach(),
                   "err_d": loss_d.detach()}

        if self.step % self.gan_d_iter == 0:
            # D's parameters take no gradient in G's phase
            self.net_d.requires_grad_(False)
            try:
                with trace.span(trace.WGANGP_G):
                    self.opt_g.zero_grad(set_to_none=False)
                    err_g = self.critic(self.generate(z2)).mean()
                    (-err_g).backward()
                    mesh.all_reduce_grads(self.net_g.parameters())
                    self.opt_g.step()
                    metrics["err_g"] = (-err_g).detach()
            finally:
                self.net_d.requires_grad_(True)
        self.step += 1
        metrics = mesh.all_reduce_metrics(metrics)
        self.last_err_g = metrics.pop("err_g", self.last_err_g)
        return {**metrics, "err_g": self.last_err_g,
                "loss": metrics["err_d"]}

    def global_batch(self, b: int) -> int:
        """The global batch of which a rank's batch of ``b`` is a slice."""
        return self.opt.batch_size if mesh.size(mesh.DP) > 1 else b

    def eval_step(self, batch: Dict):
        """-mean D(G(z)) as the eval loss.  G normalises with the batch's
        statistics, as in the train step, but its running statistics stay
        as they were."""
        if not isinstance(next(iter(batch.values())), torch.Tensor):
            batch = self.device_batch(batch)
        b = self.global_batch(batch["voxel_canon"].shape[0])
        z = mesh.local_slice(torch.randn(
            (b, self.nz), generator=self.generator, device=self.device))
        self.net_g.train()
        with torch.no_grad(), keep_batch_stats(self.net_g):
            gen = self.generate(z)
            disc = self.critic(gen)
        return mesh.all_reduce_metrics({"loss": -disc.mean()}), {
            "noise": z, "gen_voxel": gen, "disc": disc}

    def pack_output(self, pred, batch, add_gt: bool = True):
        return {k: as_numpy(v) for k, v in pred.items()}
