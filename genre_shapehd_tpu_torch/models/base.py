"""Model base: options, device, compute dtype, preprocessing, losses, the
optimizer and the train / eval steps (counterpart of
``genre_shapehd_tpu/models/base.py``).

A model owns its net (``self.net``, an ``nn.Module`` on ``opt.device``)
and its Adam optimizer.  ``train_step(batch)`` runs forward, loss,
backward and one Adam update and returns the batch's loss terms as
device scalars; ``eval_step(batch)`` returns them with the predictions.
Batches are the loaders' numpy dicts, channel-last.  In a group of ranks
(``parallel/mesh.py``, ``cli.train --multihost``) a batch is the rank's
slice of the global batch; the gradients are averaged over the ranks
before the update (summed over sp for :meth:`ModelBase.slab_params`)
and the returned loss terms are the global batch's.
"""

from __future__ import annotations

from contextlib import contextmanager, nullcontext
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.checkpoint import load_checkpoint
from ..core.convert import jax_to_torch
from ..core.device import resolve_device
from ..data import preprocess as pp
from ..nn import init_weights
from ..parallel import mesh
from ..utils import trace

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def default_opt(**overrides) -> SimpleNamespace:
    """Programmatic stand-in for the CLI options (the JAX package's
    ``default_opt`` for what this package reads, plus ``device``)."""
    base = dict(
        lr=1e-3, adam_beta1=0.5, adam_beta2=0.9, optim="adam", wdecay=0.0,
        batch_size=4, epoch_batches=None, eval_batches=None, epoch=0,
        logdir=None, full_logdir=None, log_time=False, log_every=1,
        manual_seed=None, im_size=256, vox_res=128, sph_res=128, z_res=256,
        padding_margin=16, dtype="float32", device="cuda",
        joint_train=False, inpaint_path=None,
        surface_weight=1.0, joint_w25d=0.01, augment=True, no_aug=False,
        canon_sup=False, canon_voxel=False, wgangp_lambda=10.0,
        wgangp_norm=1.0, gan_d_iter=1, marrnet1=None, marrnet2=None,
        gan=None, w_gan_loss=0.0, marrnet1_file=None, backbone_init=None,
        exact_render=False, decoder_width=1.0, f32_heads=False)
    base.update(overrides)
    return SimpleNamespace(**base)


def net_autocast(device: torch.device, dtype: torch.dtype):
    """Run the nets in ``dtype`` over float32 parameters -- what a Flax
    module with ``dtype=bfloat16`` does; float32 needs no context."""
    if dtype == torch.float32:
        return nullcontext()
    return torch.autocast(device.type, dtype=dtype)


def to_abs_depth(rel_depth: torch.Tensor,
                 depth_minmax: torch.Tensor) -> torch.Tensor:
    """Min-max denormalize; rel_depth (N,H,W,1), depth_minmax (N,2)."""
    dmin = depth_minmax[:, 0][:, None, None, None]
    dmax = depth_minmax[:, 1][:, None, None, None]
    return rel_depth * (dmax - dmin + 1e-4) + dmin


def masked_mse(pred: torch.Tensor, gt: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Mean over the selected elements -- torch's ``mse(a[m], b[m])``.

    In a group (``parallel/mesh.py``) the count is the global batch's
    (``mesh.all_reduce_batch``: the dp group's sum, the same on every sp
    copy) and the local sum is scaled by the dp count, so that the dp
    ranks' mean of the value, and of its gradient, is the global
    batch's."""
    mask = torch.broadcast_to(mask, pred.shape).to(pred.dtype)
    total = (mask * (pred - gt) ** 2).sum()
    count = mask.sum()
    if mesh.joined():
        total = total * mesh.size(mesh.DP)
        count = mesh.all_reduce_batch(count.detach())
    return total / torch.clamp(count, min=1.0)


def as_numpy(x) -> np.ndarray:
    """A host array: a tensor as float32 numpy (bfloat16 promoted),
    anything else as it is."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(logits, labels)


@contextmanager
def keep_batch_stats(net: torch.nn.Module):
    """A block in which ``net`` may run in train mode (BatchNorm on the
    batch's statistics) without moving its running statistics: they are
    put back at the end, as a Flax call that drops its ``batch_stats``
    update leaves them."""
    saved = {k: v.clone() for k, v in net.state_dict().items()
             if k.endswith(("running_mean", "running_var",
                            "num_batches_tracked"))}
    try:
        yield
    finally:
        net.load_state_dict(saved, strict=False)


class ModelBase:
    silhou_thres = 0.999
    pred_silhou_thres = 0.3
    scale_25d = 100.0
    rgb_jitter_d = 0.4
    rgb_light_noise = 0.1

    requires: List[str] = []
    gt_names: List[str] = []
    metrics: List[str] = ["loss"]

    @classmethod
    def add_arguments(cls, parser):
        """Register model flags; returns (parser, unique_params)."""
        return parser, set()

    def __init__(self, opt):
        self.opt = opt
        if getattr(opt, "optim", "adam") != "adam":
            raise ValueError("only --optim adam is ported")
        self.dtype = DTYPES[opt.dtype]
        self.device = resolve_device(getattr(opt, "device", "cuda"))
        self.im_size = opt.im_size
        self.augment = bool(getattr(opt, "augment", True)) \
            and not getattr(opt, "no_aug", False)
        if getattr(opt, "log_time", False):
            self.metrics = list(self.metrics) + ["batch_time", "data_time"]
        self.net: Optional[torch.nn.Module] = None
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.step = 0

    # ------------------------------------------------------------- state
    def init_state(self, seed: int = 0) -> None:
        """Seeded weights on the device and a fresh Adam."""
        init_weights(self.net, torch.Generator().manual_seed(seed))
        self.net.to(self.device)
        self.optimizer = self.adam(self.net.parameters())
        self.step = 0

    def load_weights(self, params: Dict, batch_stats: Dict) -> None:
        """Load a JAX-layout parameter tree (``core/convert.py``)."""
        self.net.load_state_dict(jax_to_torch(params, batch_stats))

    def load_subnet(self, sub: str, path: str, src_index: int = 0) -> None:
        """Load a pretrained sub-network (e.g. net1, or the whole
        depth_and_inpaint of GenRe) from a checkpoint of either package:
        the ``src_index``-th net, or its ``net`` subtree when it has one."""
        src = load_checkpoint(path)["nets"][src_index]
        params = src["params"].get("net", src["params"])
        stats = src.get("batch_stats") or {}
        stats = stats.get("net", stats)
        self.net.get_submodule(sub).load_state_dict(
            jax_to_torch(params, stats))

    def adam(self, params) -> torch.optim.Adam:
        """Adam with the options' lr and betas, weight decay added to the
        gradient (optax's ``add_decayed_weights`` before ``adam``).

        Every parameter carries a zero gradient from the start, so a step
        updates all of them, as optax does: a parameter that no loss
        reaches keeps its place only while its first moment is 0."""
        params = list(params)
        for p in params:
            p.grad = torch.zeros_like(p)
        opt = self.opt
        return torch.optim.Adam(params, lr=opt.lr,
                                betas=(opt.adam_beta1, opt.adam_beta2),
                                eps=1e-8, weight_decay=opt.wdecay)

    # ------------------------------------------------------------- steps
    def device_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """The numpy arrays of a batch as float32 tensors on the device."""
        return {k: torch.as_tensor(v, dtype=torch.float32).to(self.device)
                for k, v in batch.items() if isinstance(v, np.ndarray)}

    def forward_batch(self, batch: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def compute_loss(self, pred, batch) -> Tuple[torch.Tensor, Dict]:
        raise NotImplementedError

    def train_step(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One step on ``batch`` (numpy or device tensors): forward, loss,
        backward, Adam.  Returns the loss terms as device scalars."""
        with trace.span(trace.TRAIN_STEP):
            if not isinstance(next(iter(batch.values())), torch.Tensor):
                batch = self.device_batch(batch)
            self.net.train()
            with trace.span(trace.ZERO_GRAD):
                self.optimizer.zero_grad(set_to_none=False)
            pred = self.forward_batch(batch)
            with trace.span(trace.LOSS):
                loss, loss_data = self.compute_loss(pred, batch)
            with trace.span(trace.BACKWARD):
                loss.backward()
            mesh.all_reduce_grads((p for g in self.optimizer.param_groups
                                   for p in g["params"]), self.slab_params())
            with trace.span(trace.OPTIMIZER):
                self.optimizer.step()
            self.step += 1
            return mesh.all_reduce_metrics(
                {k: v.detach() for k, v in loss_data.items()})

    def eval_step(self, batch: Dict):
        """(loss terms, predictions) in eval mode, without gradients."""
        if not isinstance(next(iter(batch.values())), torch.Tensor):
            batch = self.device_batch(batch)
        self.net.eval()
        with torch.no_grad():
            pred = self.forward_batch(batch)
            _, loss_data = self.compute_loss(pred, batch)
        return mesh.all_reduce_metrics(loss_data), pred

    def slab_params(self) -> List[torch.nn.Parameter]:
        """Parameters whose gradient on a rank is its Z slab's share
        (``parallel/mesh.py``): none but GenRe's 3D U-Net under sp."""
        return []

    # ------------------------------------------------------- data contract
    def preprocess(self, data: Dict, mode: str = "train",
                   rng: Optional[np.random.Generator] = None) -> Dict:
        """Per-sample host transform, channel-last: rgb resized (with the
        photometric augmentation in train mode, drawn from ``rng``) and
        ImageNet-normalized; depth / silhou (H,W,1) and normal (H,W,3)
        resized and scaled by ``scale_25d``, silhou binarized at
        ``silhou_thres``."""
        aug = mode == "train" and self.augment
        if aug and rng is None:
            raise ValueError("train-mode augmentation draws from a seeded "
                             "numpy Generator: pass rng")
        out = dict(data)
        for key, val in data.items():
            if key == "rgb":
                im = pp.resize(val, self.im_size)
                if aug:
                    d = self.rgb_jitter_d
                    im = pp.jitter_colors(im, d, d, d, rng=rng)
                    im = pp.add_lighting_noise(im, self.rgb_light_noise,
                                               rng=rng)
                out[key] = pp.normalize_colors(im).astype(np.float32)
            elif key in ("depth", "silhou"):
                im = val[..., 0] if val.ndim == 3 else val
                im = pp.resize(im, self.im_size, clamp=(im.min(), im.max()))
                if key == "silhou":
                    im = pp.binarize(im, self.silhou_thres)
                out[key] = (im * self.scale_25d)[..., None].astype(np.float32)
            elif key == "normal":
                im = pp.resize(val, self.im_size,
                               clamp=(val.min(), val.max()))
                out[key] = (im * self.scale_25d).astype(np.float32)
        return out

    # ----------------------------------------------------------- output
    @staticmethod
    def mask(image, mask01, bg: float = 1.0):
        """Blend foreground and background by a [0, 1] mask."""
        return mask01 * image + (1.0 - mask01) * bg

    @classmethod
    def postprocess(cls, t, bg: float = 1.0, input_mask=None):
        """A 2.5D map back to [0, 1] (divided by ``scale_25d``), its
        background set to ``bg`` where ``input_mask`` is given."""
        scaled = t / cls.scale_25d
        if input_mask is not None:
            return cls.mask(scaled, input_mask, bg)
        return scaled

    # ------------------------------------------------------ bookkeeping
    @property
    def net_names(self) -> List[str]:
        return ["net"]

    @property
    def optimizer_names(self) -> List[str]:
        return ["net"]

    def net_modules(self) -> Dict[str, torch.nn.Module]:
        """The nets by the names a checkpoint gives them."""
        return {"net": self.net}

    def optimizer_entries(self) -> Dict[str, Tuple]:
        """(optimizer, the net it updates) by the checkpoint's names."""
        return {"net": (self.optimizer, self.net)}

    def extra_state(self) -> Dict:
        """What a checkpoint's ``extra`` carries besides nets and
        optimizers."""
        return {}

    def load_extra_state(self, extra: Dict) -> None:
        pass
