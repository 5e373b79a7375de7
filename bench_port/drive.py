"""What the drivers share: the command line a cell's model is built
from, the sample of a window's answers that is checked, the numbers a
check compares, and the count of a step's operations for ``mfu``."""

from __future__ import annotations

import math
import random
import statistics
from typing import Dict, Iterable, List, Sequence

import torch

import weights

#: the configuration's sizes that the port takes as flags
SIZE_FLAGS = ("im_size", "vox_res", "sph_res", "z_res", "padding_margin")


def argv(cfg: Dict, wl: Dict, device) -> List[str]:
    """The cell's command line: its own flags, the configuration's sizes
    and dtype, the batch and the device."""
    out = list(wl["argv"])
    for key in SIZE_FLAGS:
        if key in cfg:
            out += [f"--{key}", str(cfg[key])]
    dev = f"cuda:{device.index or 0}" if device.type == "cuda" else "cpu"
    return out + ["--dtype", cfg["dtype"], "--batch_size", str(wl["batch"]),
                  "--device", dev]


def genre_sizes(cfg: Dict) -> Dict[str, int]:
    """GenRe's sizes as the reference's ``models.genre`` takes them."""
    return dict(vox_res=cfg["vox_res"], sph_res=cfg["sph_res"],
                z_res=cfg["z_res"], margin=cfg["padding_margin"])


def sample(seed: int, wl: Dict) -> List[int]:
    """The window's iterations whose answers are checked, drawn from the
    seed among its first ``sample_from``."""
    rng = random.Random(weights.stream(seed, "sample"))
    return sorted(rng.sample(range(wl["sample_from"]), wl["sample_batches"]))


class RelErr:
    """Relative L2 error per output, summed over the checked batches:
    ||program - reference|| / ||reference|| (or / ||scale||)."""

    def __init__(self):
        self.num: Dict[str, float] = {}
        self.den: Dict[str, float] = {}

    def add(self, key: str, got: torch.Tensor, ref: torch.Tensor,
            scale: torch.Tensor = None) -> None:
        """``scale``: the yardstick in place of the reference's values,
        where those can cancel to near 0."""
        got = got.to(ref.device).float().reshape(ref.shape)
        scale = ref if scale is None else scale
        self.num[key] = self.num.get(key, 0.0) + float(
            ((got - ref.float()) ** 2).sum())
        self.den[key] = self.den.get(key, 0.0) + float(
            (scale.float() ** 2).sum())

    def numbers(self) -> Dict[str, float]:
        return {k: math.sqrt(self.num[k] / max(self.den[k], 1e-30))
                for k in self.num}


def loss_gap(got: Sequence[Dict[str, float]],
             ref: Sequence[Dict[str, float]]) -> float:
    """Worst gap of a loss term over the steps compared, against the
    reference's term."""
    worst = 0.0
    for g, r in zip(got, ref):
        for k in r:
            worst = max(worst, abs(g[k] - r[k]) / max(abs(r[k]), 1e-30))
    return worst


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float],
              keys: Iterable[str]) -> List[float]:
    """Each leaf's gap between the program's norm and the reference's,
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    keys = list(keys)
    med = statistics.median(ref[k] for k in keys)
    return [abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]


def moving(grad_ref: Dict[str, float]) -> List[str]:
    """Leaves whose first gradient in the reference is at least a
    thousandth of the median leaf's: the others move under Adam by
    round-off alone and are left out of the change."""
    med = statistics.median(grad_ref.values())
    return [k for k, v in grad_ref.items() if v >= 1e-3 * med]


def train_numbers(got, ref) -> Dict[str, float]:
    """(losses, first gradients' norms, changes' norms) of the program
    and the reference -> the numbers a training cell compares: the worst
    loss term's gap over the steps, and the worst leaf's gap of the first
    gradient and of the change (of the leaves that move)."""
    (gl, gg, gc), (rl, rg, rc) = got, ref
    return {"loss_gap": loss_gap(gl, rl),
            "grad_gap": max(leaf_gaps(gg, rg, rg)),
            "change_gap": max(leaf_gaps(gc, rc, moving(rg)))}


def count_flops(fn) -> int:
    """Operations of ``fn()`` by ``torch.utils.flop_counter``."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def first_gradients(optimizer, named, b1: float, prefix: str = ""
                    ) -> Dict[str, float]:
    """Each parameter's first gradient norm as Adam holds it after one
    step: its first moment over (1 - b1); 0 where Adam holds none."""
    out = {}
    for name, p in named:
        state = optimizer.state.get(p, {})
        m = state.get("exp_avg")
        out[prefix + name] = 0.0 if m is None else float(m.norm()) / (1 - b1)
    return out



class HostSink:
    """Where a window's answers land in host memory: page-locked buffers
    made at set-up, as an offline pipeline keeps them, so that no batch
    pays for faulting in fresh host pages.  Two take turns; each answer
    that the check keeps gets one of its own."""

    def __init__(self, shape, dtype, keep: int, device):
        pin = device.type == "cuda"
        make = lambda: torch.empty(shape, dtype=dtype,  # noqa: E731
                                   pin_memory=pin)
        self.ring = [make(), make()]
        self.spare = [make() for _ in range(keep)]

    def take(self, x: torch.Tensor, i: int, keep: bool) -> torch.Tensor:
        """``x`` copied into host memory; returns when it is there."""
        dst = self.spare.pop() if keep else self.ring[i % 2]
        dst.copy_(x)
        return dst
