"""Gradient introspection (counterpart of
``genre_shapehd_tpu/train/introspect.py``): summaries of a module's
parameter gradients that a train step can log, and a host-side ring
buffer of recent ones.

Gradients are keyed by ``named_parameters`` names, which are the JAX
package's parameter paths joined by dots (``core/convert.py``), so a
statistic here and its JAX counterpart over the gradient pytree cover
the same tensors.  A parameter without a gradient counts as zeros, as
its leaf does in the pytree.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Mapping, Tuple, Union

import torch

Grads = Union[torch.nn.Module, Mapping[str, torch.Tensor]]


def named_grads(grads: Grads) -> Dict[str, torch.Tensor]:
    """{parameter name: gradient} of a module (zeros where it has none),
    or the mapping it is given."""
    if isinstance(grads, torch.nn.Module):
        return {n: p.grad if p.grad is not None else torch.zeros_like(p)
                for n, p in grads.named_parameters()}
    return dict(grads)


def grad_stats(grads: Grads, prefix: str = "grad"
               ) -> Dict[str, torch.Tensor]:
    """Global norm, mean and root mean square of every gradient, as
    device scalars."""
    leaves = [g.float() for g in named_grads(grads).values()]
    if not leaves:
        return {}
    total = sum((g * g).sum() for g in leaves)
    count = sum(g.numel() for g in leaves)
    mean = sum(g.sum() for g in leaves) / count
    return {f"{prefix}_norm": torch.sqrt(total),
            f"{prefix}_mean": mean,
            f"{prefix}_rms": torch.sqrt(total / count)}


def per_module_grad_norms(grads: Grads, prefix: str = "grad"
                          ) -> Dict[str, torch.Tensor]:
    """Gradient norm of each top-level submodule (the first component of
    the parameter names), e.g. ``grad/depth_and_inpaint``,
    ``grad/refine_net``."""
    sums: Dict[str, torch.Tensor] = {}
    for name, g in named_grads(grads).items():
        top = name.split(".")[0]
        sq = (g.float() ** 2).sum()
        sums[top] = sums[top] + sq if top in sums else sq
    return {f"{prefix}/{k}": torch.sqrt(v) for k, v in sums.items()}


class CircularGradBuffer:
    """Host-side ring buffer of recent gradient statistics."""

    def __init__(self, maxlen: int = 100):
        self.buffer: Deque[Tuple[int, Dict[str, float]]] = deque(
            maxlen=maxlen)

    def record(self, step: int, stats: Dict) -> None:
        self.buffer.append(
            (int(step), {k: float(v) for k, v in stats.items()}))

    def latest(self):
        return self.buffer[-1] if self.buffer else None

    def summary(self) -> Dict[str, float]:
        if not self.buffer:
            return {}
        keys = self.buffer[-1][1].keys()
        n = len(self.buffer)
        return {k: sum(s[k] for _, s in self.buffer) / n for k in keys}
