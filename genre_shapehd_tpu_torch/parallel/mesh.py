"""Data parallelism across processes (counterpart of
``genre_shapehd_tpu/parallel/mesh.py``), in plain ``torch.distributed``.

One process per card, started by ``torchrun`` (``python -m
torch.distributed.run``), each with a replica of the state and its slice
of the global batch.  The JAX package gets its batch reductions over the
global batch from XLA, which inserts them when a jitted step consumes a
batch-sharded input; here they are explicit:

- the gradients: :func:`all_reduce_grads`, a mean over the ranks, in flat
  buffers, between ``backward()`` and the optimizer's step;
- statistics that carry a gradient (BatchNorm's mean and variance):
  :func:`all_reduce_sum`, whose forward and backward both sum over the
  ranks;
- normalizers that need none (``masked_mse``'s foreground count) and the
  metrics the loggers see (:func:`all_reduce_metrics`).

A batch that the ranks do not divide is repeated uniformly to lcm(B, N),
each sample ``N / gcd(B, N)`` times (:func:`shard_slice`), as the JAX
package's ``shard_batch`` pads it: means, gradients and batch statistics
stay those of the unpadded batch.

Collectives go only through ``all_reduce`` and ``broadcast``, the two
that the gloo backend also runs on CUDA tensors.  With no group joined,
:func:`rank` is 0, :func:`world` is 1 and nothing here communicates.
"""

from __future__ import annotations

import datetime
import hashlib
import math
import os
from typing import Dict, Iterable, List

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

#: seconds a collective waits for the other ranks before it raises, so a
#: rank that died fails the others instead of hanging them
TIMEOUT_S = 600
#: the profiler span of the gradients' all-reduce
GRAD_SPAN = "dp.all_reduce_grads"
_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
#: the device the group's own small tensors live on (set by :func:`join`)
_device = torch.device("cpu")


def joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if joined() else 0


def world() -> int:
    return dist.get_world_size() if joined() else 1


def launched_world() -> int:
    """The number of processes the launcher started (``WORLD_SIZE``; 1
    without a launcher), whether or not a group is joined."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def local_rank() -> int:
    """This process's index on its host (``LOCAL_RANK``)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def join(backend: str, device: torch.device,
         timeout_s: float = TIMEOUT_S) -> None:
    """Join the process group that torchrun's environment describes
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).
    ``device`` holds this rank's tensors; NCCL needs it to be a card."""
    global _device
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"--multihost needs the launcher's environment "
                           f"(missing {missing}): start the ranks with "
                           f"python -m torch.distributed.run")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device; use "
                         "--dist_backend gloo with --device cpu")
    dist.init_process_group(backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=timeout_s))
    _device = device


def leave() -> None:
    """Destroy the group, if one is joined."""
    global _device
    if joined():
        dist.destroy_process_group()
    _device = torch.device("cpu")


def barrier() -> None:
    """Wait for every rank (an all-reduce of one element)."""
    if joined():
        dist.all_reduce(torch.zeros(1, device=_device))


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks, forward and backward: every rank's loss reaches
    every rank's input through the summed value."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, differentiably; ``x`` with no group."""
    return _AllReduceSum.apply(x) if joined() else x


def _flat_groups(tensors: List[torch.Tensor]):
    """The tensors by (device, dtype), in order."""
    groups: Dict = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    return groups.values()


def all_reduce_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Replace each gradient by its mean over the ranks: one all-reduce of
    one flat buffer per dtype.  Parameters that take no gradient
    (``requires_grad`` False, or no ``.grad``) take no part."""
    if not joined():
        return
    grads = [p.grad for p in params
             if p.requires_grad and p.grad is not None]
    with record_function(GRAD_SPAN):
        for group in _flat_groups(grads):
            flat = torch.cat([g.reshape(-1) for g in group])
            dist.all_reduce(flat)
            flat.div_(world())
            offset = 0
            for g in group:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()


def all_reduce_metrics(metrics: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """Scalar metrics averaged over the ranks (one all-reduce); as they
    are with no group.  Each rank's value is its slice's mean, the slices
    are of one size, so the average is the global batch's mean."""
    if not joined():
        return metrics
    keys = sorted(metrics)
    vec = torch.stack([metrics[k].detach().float().reshape(())
                       for k in keys])
    dist.all_reduce(vec)
    vec.div_(world())
    return dict(zip(keys, vec.unbind()))


def shard_slice(batch_size: int, num_shards: int, shard_id: int
                ) -> np.ndarray:
    """The indices into a global batch of ``batch_size`` that shard
    ``shard_id`` of ``num_shards`` holds: its contiguous slice of the
    batch, repeated first to lcm(B, N) when N does not divide B (each
    sample ``N / gcd(B, N)`` times, in place)."""
    if not 0 <= shard_id < num_shards:
        raise ValueError(f"shard {shard_id} of {num_shards}")
    reps = num_shards // math.gcd(batch_size, num_shards)
    idx = np.repeat(np.arange(batch_size), reps)
    k = len(idx) // num_shards
    return idx[shard_id * k:(shard_id + 1) * k]


def local_slice(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global-batch tensor ``x`` (all of it with no
    group)."""
    if not joined():
        return x
    idx = shard_slice(x.shape[0], world(), rank())
    return x[torch.as_tensor(idx, device=x.device)]


def broadcast_modules(modules: Iterable[torch.nn.Module]) -> None:
    """Every rank takes rank 0's parameters and buffers, so that all start
    from one state (one broadcast of a flat buffer per dtype)."""
    if not joined():
        return
    tensors = [t for m in modules for t in m.state_dict().values()]
    for group in _flat_groups(tensors):
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src=0)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def state_digest(modules: Iterable[torch.nn.Module]) -> str:
    """SHA-1 of the modules' parameters and buffers, by name, bit for bit
    (the ranks of a run must agree on it)."""
    h = hashlib.sha1()
    for i, m in enumerate(modules):
        for k, v in m.state_dict().items():
            h.update(f"{i}.{k}:{v.dtype}:{tuple(v.shape)}".encode())
            h.update(v.detach().cpu().reshape(-1).view(torch.uint8)
                     .numpy().tobytes())
    return h.hexdigest()
