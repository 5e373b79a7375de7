"""Data and spatial parallelism across processes (counterpart of
``genre_shapehd_tpu/parallel/mesh.py``), in plain ``torch.distributed``.

One process per card, started by ``torchrun`` (``python -m
torch.distributed.run``).  The ranks form a (dp, sp) grid in row-major
order, as ``make_mesh_2d`` lays out the JAX package's devices: rank r is
dp index ``r // sp`` and sp index ``r % sp`` (``cli.train --sp``; sp 1
without it).

- **dp**: the ranks of one sp index, each with its slice of the global
  batch (:func:`shard_slice` by dp index over the dp count).
- **sp**: the ranks of one dp index.  They load the same slice and run
  the same computation, except GenRe's 3D U-Net, which each runs on its
  slab of the voxel grid's Z axis (``nn/unet3d.py``): :func:`z_slab`
  cuts the slab, :func:`halo` fetches the planes a convolution reaches
  from the neighbours, :func:`gather_z` assembles the whole Z extent.

The JAX package gets the reductions over the global batch, and the
halos, from XLA, which inserts them when a jitted step consumes a sharded
input; here they are explicit, each over a named group (:data:`DP`,
:data:`SP`, :data:`WORLD`):

- the gradients: :func:`all_reduce_grads`, one sum over the world in flat
  buffers, between ``backward()`` and the optimizer's step, divided by
  the world for a parameter whose gradient every sp rank holds whole
  (the sp ranks' copies agree, so this is the dp group's mean), by the
  dp count for one whose gradient is its Z slab's share (the U-Net's
  under sp: summed over sp, then averaged over dp);
- statistics that carry a gradient (BatchNorm's mean and variance):
  :func:`all_reduce_sum`, whose forward and backward both sum over its
  group (the world, for a layer that runs on Z slabs), and
  :func:`all_reduce_batch`, the global batch's sum where the sp ranks
  hold copies of the same rows: the world's sum divided by sp, forward
  and backward, so that each sample counts once and every copy gets the
  same bits;
- normalizers that need none (``masked_mse``'s foreground count, by
  :func:`all_reduce_batch`) and the metrics the loggers see
  (:func:`all_reduce_metrics`, the world's mean).

The sp groups are the only process groups made besides the world: a sum
over the dp group is the world's sum over sp (:func:`all_reduce_batch`),
and :func:`size` and :func:`index` of either group are arithmetic.

A batch that the dp ranks do not divide is repeated uniformly to lcm(B,
N), each sample ``N / gcd(B, N)`` times (:func:`shard_slice`), as the JAX
package's ``shard_batch`` pads it: means, gradients and batch statistics
stay those of the unpadded batch.

Collectives go only through ``all_reduce`` and ``broadcast``, the two
that the gloo backend also runs on CUDA tensors: a halo or a gather is an
all-reduce of a zero buffer in which each rank fills its own part (one
contributor an element, so the sum is exact).  With no group joined,
:func:`rank` is 0, :func:`world` is 1 and nothing here communicates.
"""

from __future__ import annotations

import contextlib
import datetime
import hashlib
import math
import os
from typing import Dict, Iterable, List

import numpy as np
import torch
import torch.distributed as dist

from ..utils import trace

#: seconds a collective waits for the other ranks before it raises, so a
#: rank that died fails the others instead of hanging them
TIMEOUT_S = 600
#: the groups a collective runs over
DP, SP, WORLD = "dp", "sp", "world"
_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
#: the device the group's own small tensors live on (set by :func:`join`)
_device = torch.device("cpu")
#: ranks per dp index (set by :func:`join`)
_sp = 1
#: this rank's sp process group where it is neither the world nor a
#: single rank
_groups: Dict[str, object] = {}


def joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if joined() else 0


def world() -> int:
    return dist.get_world_size() if joined() else 1


def size(group: str) -> int:
    """The number of ranks in this rank's ``group``."""
    return {WORLD: world(), DP: world() // _sp, SP: _sp}[group]


def index(group: str) -> int:
    """This rank's index in its ``group``: its dp index within the sp
    group, its sp index within the dp group."""
    return {WORLD: rank(), DP: rank() // _sp, SP: rank() % _sp}[group]


def launched_world() -> int:
    """The number of processes the launcher started (``WORLD_SIZE``; 1
    without a launcher), whether or not a group is joined."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def local_rank() -> int:
    """This process's index on its host (``LOCAL_RANK``)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def join(backend: str, device: torch.device,
         timeout_s: float = TIMEOUT_S, sp: int = 1) -> None:
    """Join the process group that torchrun's environment describes
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), laid out
    as (world / sp, sp).  ``device`` holds this rank's tensors; NCCL
    needs it to be a card."""
    global _device
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"--multihost needs the launcher's environment "
                           f"(missing {missing}): start the ranks with "
                           f"python -m torch.distributed.run")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device; use "
                         "--dist_backend gloo with --device cpu")
    n = launched_world()
    if sp < 1 or n % sp:
        raise ValueError(f"--sp {sp} does not divide the {n} ranks")
    dist.init_process_group(backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=timeout_s))
    _device = device
    _make_groups(sp)


def _make_groups(sp: int) -> None:
    """The sp groups, the rows of the grid.  Every rank creates every
    group, in one order, as ``new_group`` requires; a group of one rank or
    of the world is not made."""
    global _sp
    n = world()
    _sp = sp
    _groups.clear()
    if 1 < sp < n:
        for d in range(n // sp):
            ranks = list(range(d * sp, (d + 1) * sp))
            g = dist.new_group(ranks)
            if rank() in ranks:
                _groups[SP] = g


def leave() -> None:
    """Destroy the group, if one is joined."""
    global _device, _sp
    if joined():
        dist.destroy_process_group()
    _device = torch.device("cpu")
    _sp = 1
    _groups.clear()


def _pg(group: str):
    """The process group of ``group``, :data:`SP` or :data:`WORLD`, for
    ``torch.distributed`` (None: the world)."""
    if group not in (SP, WORLD):
        raise ValueError(f"no process group is made for {group!r}; a sum "
                         f"over dp is all_reduce_batch")
    return None if size(group) == world() else _groups[SP]


def barrier() -> None:
    """Wait for every rank (an all-reduce of one element)."""
    if joined():
        dist.all_reduce(torch.zeros(1, device=_device))


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group times ``scale``, forward and backward: every
    rank's loss reaches every rank's input through the summed value."""

    @staticmethod
    def forward(ctx, x, group, scale):
        ctx.group, ctx.scale = group, scale
        y = x.clone()
        dist.all_reduce(y, group=_pg(group))
        return y.mul_(scale) if scale != 1.0 else y

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group, ctx.scale), None, None


def all_reduce_sum(x: torch.Tensor, group: str) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (:data:`SP` or
    :data:`WORLD`), differentiably; ``x`` where the group is this rank
    alone."""
    return _AllReduceSum.apply(x, group, 1.0) if size(group) > 1 else x


def all_reduce_batch(x: torch.Tensor) -> torch.Tensor:
    """The global batch's sum of ``x``, a sum over this rank's rows, where
    the sp ranks of a dp index hold copies of the same rows: the world's
    sum divided by sp, differentiably (the backward too is the world's
    sum over sp).  Equal to the dp group's sum, but the same bits on
    every copy, also where a copy's value differs from another's by
    rounding."""
    if world() == 1:
        return x
    return _AllReduceSum.apply(x, WORLD, 1.0 / _sp)


def _flat_groups(tensors: List[torch.Tensor]):
    """The tensors by (device, dtype), in order."""
    groups: Dict = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    return groups.values()


def all_reduce_grads(params: Iterable[torch.nn.Parameter],
                     slab_params: Iterable[torch.nn.Parameter] = ()
                     ) -> None:
    """Replace each gradient by its global value: one sum over the world
    of one flat buffer per dtype, divided by the world (the dp group's
    mean: the sp ranks' copies of a gradient agree), or by the dp count
    for ``slab_params``, whose gradient on a rank is its Z slab's share
    (summed over sp, averaged over dp).  Parameters that take no
    gradient (``requires_grad`` False, or no ``.grad``) take no part."""
    if not joined():
        return
    slab = {id(p) for p in slab_params}
    params = [p for p in params if p.requires_grad and p.grad is not None]
    with trace.span(trace.GRAD_ALL_REDUCE):
        for group in _flat_groups([p.grad for p in params]):
            flat = torch.cat([g.reshape(-1) for g in group])
            dist.all_reduce(flat)
            offset = 0
            for g in group:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()
        for p in params:
            p.grad.div_(size(DP) if id(p) in slab else world())


def all_reduce_metrics(metrics: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """Scalar metrics averaged over the world (one all-reduce); as they
    are with no group.  Each rank's value is its slice's mean, the slices
    are of one size and the sp ranks' copies agree, so the average is the
    global batch's mean, the same bits on every rank."""
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
    """This rank's rows of a global-batch tensor ``x``: its dp index's
    slice (all of it with no group)."""
    if size(DP) == 1:
        return x
    idx = shard_slice(x.shape[0], size(DP), index(DP))
    return x[torch.as_tensor(idx, device=x.device)]


# ------------------------------------------------ spatial: Z slabs of sp
def _exchange(buf: torch.Tensor) -> torch.Tensor:
    """``buf`` summed over the sp group, in float32 for a 16-bit type
    (which gloo may not sum); exact where each element has one rank that
    fills it and zeros elsewhere (the halos and gathers)."""
    wide = buf.float() if buf.element_size() < 4 else buf
    dist.all_reduce(wide, group=_pg(SP))
    return wide.to(buf.dtype) if wide is not buf else buf


def _planes(x: torch.Tensor, dim: int, z: int) -> torch.Tensor:
    """Zeros of ``x``'s shape with ``z`` entries along ``dim``."""
    shape = list(x.shape)
    shape[dim] = z
    return x.new_zeros(shape)


class _Halo(torch.autograd.Function):
    """This rank's Z slab (the last dim) with ``lo`` planes of the sp
    group's previous rank before it and ``hi`` planes of the next one
    after it, zeros at the volume's ends (where one process pads), then
    zero planes up to a multiple of ``align``.  The backward sends each
    halo plane's gradient back to the rank that owns the plane."""

    @staticmethod
    def forward(ctx, x, lo, hi, align):
        s, n, zs = index(SP), size(SP), x.shape[-1]
        ctx.lo, ctx.hi, ctx.zs = lo, hi, zs
        with trace.span(trace.SP_HALO):
            buf = x.new_zeros(x.shape[:-1] + (n, lo + hi))
            buf[..., s, :lo] = x[..., zs - lo:]
            buf[..., s, lo:] = x[..., :hi]
            buf = _exchange(buf)
            before = buf[..., s - 1, :lo] if s > 0 \
                else _planes(x, -1, lo)
            after = buf[..., s + 1, lo:] if s < n - 1 \
                else _planes(x, -1, hi)
            pad = -(lo + zs + hi) % align
            return torch.cat([before, x, after, _planes(x, -1, pad)], -1)

    @staticmethod
    def backward(ctx, grad):
        lo, hi, zs = ctx.lo, ctx.hi, ctx.zs
        s, n = index(SP), size(SP)
        with trace.span(trace.SP_HALO):
            # the align planes after the halo belong to no rank
            gx = grad[..., lo:lo + zs].clone()
            buf = grad.new_zeros(grad.shape[:-1] + (n, lo + hi))
            if s > 0:           # the previous rank's last lo planes
                buf[..., s - 1, :lo] = grad[..., :lo]
            if s < n - 1:       # the next rank's first hi planes
                buf[..., s + 1, lo:] = grad[..., lo + zs:lo + zs + hi]
            buf = _exchange(buf)
            gx[..., zs - lo:] += buf[..., s, :lo]
            gx[..., :hi] += buf[..., s, lo:]
        return gx, None, None, None


def halo(x: torch.Tensor, lo: int, hi: int, align: int = 1
         ) -> torch.Tensor:
    """``x`` (..., Zs), this rank's Z slab, widened by ``lo`` planes of
    the previous sp rank and ``hi`` of the next (zeros at the volume's
    ends) and zero planes up to a multiple of ``align``, differentiably
    (``sp.halo`` span).  A halo reaches one neighbour only."""
    zs = x.shape[-1]
    if max(lo, hi) > zs:
        raise ValueError(f"a halo of {max(lo, hi)} planes needs slabs of "
                         f"as many; this one has {zs}: use a smaller --sp")
    if size(SP) == 1:
        # one slab is the volume: zero planes at both ends
        pad = -(lo + zs + hi) % align
        return torch.nn.functional.pad(x, (lo, hi + pad))
    return _Halo.apply(x, lo, hi, align)


class _GatherZ(torch.autograd.Function):
    """The sp group's slabs along ``dim``, in sp order.  Backward
    ``"slab"``: this rank's slab of the gradient, where every rank's
    gradient is whole (a loss that each computes on the whole volume);
    ``"sum"``: its slab of the gradients' sum over the sp group, where
    each rank's is its own share."""

    @staticmethod
    def forward(ctx, x, dim, grad_mode):
        ctx.dim, ctx.mode, ctx.zs = dim, grad_mode, x.shape[dim]
        with trace.span(trace.SP_GATHER):
            buf = _planes(x, dim, x.shape[dim] * size(SP))
            buf.narrow(dim, index(SP) * ctx.zs, ctx.zs).copy_(x)
            return _exchange(buf)

    @staticmethod
    def backward(ctx, grad):
        if ctx.mode == "sum":
            with trace.span(trace.SP_GATHER):
                grad = _exchange(grad.clone())
        return (grad.narrow(ctx.dim, index(SP) * ctx.zs, ctx.zs)
                .contiguous(), None, None)


def gather_z(x: torch.Tensor, dim: int, grad: str) -> torch.Tensor:
    """The whole Z extent of the sp group's slabs ``x`` along ``dim``,
    differentiably (``sp.gather`` span); ``grad`` as :class:`_GatherZ`
    takes it."""
    if size(SP) == 1:
        return x
    return _GatherZ.apply(x, dim, grad)


class _ZSlab(torch.autograd.Function):
    """This rank's slab along ``dim`` of a tensor that every sp rank
    holds whole.  Backward ``"gather"``: the sp group's slab gradients
    assembled, so every rank's copy of the whole receives the whole
    gradient; ``"local"``: this rank's share alone, zeros elsewhere."""

    @staticmethod
    def forward(ctx, x, dim, grad_mode):
        ctx.dim, ctx.mode, ctx.z = dim, grad_mode, x.shape[dim]
        zs = ctx.z // size(SP)
        return x.narrow(dim, index(SP) * zs, zs).clone()

    @staticmethod
    def backward(ctx, grad):
        zs = grad.shape[ctx.dim]
        with trace.span(trace.SP_GATHER) if ctx.mode == "gather" \
                else contextlib.nullcontext():
            full = _planes(grad, ctx.dim, ctx.z)
            full.narrow(ctx.dim, index(SP) * zs, zs).copy_(grad)
            if ctx.mode == "gather":
                full = _exchange(full)
        return full, None, None


def z_slab(x: torch.Tensor, dim: int, grad: str) -> torch.Tensor:
    """This rank's slab of ``x`` along ``dim`` (``x.shape[dim] / sp``
    planes, in sp order), differentiably; ``grad`` as :class:`_ZSlab`
    takes it."""
    if size(SP) == 1:
        return x
    if x.shape[dim] % size(SP):
        raise ValueError(f"--sp {size(SP)} does not divide the "
                         f"{x.shape[dim]} planes of {tuple(x.shape)}")
    return _ZSlab.apply(x, dim, grad)


# ------------------------------------------------------------ state
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
