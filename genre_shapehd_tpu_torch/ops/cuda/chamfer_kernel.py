"""Nearest-neighbour (Chamfer) distances as one CUDA kernel, its plain
version and launch count (counterpart of
``genre_shapehd_tpu/ops/pallas/chamfer_kernel.py``).

  K4 ``nn_min_dist`` (csrc/chamfer_kernel.cu) replaces the Pallas
     ``_min_dist_kernel``: x1 (B, N, 3), x2 (B, M, 3) float32 -> least
     squared distance and its index for every point of both clouds, any N
     and M, both directions in one launch.

:func:`nn_min_dist` launches the kernel on CUDA tensors and runs the plain
version (:func:`nn_min_dist_plain`, the expansion ``x² + y² - 2xy`` with
block-wise min / argmin, the arithmetic of the JAX package's
``ops.chamfer.nndistance_w_idx``) on CPU tensors.  A CUDA tensor either
launches the kernel or raises.

The kernel splits the other cloud over a group of lanes per 4 query
points; its entry point sizes the group from the clouds so that the grid
fills the card (32 lanes at the scoring path's 1 x 1024 x 1024, 4 at 8 x
8192 x 8192), and :func:`plan` reports that choice.

The kernel returns the indices, so the gradient (the JAX package's
``_bwd``: ``2 (x - x_nn) g`` gathered and scattered) needs no second pass.
The kernel gives ties to the lowest index; the plain version may pick
another index where two distances tie, so compare distances, and indices
through the distances they give.
"""

from __future__ import annotations

import ctypes
from contextlib import contextmanager
from typing import Dict, Tuple

import torch

from . import build

SOURCE = "chamfer_kernel.cu"

#: launches of the kernel since the last :func:`reset_launches`; one
#: launch serves both directions, so one per ``nndistance*`` call
launches: Dict[str, int] = {"nn_min_dist": 0}

_lib = None

def plan(b: int, n: int, m: int) -> Dict[str, int]:
    """The lanes per group of 4 query points and the blocks that the
    kernel's launch uses for clouds (b, n, 3), (b, m, 3), as its entry
    point chooses them (the card's build only)."""
    group, blocks = ctypes.c_int(), ctypes.c_int()
    _library().nn_min_dist_plan(b, n, m, ctypes.byref(group),
                                ctypes.byref(blocks))
    return {"group": group.value, "blocks": blocks.value}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ------------------------------------------------------------ plain version
@contextmanager
def _full_float32_matmul():
    """TF32 off for the enclosed products whatever the global switch says:
    the expansion's cancellation loses ~1e-1 at reduced precision."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def _pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(B, P1, 3), (B, P2, 3) -> (B, P1, P2) squared distances."""
    x2 = (x * x).sum(-1, keepdim=True)
    y2 = (y * y).sum(-1, keepdim=True)
    with _full_float32_matmul():
        xy = torch.einsum("bpd,bqd->bpq", x, y)
    return torch.clamp(x2 + y2.transpose(1, 2) - 2.0 * xy, min=0.0)


def nn_min_dist_plain(x1: torch.Tensor, x2: torch.Tensor, block: int = 4096
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """(d1 (B,N), d2 (B,M), i1 int32, i2 int32); ``block`` bounds the
    (N, block) temporary.  Differentiable through the minima."""
    x1, x2 = x1.float(), x2.float()
    p2 = x2.shape[1]
    if max(x1.shape[1], p2) <= block:
        d = _pairwise_sqdist(x1, x2)
        d1, i1 = d.min(dim=2)
        d2, i2 = d.min(dim=1)
        return d1, d2, i1.int(), i2.int()
    best1 = x1.new_full(x1.shape[:2], float("inf"))
    idx1 = torch.zeros(x1.shape[:2], dtype=torch.int64, device=x1.device)
    d2s, i2s = [], []
    for off in range(0, p2, block):
        d = _pairwise_sqdist(x1, x2[:, off:off + block])
        blk_min, blk_arg = d.min(dim=2)
        upd = blk_min < best1
        best1 = torch.where(upd, blk_min, best1)
        idx1 = torch.where(upd, blk_arg + off, idx1)
        d2b, i2b = d.min(dim=1)
        d2s.append(d2b)
        i2s.append(i2b)
    return best1, torch.cat(d2s, 1), idx1.int(), torch.cat(i2s, 1).int()


# ------------------------------------------------------------------ kernel
def _library():
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nn_min_dist.argtypes = [p, p, p, p, p, p, i, i, i, p]
        lib.nn_min_dist.restype = i
        lib.nn_min_dist_plan.argtypes = [i, i, i, ctypes.POINTER(i),
                                         ctypes.POINTER(i)]
        lib.nn_min_dist_plan.restype = None
        _lib = lib
    return _lib


def _launch(x1: torch.Tensor, x2: torch.Tensor):
    b, n, m = x1.shape[0], x1.shape[1], x2.shape[1]
    dev = x1.device
    d1 = torch.empty((b, n), dtype=torch.float32, device=dev)
    d2 = torch.empty((b, m), dtype=torch.float32, device=dev)
    i1 = torch.empty((b, n), dtype=torch.int32, device=dev)
    i2 = torch.empty((b, m), dtype=torch.int32, device=dev)
    lib = _library()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())          # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.nn_min_dist(ptr(x1), ptr(x2), ptr(d1), ptr(i1), ptr(d2),
                              ptr(i2), b, n, m, ctypes.c_void_p(stream))
        launches["nn_min_dist"] += 1
    if err != 0:
        raise RuntimeError(f"nn_min_dist: CUDA error {err} at launch")
    return d1, d2, i1, i2


def _scatter_grad(x: torch.Tensor, y: torch.Tensor, idx: torch.Tensor,
                  g: torch.Tensor):
    """Gradients of sum_i g_i |x_i - y_idx(i)|² with respect to x and y."""
    index = idx.long()[..., None].expand(-1, -1, 3)
    dx = 2.0 * (x - torch.gather(y, 1, index)) * g[..., None]
    dy = torch.zeros_like(y).scatter_add_(1, index, -dx)
    return dx, dy


class _NNMinDist(torch.autograd.Function):
    """Forward: K4.  Backward: gather / scatter-add on the saved indices."""

    @staticmethod
    def forward(ctx, x1, x2):
        d1, d2, i1, i2 = _launch(x1, x2)
        ctx.save_for_backward(x1, x2, i1, i2)
        ctx.mark_non_differentiable(i1, i2)
        return d1, d2, i1, i2

    @staticmethod
    def backward(ctx, g1, g2, _gi1, _gi2):
        x1, x2, i1, i2 = ctx.saved_tensors
        dx1, dx2 = _scatter_grad(x1, x2, i1, g1)
        ex2, ex1 = _scatter_grad(x2, x1, i2, g2)
        return dx1 + ex1, dx2 + ex2


def nn_min_dist(x1: torch.Tensor, x2: torch.Tensor, block: int = 4096
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """x1 (B, N, 3), x2 (B, M, 3) -> (d1 (B,N), d2 (B,M), i1, i2 int32):
    K4 on CUDA tensors, the plain version (which alone reads ``block``)
    on CPU tensors."""
    if x1.dim() != 3 or x2.dim() != 3 or x1.shape[2] != 3 \
            or x2.shape[2] != 3 or x1.shape[0] != x2.shape[0]:
        raise ValueError(f"nn_min_dist: expected (B, N, 3) and (B, M, 3), "
                         f"got {tuple(x1.shape)} and {tuple(x2.shape)}")
    if x1.shape[1] < 1 or x2.shape[1] < 1 or x1.shape[0] < 1:
        raise ValueError("nn_min_dist: empty point cloud")
    if x1.device.type == "cpu" and x2.device.type == "cpu":
        return nn_min_dist_plain(x1, x2, block)
    if x1.device.type != "cuda" or x2.device != x1.device:
        raise RuntimeError(
            f"nn_min_dist: clouds on {x1.device} and {x2.device}; the kernel "
            "runs on one CUDA device and its plain version on the CPU only")
    return _NNMinDist.apply(x1.float().contiguous(), x2.float().contiguous())
