"""The reference's precisions: float32 as the configurations state it
(TF32 off), and the control's, one step below the configurations'
bfloat16: fp8 (e4m3), each tensor scaled by its largest magnitude onto
the format's range, as an fp8 path scales it."""

from __future__ import annotations

from contextlib import contextmanager

import torch


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def _round(x: torch.Tensor, fmt: torch.dtype) -> torch.Tensor:
    top = torch.finfo(fmt).max
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / top
    return ((x.float() / scale).to(fmt).float() * scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    """Values rounded to e4m3, gradients to e5m2, each tensor under its
    own scale, as fp8 training rounds them; differentiable twice (the
    gradient penalty's double backward)."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.fmts = (fwd, bwd)
        return _round(x, fwd)

    @staticmethod
    def backward(ctx, g):
        fwd, bwd = ctx.fmts
        return _Fp8.apply(g, bwd, fwd), None, None


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x in fp8 (e4m3; its gradient in e5m2)."""
    if not x.is_floating_point():
        return x
    return _Fp8.apply(x, torch.float8_e4m3fn, torch.float8_e5m2)


@contextmanager
def float32_math():
    """TF32 off for convolutions and matrix products inside the block."""
    was = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = was
