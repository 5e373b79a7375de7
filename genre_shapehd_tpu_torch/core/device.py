"""Device selection: the port runs on CUDA unless asked for the CPU."""

from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """``torch.device(name)``; raises when CUDA is asked for and absent
    rather than carrying on somewhere else."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda is not "
                           "available; pass --device cpu to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return dev
