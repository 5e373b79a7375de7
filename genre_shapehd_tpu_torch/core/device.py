"""Device selection: the port runs on CUDA unless asked for the CPU."""

from __future__ import annotations

from typing import Optional

import torch


def device_name(name: str) -> str:
    """An argparse type: ``cpu``, ``cuda`` or ``cuda:N``."""
    dev = torch.device(name)
    if dev.type not in ("cuda", "cpu") or (dev.type == "cpu"
                                           and dev.index is not None):
        raise ValueError(f"unsupported device {name!r}: cpu, cuda or "
                         f"cuda:N")
    return name


def resolve_device(name: str = "cuda",
                   local_rank: Optional[int] = None) -> torch.device:
    """``torch.device(name)``; raises when CUDA, or a card, is asked for
    and absent rather than carrying on somewhere else.  ``local_rank``
    (one process per card): ``cuda`` means ``cuda:<local_rank>``, while
    ``cuda:N`` pins the process to card N whatever its rank."""
    dev = torch.device(device_name(name))
    if dev.type == "cpu":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but torch.cuda is not "
                           f"available; pass --device cpu to run on the CPU")
    if dev.index is None and local_rank is not None:
        dev = torch.device("cuda", local_rank)
    if dev.index is not None and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"device {dev} requested, but this host has "
                           f"{torch.cuda.device_count()} CUDA device(s)")
    return dev
