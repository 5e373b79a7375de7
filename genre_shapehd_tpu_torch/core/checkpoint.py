"""Checkpoints in the JAX package's format: a pickle of numpy trees,
  {'nets': [{'params': ..., 'batch_stats': ...}, ...],
   'optimizers': [...], 'epoch': int, 'loss_eval': float, ...},
and the resume policy of the JAX package's ``core/checkpoint.py``.

The JAX package pickles its optimizer states as optax objects, so a plain
``pickle.load`` would import optax (and JAX).  :func:`load_checkpoint`
unpickles with a restricted ``Unpickler``: numpy and a few builtins load
as themselves, any other class becomes an inert stand-in that keeps the
arguments and state the pickle hands it: optax's ``ScaleByAdamState``
(a NamedTuple, pickled by NEWOBJ) keeps ``(count, mu, nu)`` in ``args``,
which ``train/state.py::adam_moments`` reads.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional, Tuple

_SAFE_BUILTINS = {"dict", "list", "tuple", "set", "frozenset", "int",
                  "float", "complex", "bool", "str", "bytes", "bytearray",
                  "slice", "range"}


class _Inert:
    """Stand-in for a pickled object of a class this package does not
    load; keeps whatever the pickle hands it.  NEWOBJ calls ``__new__``
    alone (never ``__init__``), so the arguments are kept there."""

    def __new__(cls, *args, **kwargs):
        obj = object.__new__(cls)
        obj.args, obj.kwargs = args, kwargs
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state


class _RestrictedUnpickler(pickle.Unpickler):
    _stand_ins: Dict[Tuple[str, str], type] = {}

    def find_class(self, module: str, name: str):
        if module == "numpy" or module.startswith("numpy."):
            return super().find_class(module, name)
        if module == "builtins" and name in _SAFE_BUILTINS:
            return super().find_class(module, name)
        if module == "collections" and name == "OrderedDict":
            return super().find_class(module, name)
        key = (module, name)
        if key not in self._stand_ins:
            self._stand_ins[key] = type(name, (_Inert,),
                                        {"__module__": "inert." + module})
        return self._stand_ins[key]


def load_checkpoint(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return _RestrictedUnpickler(f).load()


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    """Write ``payload`` (numpy trees only) atomically."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def load_net(path: str, index: int = 0) -> Tuple[Dict, Dict]:
    """(params, batch_stats) of the ``index``-th net of a checkpoint."""
    net = load_checkpoint(path)["nets"][index]
    return net["params"], net.get("batch_stats") or {}


def net_payload(params: Dict, batch_stats: Dict) -> Dict[str, Any]:
    """A one-net checkpoint payload with no optimizer state."""
    return {"nets": [{"params": params, "batch_stats": batch_stats}],
            "optimizers": [], "epoch": 0, "loss_eval": 0.0,
            "net_names": ["net"], "opt_names": []}


def resume_path(logdir: str, resume: int) -> Optional[str]:
    """0: from scratch (None); -1: ``checkpoint.pt``; -2: ``best.pt``;
    N > 0: ``nets/N.pt`` (4 digits)."""
    if resume == 0:
        return None
    if resume == -1:
        return os.path.join(logdir, "checkpoint.pt")
    if resume == -2:
        return os.path.join(logdir, "best.pt")
    if resume > 0:
        return os.path.join(logdir, "nets", f"{resume:04d}.pt")
    raise ValueError(f"invalid resume value {resume}")
