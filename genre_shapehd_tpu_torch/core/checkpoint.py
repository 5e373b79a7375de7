"""Checkpoints in the JAX package's format: a pickle of numpy trees,
  {'nets': [{'params': ..., 'batch_stats': ...}, ...],
   'optimizers': [...], 'epoch': int, 'loss_eval': float, ...}.

The JAX package pickles its optimizer states as optax objects, so a plain
``pickle.load`` would import optax (and JAX).  :func:`load_checkpoint`
unpickles with a restricted ``Unpickler``: numpy and a few builtins load
as themselves, any other class becomes an inert stand-in.  Only ``nets``
is read.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Tuple

_SAFE_BUILTINS = {"dict", "list", "tuple", "set", "frozenset", "int",
                  "float", "complex", "bool", "str", "bytes", "bytearray",
                  "slice", "range"}


class _Inert:
    """Stand-in for a pickled object of a class this package does not
    load; keeps whatever the pickle hands it."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        self.args = args

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
