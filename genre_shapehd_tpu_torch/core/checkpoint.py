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

:func:`save_checkpoint` writes the other way round: a :class:`Foreign`
tuple pickles as the NamedTuple of another package that its class names
by ``pickle_as = (module, qualname)``, without importing that package, so
that the JAX package unpickles optax's own state classes from a checkpoint
the port wrote.
"""

from __future__ import annotations

import copyreg
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


class Foreign(tuple):
    """A NamedTuple of another package, written by reference: a subclass
    sets ``pickle_as = (module, qualname)`` and its instances pickle as
    ``qualname.__new__(cls, *fields)`` (NEWOBJ, as a NamedTuple pickles),
    so the class is imported only where the pickle is loaded."""

    pickle_as: Tuple[str, str] = ("", "")

    def __new__(cls, *fields):
        return super().__new__(cls, fields)

    def __reduce_ex__(self, protocol):
        return copyreg.__newobj__, (type(self), *self)


class _Pickler(pickle._Pickler):
    """The pure-Python pickler with one change: a :class:`Foreign` class is
    written as the global its ``pickle_as`` names.  (The C pickler imports
    a class's module to check the reference, which would need the other
    package here.)"""

    def save_global(self, obj, name=None):
        if not (isinstance(obj, type) and issubclass(obj, Foreign)):
            return super().save_global(obj, name)
        module, qualname = obj.pickle_as
        self.save(module)
        self.save(qualname)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def load_checkpoint(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return _RestrictedUnpickler(f).load()


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    """Write ``payload`` (numpy trees and :class:`Foreign` tuples)
    atomically."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        _Pickler(f, protocol=pickle.HIGHEST_PROTOCOL).dump(payload)
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
