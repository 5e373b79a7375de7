"""Weights between the JAX package's Flax trees and this package's
``state_dict``s.

The port's modules carry the Flax module names (``Conv_0``,
``BatchNorm_2``, ``decoder_depth`` ...), so a Flax path maps to a
``state_dict`` key by joining it with dots; the leaf's parent module name
says how the array is laid out:

  ``Conv*`` kernel (k..., I, O)          -> weight (O, I, k...)
  ``ConvTranspose*`` kernel (k..., I, O) -> weight (I, O, k...), every
                                            spatial axis flipped
  ``Dense*`` kernel (in, out)            -> weight (out, in)
  ``BatchNorm*`` scale / bias / mean / var
                         -> weight / bias / running_mean / running_var
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

Tree = Dict[str, Any]


def _flatten(tree: Tree, prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _set(tree: Tree, path: Tuple[str, ...], value: np.ndarray) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _kernel_to_torch(parent: str, k: np.ndarray) -> np.ndarray:
    nd = k.ndim
    spatial = tuple(range(nd - 2))
    if parent.startswith("ConvTranspose"):
        w = k.transpose((nd - 2, nd - 1) + spatial)
        return np.flip(w, axis=tuple(range(2, nd)))
    if parent.startswith("Conv"):
        return k.transpose((nd - 1, nd - 2) + spatial)
    if parent.startswith("Dense"):
        return k.T
    raise KeyError(f"no layout rule for a kernel under {parent!r}")


def _weight_to_jax(parent: str, w: np.ndarray) -> np.ndarray:
    nd = w.ndim
    spatial = tuple(range(2, nd))
    if parent.startswith("ConvTranspose"):
        return np.flip(w, axis=spatial).transpose(spatial + (0, 1))
    if parent.startswith("Conv"):
        return w.transpose(spatial + (1, 0))
    if parent.startswith("Dense"):
        return w.T
    raise KeyError(f"no layout rule for a weight under {parent!r}")


def jax_to_torch(params: Tree, batch_stats: Tree) -> Dict[str, torch.Tensor]:
    """Flax ``params`` + ``batch_stats`` trees -> a ``state_dict``."""
    sd: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(params):
        parent, leaf, key = path[-2], path[-1], ".".join(path[:-1])
        if parent.startswith("BatchNorm"):
            name = {"scale": "weight", "bias": "bias"}[leaf]
        elif leaf == "kernel":
            arr, name = _kernel_to_torch(parent, arr), "weight"
        elif leaf == "bias":
            name = "bias"
        else:
            raise KeyError("/".join(path))
        sd[f"{key}.{name}"] = torch.from_numpy(np.array(arr, np.float32))
    for path, arr in _flatten(batch_stats):
        key = ".".join(path[:-1])
        name = {"mean": "running_mean", "var": "running_var"}[path[-1]]
        sd[f"{key}.{name}"] = torch.from_numpy(np.array(arr, np.float32))
        sd[f"{key}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    return sd


def torch_to_jax(state_dict: Dict[str, torch.Tensor]) -> Tuple[Tree, Tree]:
    """Inverse of :func:`jax_to_torch`: -> (params, batch_stats) numpy
    trees in the JAX package's layout."""
    params: Tree = {}
    stats: Tree = {}
    for key, t in state_dict.items():
        path = tuple(key.split("."))
        parent, leaf = path[-2], path[-1]
        if leaf == "num_batches_tracked":
            continue
        arr = t.detach().to("cpu", torch.float32).numpy()
        mod = path[:-1]
        if parent.startswith("BatchNorm"):
            if leaf in ("running_mean", "running_var"):
                _set(stats, mod + ({"running_mean": "mean",
                                    "running_var": "var"}[leaf],), arr)
            else:
                _set(params, mod + ({"weight": "scale",
                                     "bias": "bias"}[leaf],), arr)
        elif leaf == "weight":
            _set(params, mod + ("kernel",),
                 np.array(_weight_to_jax(parent, arr), np.float32))
        elif leaf == "bias":
            _set(params, mod + ("bias",), arr)
        else:
            raise KeyError(key)
    return params, stats
