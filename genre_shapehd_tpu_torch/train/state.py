"""A model's training state in the JAX package's checkpoint layout
(counterpart of ``genre_shapehd_tpu/train/state.py``).

The port's state is the model's nets (``net_modules``: one for most
models, ``net_g`` and ``net_d`` for WGAN-GP, ``net``, ``net_noft`` and
``net_d`` for ShapeHD), their ``torch.optim.Adam``s (``optimizer_entries``)
and ``extra_state`` (WGAN-GP's ``last_err_g``).  In a checkpoint each net
is the JAX package's ``params`` / ``batch_stats`` trees
(``core/convert.py``), so either package's ``cli.test`` reads it.
Adam's moments cross as trees in the same parameter layout, transposed
taps flipped, so that a step after a resume is the step the JAX package
would take:

  optax ``ScaleByAdamState(count, mu, nu)`` <-> per parameter
  ``step`` = count, ``exp_avg`` = mu, ``exp_avg_sq`` = nu.

A JAX checkpoint pickles the optax objects, which load as stand-ins
(``core/checkpoint.py``).  The port writes the state of the optax
transformation the JAX package builds (``models/base.py::adam``) through
:class:`~..core.checkpoint.Foreign` tuples that pickle as optax's classes:
``(ScaleByAdamState(count, mu, nu), EmptyState())`` for ``optax.adam``, and
``(EmptyState(), (ScaleByAdamState(...), EmptyState()))`` under
``--wdecay`` (``optax.chain(add_decayed_weights, adam)``).  Checkpoints of
earlier versions of the port hold ``{"count", "mu", "nu"}`` instead; both
load.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.checkpoint import Foreign
from ..core.convert import jax_to_torch, torch_to_jax


class ScaleByAdamState(Foreign):
    """optax's Adam state (count, mu, nu), written by reference."""
    pickle_as = ("optax._src.transform", "ScaleByAdamState")


class EmptyState(Foreign):
    """optax's state of a stateless transformation, written by
    reference."""
    pickle_as = ("optax._src.base", "EmptyState")


def adam_moments(opt_state: Any) -> Optional[Tuple[int, Dict, Dict]]:
    """(count, mu, nu) of the Adam state in a checkpoint's optimizer
    entry -- an optax state tuple, searched for its ``ScaleByAdamState``
    (as loaded, a stand-in holding the fields in ``args``; as written, a
    :class:`ScaleByAdamState`), or the dict of earlier versions of the
    port -- or None when it holds none."""
    if isinstance(opt_state, dict) and {"count", "mu", "nu"} <= set(opt_state):
        return (int(np.asarray(opt_state["count"])), opt_state["mu"],
                opt_state["nu"])
    if type(opt_state).__name__ == "ScaleByAdamState":
        count, mu, nu = getattr(opt_state, "args", opt_state)
        return int(np.asarray(count)), mu, nu
    if isinstance(opt_state, (tuple, list)):
        for item in opt_state:
            found = adam_moments(item)
            if found is not None:
                return found
    return None


def adam_state_to_jax(optimizer: torch.optim.Adam,
                      net: torch.nn.Module) -> Tuple:
    """The port's optimizer entry: optax's state of the JAX package's
    Adam, with the decay stage when the optimizer decays weights, and
    Adam's moments as JAX-layout trees."""
    mu, nu, count = {}, {}, 0
    for name, p in net.named_parameters():
        st = optimizer.state.get(p)
        if not st:
            mu[name] = nu[name] = torch.zeros_like(p)
            continue
        mu[name], nu[name] = st["exp_avg"], st["exp_avg_sq"]
        count = int(st["step"])
    state = (ScaleByAdamState(np.int32(count), torch_to_jax(mu)[0],
                              torch_to_jax(nu)[0]), EmptyState())
    if optimizer.param_groups[0]["weight_decay"]:
        state = (EmptyState(), state)
    return state


def load_adam_state(optimizer: torch.optim.Adam, net: torch.nn.Module,
                    count: int, mu: Dict, nu: Dict) -> None:
    """Set Adam's state from JAX-layout moments (layouts as for the
    parameters)."""
    mu_sd, nu_sd = jax_to_torch(mu, {}), jax_to_torch(nu, {})
    for name, p in net.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": mu_sd[name].to(p.device, p.dtype).reshape(p.shape),
            "exp_avg_sq": nu_sd[name].to(p.device, p.dtype).reshape(p.shape)}


def _to_numpy(tree: Any) -> Any:
    """Tensors of a (nested) dict as numpy arrays."""
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def state_to_reference_payload(model, epoch: int,
                               loss_eval: float) -> Dict[str, Any]:
    """A model's nets and Adam states in the reference checkpoint layout,
    in the order of its ``net_names`` and ``optimizer_names``, and its
    ``extra_state`` (WGAN-GP's ``last_err_g``)."""
    nets = model.net_modules()
    entries = model.optimizer_entries()
    payload_nets = []
    for name in model.net_names:
        params, stats = torch_to_jax(nets[name].state_dict())
        payload_nets.append({"params": params, "batch_stats": stats})
    return {
        "nets": payload_nets,
        "optimizers": [adam_state_to_jax(*entries[name])
                       for name in model.optimizer_names],
        "epoch": epoch,
        "loss_eval": loss_eval,
        "extra": _to_numpy(model.extra_state()),
        "net_names": list(model.net_names),
        "opt_names": list(model.optimizer_names),
    }


def load_nets(payload: Dict[str, Any], model) -> None:
    """Each net of a checkpoint of either package into the model's net of
    the same name (the payload's ``net_names``, else the model's order);
    a net the payload lacks keeps its weights."""
    nets = model.net_modules()
    names = payload.get("net_names") or []
    if not set(names) <= set(nets):
        names = list(model.net_names)
    for name, net in zip(names, payload["nets"]):
        nets[name].load_state_dict(jax_to_torch(
            net["params"], net.get("batch_stats") or {}))


def reference_payload_to_state(payload: Dict[str, Any], model) -> None:
    """Load a checkpoint of either package into ``model``: the nets'
    weights and statistics, Adam's moments where it has them (the
    options' learning rate and betas stay the current ones), and
    ``extra``."""
    load_nets(payload, model)
    entries = model.optimizer_entries()
    names = payload.get("opt_names") or []
    if not set(names) <= set(entries):
        names = list(model.optimizer_names)
    for name, entry in zip(names, payload.get("optimizers") or ()):
        found = adam_moments(entry)
        if found is not None:
            load_adam_state(*entries[name], *found)
    model.load_extra_state(payload.get("extra") or {})
