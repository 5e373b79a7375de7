"""A model's training state in the JAX package's checkpoint layout
(counterpart of ``genre_shapehd_tpu/train/state.py``).

The port's state is the model's net and its ``torch.optim.Adam``.  In a
checkpoint the net is the JAX package's ``params`` / ``batch_stats``
trees (``core/convert.py``), so either package's ``cli.test`` reads it.
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


def state_to_reference_payload(model, epoch: int,
                               loss_eval: float) -> Dict[str, Any]:
    """A model's net and Adam state in the reference checkpoint layout."""
    params, stats = torch_to_jax(model.net.state_dict())
    return {
        "nets": [{"params": params, "batch_stats": stats}],
        "optimizers": [adam_state_to_jax(model.optimizer, model.net)],
        "epoch": epoch,
        "loss_eval": loss_eval,
        "extra": {},
        "net_names": list(model.net_names),
        "opt_names": list(model.optimizer_names),
    }


def reference_payload_to_state(payload: Dict[str, Any], model) -> None:
    """Load a checkpoint of either package into ``model``: the net's
    weights and statistics, and Adam's moments where it has them (the
    options' learning rate and betas stay the current ones)."""
    net = payload["nets"][0]
    model.net.load_state_dict(jax_to_torch(net["params"],
                                           net.get("batch_stats") or {}))
    found = adam_moments(payload.get("optimizers") or ())
    if found is not None:
        load_adam_state(model.optimizer, model.net, *found)
