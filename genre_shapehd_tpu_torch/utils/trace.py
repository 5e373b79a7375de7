"""The port's profiler spans: every ``record_function`` range the port
opens, by the names below, and the spans that time a stage's backward.

Names follow ``<model>.<stage>[.backward]``: ``genre.net1`` is the
forward of GenRe's first U-ResNet, ``genre.net1.backward`` its backward
on autograd's thread; a stage inside a stage adds a level
(``genre.refine.decoder``), and so does a layer inside a stage
(``shapehd.critic.stem`` and ``shapehd.critic.body``, stages of their
own opened by the critic wherever it runs, a WGAN-GP step's included,
with their backward spans).
The steps' phases (``genre.train_step``, ``genre.zero_grad``,
``genre.loss``, ``genre.backward``, ``genre.optimizer``) keep GenRe's
prefix in every model that steps
through ``models/base.py``; the collectives' spans are ``dp.`` and
``sp.``.  Readers: ``bench_port/metrics/`` (the ``genre.``,
``marrnet.`` and ``shapehd.`` spans, by device time),
``train/loop.py::profile_step`` (stages, ``dp.`` and ``sp.``) and
``chip_smoke.py::device_profile`` (every ``genre.``, ``marrnet.``,
``shapehd.`` and ``wgangp.`` span).

A span costs nothing unless a profiler is recording.  :func:`stage` also
times the backward, and only while a profiler records with grad enabled:
then an identity ``autograd.Function`` on the stage's outputs opens
``<name>.backward`` when autograd reaches it, and one on the stage's
inputs that need a gradient closes it once every gradient has left the
stage.  A stage with no such input (net1's photos) closes at the end of
the backward pass, as the first stage it is: nothing is made
differentiable for the sake of a span, so no kernel is added.  Without a
profiler, under ``no_grad`` / ``inference_mode``, or in a process group
(``cli.train --multihost``, where rank 0 alone profiles and a node on one
rank could reorder the backward's collectives against the others'), the
autograd graph is the one the stage's ops build alone.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
from torch.profiler import record_function

# stages: spans over a part of a forward pass (and, through :func:`stage`,
# over its backward)
NET1 = "genre.net1"
CAMERA_BP = "genre.camera_bp"
RENDER = "genre.render"
NET2 = "genre.net2"
SPHERICAL_BP = "genre.spherical_bp"
REFINE = "genre.refine"
REFINE_ENCODER = "genre.refine.encoder"
REFINE_DECODER = "genre.refine.decoder"
MARRNET1 = "marrnet.marrnet1"
MARRNET2 = "marrnet.marrnet2"
CRITIC = "shapehd.critic"
NET_NOFT = "shapehd.net_noft"
# a layer inside a stage, run as a stage of its own whichever path
# computes it: the critic's first convolution and its activation
# (``nn/voxel_nets.py::VoxelDiscriminator``; K6 or ``F.conv3d``), its
# backward under ``shapehd.critic.stem.backward``
CRITIC_STEM = "shapehd.critic.stem"
# the critic's layers after the stem: its middle convolutions and the
# last one to the score (K7 and a product, or ``F.conv3d``), their
# backward under ``shapehd.critic.body.backward``
CRITIC_BODY = "shapehd.critic.body"
STAGES = (NET1, CAMERA_BP, RENDER, NET2, SPHERICAL_BP, REFINE,
          REFINE_ENCODER, REFINE_DECODER, MARRNET1, MARRNET2, CRITIC,
          NET_NOFT, CRITIC_STEM, CRITIC_BODY)
#: the suffix of a stage's backward span
BACKWARD_SUFFIX = ".backward"

# the phases of ``models/base.py::train_step``
TRAIN_STEP = "genre.train_step"
ZERO_GRAD = "genre.zero_grad"
LOSS = "genre.loss"
BACKWARD = "genre.backward"
OPTIMIZER = "genre.optimizer"

# the upload of an inference batch at the top of ``predict_step``
GENRE_UPLOAD = "genre.upload"
MARRNET_UPLOAD = "marrnet.upload"
SHAPEHD_UPLOAD = "shapehd.upload"

# the WGAN-GP's two phases (``models/wgangp.py``)
WGANGP_D = "wgangp.d_phase"
WGANGP_G = "wgangp.g_phase"

# collectives (``parallel/mesh.py``): the gradients' all-reduce, the Z
# halos and the Z gathers of ``--sp``
GRAD_ALL_REDUCE = "dp.all_reduce_grads"
SP_HALO = "sp.halo"
SP_GATHER = "sp.gather"


def span(name: str) -> record_function:
    """A ``record_function`` range of one of the names above."""
    return record_function(name)


def stage(name: str, fn: Callable[..., Any], *inputs: Any) -> Any:
    """``fn(*inputs)`` under ``span(name)``.  While a profiler records with
    grad enabled outside a process group, the tensors among ``inputs``
    and among the result (alone, or in tuples, lists and dicts) that need
    a gradient pass through identity nodes that time the stage's backward
    under ``<name>.backward``; ``fn`` sees the inputs' aliases."""
    if not (torch.is_grad_enabled()
            and torch._C._autograd._profiler_enabled()
            and not (dist.is_available() and dist.is_initialized())):
        with span(name):
            return fn(*inputs)
    mark = _Mark(name + BACKWARD_SUFFIX)
    inputs = _through(_Leave, mark, inputs)
    with span(name):
        out = fn(*inputs)
    return _through(_Enter, mark, out)


class _Mark:
    """The backward span of one call of a stage: opened on autograd's
    thread by :class:`_Enter`, closed there by :class:`_Leave` or, where
    that does not run, at the end of the backward pass."""

    def __init__(self, name: str):
        self.name = name
        self.range: Optional[record_function] = None

    def open(self) -> None:
        if self.range is None:
            self.range = record_function(self.name)
            self.range.__enter__()
            torch.autograd.Variable._execution_engine.queue_callback(
                self.close)

    def close(self) -> None:
        if self.range is not None:
            self.range.__exit__(None, None, None)
            self.range = None


class _Enter(torch.autograd.Function):
    """Identity on a stage's outputs; its backward opens the span."""

    @staticmethod
    def forward(ctx, mark: _Mark, *xs: torch.Tensor):
        ctx.mark = mark
        ctx.set_materialize_grads(False)
        return xs

    @staticmethod
    def backward(ctx, *grads):
        ctx.mark.open()
        return (None,) + grads


class _Leave(torch.autograd.Function):
    """Identity on a stage's inputs; its backward closes the span."""

    @staticmethod
    def forward(ctx, mark: _Mark, *xs: torch.Tensor):
        ctx.mark = mark
        ctx.set_materialize_grads(False)
        return xs

    @staticmethod
    def backward(ctx, *grads):
        ctx.mark.close()
        return (None,) + grads


def _through(node: type, mark: _Mark, obj: Any) -> Any:
    """``obj`` with its tensors that need a gradient passed through one
    ``node`` (itself where none does)."""
    found: List[torch.Tensor] = []
    _collect(obj, found)
    if not found:
        return obj
    return _replace(obj, iter(node.apply(mark, *found)))


def _wants_grad(x: Any) -> bool:
    return isinstance(x, torch.Tensor) and x.requires_grad


def _collect(obj: Any, found: List[torch.Tensor]) -> None:
    if _wants_grad(obj):
        found.append(obj)
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            _collect(x, found)
    elif isinstance(obj, dict):
        for x in obj.values():
            _collect(x, found)


def _replace(obj: Any, new) -> Any:
    if _wants_grad(obj):
        return next(new)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_replace(x, new) for x in obj)
    if isinstance(obj, dict):
        return {k: _replace(v, new) for k, v in obj.items()}
    return obj
