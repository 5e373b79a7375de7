"""PyTorch port, GenRe training on the CPU against the JAX package: the
surface shell, the losses, the BatchNorm running statistics, one whole
float32 ``train_step`` in stage 3 and joint, a resume from a JAX
checkpoint with its Adam state, the synthetic data, and ``cli.train`` in
a subprocess.

Two numerical facts shape the tolerances of the train-step tests.
- Flax computes a batch variance as E[x²] - E[x]² in float32.  On the
  smooth rendered spherical maps that net2 reads this loses about 5e-4 of
  net2's output (measured against a float64 run of the port, which the
  port's two-pass variance matches to 3e-5), so the JAX reference is run
  with Flax's two-pass variance (``_exact_flax_variance``); nothing in
  the JAX package changes.
- Both backprojections assign points to voxels with ``floor()``: a
  difference of 1e-5 in net2's output moves a few points to a
  neighbouring voxel.  The joint step is therefore compared at the JAX
  forward's values of net2's output and of the camera backprojection
  (``_at_jax_values``), with weights calibrated on batch statistics so
  that both grids hold many points.  Gradients are held per tensor by
  direction (cosine) and size (norm ratio).
"""

import contextlib

import functools
import os
import pickle
import shutil
import subprocess
import sys
from unittest import mock

import flax.linen.normalization as flax_norm
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from genre_shapehd_tpu.core.checkpoint import save_checkpoint
from genre_shapehd_tpu.core.registry import get_dataset as jax_dataset
from genre_shapehd_tpu.core.registry import get_model as jax_model
from genre_shapehd_tpu.data.loader import collate as jax_collate
from genre_shapehd_tpu.models.base import default_opt as jax_opt
from genre_shapehd_tpu.ops.voxel import surface_from_solid_jax
from genre_shapehd_tpu.parallel import mesh as pmesh
from genre_shapehd_tpu.train.state import state_to_reference_payload
from genre_shapehd_tpu_torch.core.checkpoint import load_checkpoint
from genre_shapehd_tpu_torch.core.convert import jax_to_torch
from genre_shapehd_tpu_torch.core.registry import get_dataset, get_model
from genre_shapehd_tpu_torch.data.loader import DataLoader, collate
from genre_shapehd_tpu_torch.models.base import default_opt
from genre_shapehd_tpu_torch.nn.resnet import batch_norm
from genre_shapehd_tpu_torch.ops.voxel import surface_from_solid
from genre_shapehd_tpu_torch.train import state as tstate

from _torch_port_util import TINY, calibrate, release_memory, scene_inputs
from _torch_port_util import exact_flax_variance as _exact_flax_variance
from _torch_port_util import grad_agreement as _grad_agreement

torch.set_num_threads(4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the compute_loss scale of tests/test_joint_finetune.py
TOY = dict(im_size=16, vox_res=8, sph_res=8, z_res=16, padding_margin=2)
#: the train-step scale: the nets need a 64² image and a 64² spherical
#: input (sph_res + 2 * margin); batch 4 as in the configuration
BATCH = 4
LR = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _release_memory_at_the_end():
    """At the end, the module's cached JAX steps and the memory they held
    are let go (a test worker runs other files after this one)."""
    yield
    _jax_steps.cache_clear()
    release_memory()


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


def _solids(n, res, seed):
    """Blobs thick enough that two erosions leave an interior."""
    rng = np.random.default_rng(seed)
    c = (np.arange(res) + 0.5) / res - 0.5
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    out = np.zeros((n, res, res, res), np.float32)
    for i in range(n):
        r = rng.uniform(0.2, 0.45, 3)
        out[i] = (x / r[0]) ** 2 + (y / r[1]) ** 2 + (z / r[2]) ** 2 < 1
    out += rng.random(out.shape) > 0.9           # speckle: eroded at once
    return np.clip(out, 0, 1)


@pytest.mark.parametrize("res,seed", [(17, 0), (24, 1), (32, 2)])
def test_surface_from_solid_equals_jax(res, seed):
    vox = _solids(2, res, seed)
    ref = np.asarray(surface_from_solid_jax(jnp.asarray(vox)))
    got = surface_from_solid(torch.from_numpy(vox)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < ref.sum() < vox.sum()             # a shell, not all or none


def test_batchnorm_running_stats_are_flax_biased():
    """One train-mode call moves the running variance toward the biased
    batch variance (Flax), not torch's unbiased one: 4/3 apart at a
    BatchNorm1d batch of 4."""
    x = np.random.default_rng(3).standard_normal((BATCH, 6)).astype(
        np.float32) * 3 + 1
    bn = flax_norm.BatchNorm(use_running_average=False, momentum=0.9,
                             epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y_j, mut = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    port = batch_norm(6, dims=1).train()
    y_t = port(torch.from_numpy(x))
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j),
                               rtol=0, atol=1e-5)
    for key, ref in (("running_mean", mut["batch_stats"]["mean"]),
                     ("running_var", mut["batch_stats"]["var"])):
        np.testing.assert_allclose(getattr(port, key).numpy(),
                                   np.asarray(ref), rtol=1e-6, atol=1e-7)
    unbiased = 0.9 + 0.1 * x.var(0, ddof=1)
    assert np.all(np.abs(port.running_var.numpy() - unbiased) > 1e-3)


def _toy_pred_batch(seed):
    """Random predictions and targets at the compute_loss scale of
    tests/test_joint_finetune.py."""
    rng = np.random.RandomState(seed)
    n, s, r, m = 2, TOY["im_size"], TOY["sph_res"], TOY["padding_margin"]
    p = r + 2 * m
    pred = {"normal": rng.randn(n, s, s, 3), "depth": rng.randn(n, s, s, 1),
            "silhou": rng.randn(n, s, s, 1), "depth_minmax": rng.randn(n, 2),
            "pred_sph_full": rng.randn(n, p, p, 1),
            "pred_voxel": rng.randn(n, r, r, r)}
    batch = {"normal": rng.randn(n, s, s, 3), "depth": rng.randn(n, s, s, 1),
             "silhou": (rng.rand(n, s, s, 1) > 0.5) * 100.0,
             "depth_minmax": rng.randn(n, 2),
             "spherical_object": rng.randn(n, p, p, 1),
             "voxel": _solids(n, r, seed)}
    cast = lambda d: {k: np.asarray(v, np.float32)             # noqa: E731
                      for k, v in d.items()}
    return cast(pred), cast(batch)


def _models(joint, w25d=0.01, **cfg):
    kw = dict(cfg or TINY, joint_train=joint, joint_w25d=w25d,
              surface_weight=10.0, lr=LR, no_aug=True, batch_size=BATCH)
    return (jax_model("genre_full_model")(jax_opt(**kw)),
            get_model("genre_full_model")(default_opt(device="cpu", **kw)))


@pytest.mark.parametrize("joint", [False, True])
def test_compute_loss_matches_jax(joint):
    pred, batch = _toy_pred_batch(4)
    jm, tm = _models(joint)
    _, ref = jm.compute_loss(pred, batch)
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa
    loss, got = tm.compute_loss(t(pred), t(batch))
    assert sorted(got) == sorted(ref)
    assert float(loss) == float(got["loss"])
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5,
                                   err_msg=k)


def test_joint_w25d_scales_only_the_25d_supervision():
    """L(w) == w * (2.5D + spherical part) + voxel part, as in
    tests/test_joint_finetune.py."""
    pred, batch = _toy_pred_batch(5)
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa
    losses = {w: float(_models(True, w)[1].compute_loss(t(pred), t(batch))[0])
              for w in (0.0, 0.25, 1.0)}
    part_25d = losses[1.0] - losses[0.0]
    assert part_25d > 0.0
    np.testing.assert_allclose(losses[0.25], 0.25 * part_25d + losses[0.0],
                               rtol=1e-5)


@functools.lru_cache(maxsize=2)
def _jax_steps(joint):
    """The JAX model at TINY scale with calibrated weights (so that both
    backprojections see points; joint: on batch statistics, as its step
    runs net1), the synthetic batch, the loss terms, gradients and
    forward values at the start, and the state after one and two steps,
    with the gradients at the first step's state."""
    jm, _ = _models(joint, **TINY)
    state = jm.init_state(jax.random.PRNGKey(0))
    params, stats = calibrate(_to_np(state.params["net"]),
                              _to_np(state.batch_stats["net"]),
                              *scene_inputs(BATCH, TINY["im_size"], seed=1),
                              train=joint)
    state = state.replace(params={"net": jax.tree.map(jnp.asarray, params)},
                          opt_state={"net": jm.tx.init(params)})
    ds = jax_dataset("synthetic")(jax_opt(**TINY, no_aug=True), "train",
                                  model=jm)
    batch = jax_collate([ds[i] for i in range(BATCH)])
    batch = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    grad_fn = jax.jit(jax.grad(jm._loss, has_aux=True), static_argnums=3)
    step = jax.jit(jm.train_step)
    with _exact_flax_variance():
        grads, (_, _, pred) = grad_fn(state.params["net"],
                                      state.batch_stats["net"], batch, True)
        state1, loss_data = step(state, batch, jax.random.PRNGKey(1))
        grads1, _ = grad_fn(state1.params["net"], state1.batch_stats["net"],
                            batch, True)
        state2, _ = step(state1, batch, jax.random.PRNGKey(2))
    return dict(model=jm, params=params, stats=stats, batch=batch,
                grads=_to_np(grads), pred=_to_np(pred),
                loss=_to_np(loss_data),
                state1=jax.tree.map(np.asarray, state1), grads1=_to_np(grads1),
                state2=jax.tree.map(np.asarray, state2))


@contextlib.contextmanager
def _at_jax_values(net, pred):
    """Runs the port's train step at the JAX forward's values of net2's
    output ``pred_sph_full`` (which the spherical backprojection assigns
    to voxels) and of the camera backprojection's ``proj_depth``: each
    becomes x + (jax - x).detach(), whose value is JAX's and whose
    gradient flows through the port's own graph, renderer included.
    Yields the port's own values of the two."""
    dn = net.depth_and_inpaint
    forward = dn.forward
    own = {}

    def pinned(*args):
        out = forward(*args)
        for k in ("pred_sph_full", "proj_depth"):
            own[k] = out[k].detach().clone()
            ref = torch.tensor(pred[k], dtype=out[k].dtype)
            out[k] = out[k] + (ref - out[k]).detach()
        return out
    with mock.patch.object(dn, "forward", pinned):
        yield own


@pytest.mark.parametrize("joint", [False, True])
def test_train_step_matches_jax(joint):
    ref = _jax_steps(joint)
    _, tm = _models(joint, **TINY)
    tm.init_state(0)
    tm.load_weights(ref["params"], ref["stats"])
    tds = get_dataset("synthetic")(default_opt(device="cpu", **TINY,
                                               no_aug=True), "train",
                                   model=tm)
    batch = collate([tds[i] for i in range(BATCH)])
    batch = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    for k, v in ref["batch"].items():             # the same data
        np.testing.assert_allclose(batch[k], v, rtol=0, atol=1e-6)
    before = {k: v.clone() for k, v in tm.net.state_dict().items()}
    with _at_jax_values(tm.net, ref["pred"]) as own:
        got = tm.train_step(batch)
    # the port's own values where they were pinned: measured worst 4.6e-4
    # of net2's output (std 1) and 1.2e-2 of proj_depth (std 3.5), joint
    for k, tol in (("pred_sph_full", 2e-3), ("proj_depth", 5e-2)):
        err = float((own[k] - torch.tensor(ref["pred"][k])).abs().max())
        assert err <= tol, (k, err)

    # loss terms: float32 through ~80 layers with batch statistics
    assert sorted(got) == sorted(ref["loss"])
    for k, v in ref["loss"].items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4,
                                   err_msg=k)

    # gradients (cosine, norm ratio), measured worst: stage 3, the refine
    # net's 0.99982, 0.4 %.  Joint: net1's, through the renderer and the
    # camera backprojection, 0.99991, 0.2 %; net2's 0.99983, 0.7 %; the
    # refine net's 0.99997, 0.3 %
    net = tm.net
    bounds = {"depth_and_inpaint.net1.": (0.999, 0.01) if joint else None,
              "depth_and_inpaint.net2.": (0.995, 0.03) if joint else None,
              "refine_net.": (0.995, 0.03)}
    ref_sd = jax_to_torch(ref["grads"], {})
    for prefix, bound in bounds.items():
        if bound is None:
            # no loss reaches it: every gradient exactly 0, in JAX too
            for n, p in net.named_parameters():
                if n.startswith(prefix):
                    assert not p.grad.any() and not ref_sd[n].any(), n
            continue
        cos, ratio, stray = _grad_agreement(net, ref["grads"], prefix)
        assert cos >= bound[0] and ratio <= bound[1], (prefix, cos, ratio)
        assert stray <= 1e-4, (prefix, stray)

    # BatchNorm running statistics (biased variance)
    after = jax_to_torch(ref["state1"].params["net"],
                         ref["state1"].batch_stats["net"])
    sd = net.state_dict()
    for k, v in after.items():
        if "running_" in k:
            # measured worst: 2e-4 of the statistic's scale
            scale = float(v.abs().max()) + 1e-6
            err = float((sd[k] - v).abs().max()) / scale
            assert err <= 2e-3, (k, err)

    # Adam's first step is -lr * g / (|g| + eps), eps 1e-8: a sign for
    # most entries, so it is held on every entry in two halves, within
    # 1e-6 of lr plus the rounding of p + update.  The port's update is
    # that of its own gradient; and the port's optimizer, given JAX's
    # gradient at the same start, lands on JAX's parameters
    params = {k: v for k, v in after.items() if "running_" not in k
              and not k.endswith("num_batches_tracked")}
    for k, p in net.named_parameters():
        step = -LR * p.grad / (p.grad.abs() + 1e-8)
        slack = 1e-6 * LR + 2.0 ** -22 * before[k].abs()
        assert bool(((sd[k] - before[k] - step).abs() <= slack).all()), k
    _, fresh = _models(joint, **TINY)
    fresh.init_state(0)
    fresh.load_weights(ref["params"], ref["stats"])
    ref_g = jax_to_torch(ref["grads"], {})
    for k, p in fresh.net.named_parameters():
        p.grad = ref_g[k].clone()
    fresh.optimizer.step()
    fresh_sd = fresh.net.state_dict()
    assert sorted(params) == sorted(k for k, _ in net.named_parameters())
    for k, v in params.items():
        slack = 1e-6 * LR + 2.0 ** -22 * before[k].abs()
        assert bool(((fresh_sd[k] - v).abs() <= slack).all()), k
    moved = lambda p: any(float((sd[k] - before[k]).abs().max()) > 0  # noqa
                          for k in sd if k.startswith(p)
                          and "running_" not in k and "num_b" not in k)
    assert moved("refine_net.")
    assert moved("depth_and_inpaint.net1.") == moved(
        "depth_and_inpaint.net2.") == joint


def test_jax_checkpoint_stand_ins_keep_the_adam_state(tmp_path):
    """The stand-ins of the restricted unpickler keep the fields of
    optax's ScaleByAdamState: count, mu and nu come back equal."""
    params = {"Dense_0": {"kernel": np.arange(6.0, dtype=np.float32)
                          .reshape(2, 3), "bias": np.ones(3, np.float32)}}
    tx = optax.adam(1e-3)
    opt_state = tx.init(params)
    grads = jax.tree.map(lambda p: p * 0.5 + 1, params)
    for _ in range(3):
        _, opt_state = tx.update(grads, opt_state, params)
    path = str(tmp_path / "adam.pt")
    save_checkpoint(path, {"nets": [{"params": params, "batch_stats": {}}],
                           "optimizers": [_to_np(opt_state)], "epoch": 1,
                           "loss_eval": 0.5})
    loaded = load_checkpoint(path)["optimizers"][0]
    adam, empty = loaded
    assert type(adam).__name__ == "ScaleByAdamState" and len(adam.args) == 3
    assert type(empty).__name__ == "EmptyState" and empty.args == ()
    count, mu, nu = tstate.adam_moments(loaded)
    assert count == 3 == int(opt_state[0].count)
    for got, ref in ((mu, opt_state[0].mu), (nu, opt_state[0].nu)):
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(got["Dense_0"][k],
                                          np.asarray(ref["Dense_0"][k]))


def test_resume_from_a_jax_checkpoint_takes_the_same_step(tmp_path):
    """A JAX checkpoint after one step, Adam state included, loaded into
    the port: with the JAX gradient of the second step the port's Adam
    takes JAX's second step (moments mapped like the parameters,
    transposed-conv taps flipped); the port's own second step agrees as
    the first one does; and the port writes the state back unchanged."""
    ref = _jax_steps(False)
    jm = ref["model"]
    path = str(tmp_path / "checkpoint.pt")
    save_checkpoint(path, state_to_reference_payload(
        ref["state1"], jm.net_names, jm.optimizer_names, 1, 0.9))
    _, tm = _models(False, **TINY)
    tm.init_state(0)
    from genre_shapehd_tpu_torch.train.loop import Trainer
    trainer = Trainer(tm, tm.opt)
    trainer.load(path)
    assert trainer.start_epoch == 1
    st = next(iter(tm.optimizer.state.values()))
    assert float(st["step"]) == 1.0

    # the state written back equals what was read
    back_count, back_mu, back_nu = tstate.adam_moments(
        tstate.adam_state_to_jax(tm.optimizer, tm.net))
    count, mu, nu = tstate.adam_moments(load_checkpoint(path)["optimizers"])
    assert back_count == count == 1
    for a, b in zip(jax.tree.leaves(back_mu) + jax.tree.leaves(back_nu),
                    jax.tree.leaves(mu) + jax.tree.leaves(nu)):
        np.testing.assert_array_equal(a, b)

    before = {k: v.clone() for k, v in tm.net.state_dict().items()}
    g1 = jax_to_torch(ref["grads1"], {})
    for n, p in tm.net.named_parameters():
        p.grad = g1[n].clone()
    tm.optimizer.step()
    after = jax_to_torch(ref["state2"].params["net"], {})
    sd = tm.net.state_dict()
    for k, v in after.items():
        # Adam's arithmetic in float32 in both: a few ulp of lr
        np.testing.assert_allclose((sd[k] - before[k]).numpy(),
                                   (v - before[k]).numpy(), rtol=0,
                                   atol=1e-3 * LR, err_msg=k)


def _seeded_grads(net, seed):
    """A gradient for every parameter, made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    return {n: torch.from_numpy(rng.standard_normal(tuple(p.shape))
                                .astype(np.float32))
            for n, p in net.named_parameters()}


def _port_step(model, grads):
    for n, p in model.net.named_parameters():
        p.grad = grads[n].clone()
    model.optimizer.step()


@pytest.mark.parametrize("wdecay", [0.0, 0.05])
def test_jax_trainer_resumes_a_port_checkpoint(tmp_path, wdecay):
    """A port checkpoint after two steps, Adam state included, loaded by
    the JAX package's ``Trainer``: its optimizer state has the structure
    of the model's optax transformation (``optax.adam``, chained after
    ``add_decayed_weights`` under ``--wdecay``) with optax's own classes,
    and with the port's next gradient the JAX optimizer takes the port's
    next step."""
    from genre_shapehd_tpu.train.loop import Trainer as JaxTrainer
    from genre_shapehd_tpu_torch.core.convert import torch_to_jax
    from genre_shapehd_tpu_torch.train.loop import Trainer
    from optax._src.base import EmptyState
    from optax._src.transform import ScaleByAdamState
    jm, tm = _models(False, **TINY, wdecay=wdecay)
    tm.init_state(0)
    for seed in (1, 2):
        _port_step(tm, _seeded_grads(tm.net, seed))
    path = str(tmp_path / "checkpoint.pt")
    Trainer(tm, tm.opt).save(path, 2, 0.7)

    # on one of the 8 virtual CPU devices: replicated on all 8, GenRe's
    # state with Adam's moments takes ~10 GB
    trainer = JaxTrainer(jm, jm.opt, mesh=pmesh.make_mesh(jax.devices()[:1]))
    trainer.initialize(jax.random.PRNGKey(0))
    trainer.load(path)
    assert trainer.start_epoch == 2
    opt_state = trainer.state.opt_state["net"]
    params = trainer.state.params["net"]
    assert jax.tree.structure(opt_state) == jax.tree.structure(
        jm.tx.init(params))
    adam = opt_state[1][0] if wdecay else opt_state[0]
    assert type(adam) is ScaleByAdamState and int(adam.count) == 2
    assert type(opt_state[0 if wdecay else 1]) is EmptyState

    grads = _seeded_grads(tm.net, 3)
    before = {k: v.clone() for k, v in tm.net.state_dict().items()}
    _port_step(tm, grads)
    updates, _ = jm.tx.update(torch_to_jax(grads)[0], opt_state, params)
    after = jax_to_torch(_to_np(optax.apply_updates(params, updates)), {})
    sd = tm.net.state_dict()
    for k, v in after.items():
        # Adam's arithmetic in float32 in both: a few ulp of lr; each adds
        # its update to the parameter with one rounding, which may fall on
        # either side when the two updates differ in their last bits: one
        # ulp of the parameter
        p0 = before[k].numpy()
        d = np.abs((sd[k] - before[k]).numpy() - (v - before[k]).numpy())
        assert (d <= 1e-3 * LR + np.spacing(np.abs(p0))).all(), (k, d.max())


def test_port_resumes_its_earlier_dict_shaped_adam_entries(tmp_path):
    """Checkpoints of earlier versions of the port hold the optimizer
    entry as ``{"count", "mu", "nu"}``: the port still loads them, as it
    loads the optax-shaped entry it writes now, to the same state."""
    from genre_shapehd_tpu_torch.core.checkpoint import save_checkpoint as \
        port_save
    from genre_shapehd_tpu_torch.train.loop import Trainer
    _, tm = _models(False, **TINY)
    tm.init_state(0)
    _port_step(tm, _seeded_grads(tm.net, 4))
    new = tstate.adam_state_to_jax(tm.optimizer, tm.net)
    count, mu, nu = tstate.adam_moments(new)
    old = {"count": np.int32(count), "mu": mu, "nu": nu}
    payload = tstate.state_to_reference_payload(tm, 1, 0.5)
    assert type(payload["optimizers"][0][0]).__name__ == "ScaleByAdamState"
    states = []
    for name, entry in (("old", old), ("new", new)):
        path = str(tmp_path / f"{name}.pt")
        port_save(path, dict(payload, optimizers=[entry]))
        _, fresh = _models(False, **TINY)
        fresh.init_state(5)
        Trainer(fresh, fresh.opt).load(path)
        states.append([fresh.optimizer.state[p]
                       for p in fresh.net.parameters()])
    ref = [tm.optimizer.state[p] for p in tm.net.parameters()]
    for got in states:
        for a, b in zip(got, ref):
            assert float(a["step"]) == float(b["step"]) == 1.0
            torch.testing.assert_close(a["exp_avg"], b["exp_avg"], rtol=0,
                                       atol=0)
            torch.testing.assert_close(a["exp_avg_sq"], b["exp_avg_sq"],
                                       rtol=0, atol=0)


def test_inpaint_path_loads_stage_two_into_depth_and_inpaint(tmp_path):
    """``--inpaint_path``: a stage-2 checkpoint (the depth-and-inpaint
    net's trees under ``net``, as the JAX package's stage-2 model writes
    them) replaces ``depth_and_inpaint`` after the seeded init; the refine
    net keeps its init."""
    from genre_shapehd_tpu_torch.core.checkpoint import save_checkpoint as \
        port_save
    from genre_shapehd_tpu_torch.core.convert import torch_to_jax
    from genre_shapehd_tpu_torch.models.depth_inpaint import DepthInpaintNet
    from genre_shapehd_tpu_torch.nn import init_weights
    stage2 = DepthInpaintNet(**{k: v for k, v in TINY.items()})
    init_weights(stage2, torch.Generator().manual_seed(7))
    params, stats = torch_to_jax(stage2.state_dict())
    path = str(tmp_path / "inpaint.pt")
    port_save(path, {"nets": [{"params": {"net": params},
                               "batch_stats": {"net": stats}}],
                     "optimizers": [], "epoch": 3, "loss_eval": 0.1})
    _, plain = _models(False, **TINY)
    plain.init_state(0)
    _, tm = _models(False, **TINY, inpaint_path=path)
    tm.init_state(0)
    want = stage2.state_dict()
    got, ref = tm.net.state_dict(), plain.net.state_dict()
    for k, v in got.items():
        if k.startswith("depth_and_inpaint."):
            torch.testing.assert_close(v, want[k[len("depth_and_inpaint."):]],
                                       rtol=0, atol=0)
        else:
            torch.testing.assert_close(v, ref[k], rtol=0, atol=0)


def test_synthetic_data_and_augmentation():
    """The synthetic samples are the JAX package's; train-mode
    augmentation draws from a generator seeded by (--manual_seed, index),
    so two datasets agree and another seed differs."""
    opt = default_opt(device="cpu", **TINY, manual_seed=3)
    jm, tm = _models(True)
    ref = jax_dataset("synthetic")(jax_opt(**TINY), "vali", model=jm)[1]
    got = get_dataset("synthetic")(opt, "vali", model=tm)[1]
    assert sorted(k for k in got if k != "rgb_path") == sorted(
        k for k in ref if k != "rgb_path")
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6,
                                       err_msg=k)
    aug = get_model("genre_full_model")(opt)
    a = get_dataset("synthetic")(opt, "train", model=aug)[2]["rgb"]
    b = get_dataset("synthetic")(opt, "train", model=aug)[2]["rgb"]
    c = get_dataset("synthetic")(default_opt(device="cpu", **TINY,
                                             manual_seed=4),
                                 "train", model=aug)[2]["rgb"]
    plain = get_dataset("synthetic")(opt, "train", model=tm)[2]["rgb"]
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 1e-3 and np.abs(a - plain).max() > 1e-3
    with pytest.raises(ValueError, match="seeded"):
        aug.preprocess({"rgb": np.zeros((64, 64, 3))}, mode="train")


def test_loader_shuffles_by_seed_and_drops_the_short_batch():
    data = [{"x": np.full(1, i, np.float32)} for i in range(10)]

    class DS(list):
        pass
    ds = DS(data)
    first = [b["x"][:, 0].tolist() for b in DataLoader(ds, 4, 2, True, 7,
                                                       drop_last=True)]
    again = [b["x"][:, 0].tolist() for b in DataLoader(ds, 4, 2, True, 7,
                                                       drop_last=True)]
    assert first == again and len(first) == 2
    assert sorted(sum(first, [])) != list(range(8))   # shuffled
    plain = [b["x"][:, 0].tolist() for b in DataLoader(ds, 4, 2)]
    assert plain == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]


def test_cli_train_on_the_cpu(tmp_path):
    """Two steps of each kind through ``cli.train`` in a fresh process
    (which loads no JAX module), a resume, then the checkpoint read by the
    port's model and by the JAX package's ModelTest.  A checkpoint holds
    the weights and Adam's two moments, about 0.5 GB at this scale, so
    the run keeps no snapshots and deletes its logdir."""
    logdir = str(tmp_path / "logs")
    args = ["--net", "genre_full_model", "--dataset", "synthetic",
            "--batch_size", "2", "--epoch", "1", "--epoch_batches", "2",
            "--eval_batches", "1", "--synthetic_length", "4",
            "--workers", "2", "--logdir", logdir, "--device", "cpu",
            "--log_time", "--log_batch", "--surface_weight", "10",
            "--manual_seed", "1", "--save_net", "0"] + [
        f"--{k}={v}" for k, v in TINY.items()]
    code = (
        "import sys\n"
        "from genre_shapehd_tpu_torch.cli import train\n"
        "argv = sys.argv[1:]\n"
        "assert train.main(argv) == 0\n"
        "assert train.main(argv + ['--joint_train', '--expr_id', '1', "
        "'--eval_batches', '0']) == 0\n"
        "assert train.main(argv + ['--epoch', '2', '--resume', '-1']) == 0\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', "
        "'optax', 'genre_shapehd_tpu') or m.startswith('genre_shapehd_tpu.'))"
        "\nprint('jax modules:', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    try:
        res = subprocess.run([sys.executable, "-c", code] + args, cwd=REPO,
                             capture_output=True, text=True, timeout=600)
        assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
        run = os.path.join(logdir, "genre_full_model_synthetic_0.0001")
        for expr, phases, files in (
                ("0", ["1,train", "1,eval", "2,train", "2,eval"],
                 ("checkpoint.pt", "best.pt")),
                ("1", ["1,train"], ("checkpoint.pt",))):
            d = os.path.join(run, expr)
            assert sorted(f for f in os.listdir(d) if f.endswith(".pt")) \
                == sorted(files + ("opt.pt",)), (expr, os.listdir(d))
            assert os.path.isfile(os.path.join(d, "opt.txt"))
            n_steps = 2 * sum(p.endswith("train") for p in phases)
            assert len(open(os.path.join(d, "batch_loss.csv")).read()
                       .splitlines()) == 1 + n_steps
            rows = open(os.path.join(d, "epoch_loss.csv")).read() \
                .splitlines()
            assert [r[:len(p)] for r, p in zip(rows[1:], phases)] == phases
            assert len(rows) == 1 + len(phases)
            assert "voxel_loss" in rows[0] and "batch_time" in rows[0]
            assert ("depth_minmax" in rows[0]) == (expr == "1")
            with open(os.path.join(d, "opt.pt"), "rb") as f:
                assert pickle.load(f)["joint_train"] == (expr == "1")
        ckpt = os.path.join(run, "0", "checkpoint.pt")
        payload = load_checkpoint(ckpt)
        # 2 steps, resumed, 2 more
        assert payload["epoch"] == 2
        assert tstate.adam_moments(payload["optimizers"][0])[0] == 4

        # the clobber guard: an existing logdir of a positive expr_id stays
        from genre_shapehd_tpu_torch.cli import train
        with pytest.raises(RuntimeError, match="refusing"):
            train.main(args + ["--expr_id", "1"])
        assert os.path.isfile(os.path.join(run, "1", "checkpoint.pt"))

        # the port's test model and the JAX package's read the checkpoint
        test_kw = dict(TINY, net_file=ckpt, output_dir=str(tmp_path / "o"),
                       vis_workers=0, batch_size=2)
        port = get_model("genre_full_model", test=True)(
            default_opt(device="cpu", **test_kw))
        jmt = jax_model("genre_full_model", test=True)(jax_opt(**test_kw))
        rgb, sil = scene_inputs(2, TINY["im_size"], seed=2)
        got = port.predict_step({"rgb": rgb, "silhou": sil})["pred_voxel"]
        ref = np.asarray(jmt.predict_step(jmt.state, {
            "rgb": rgb, "silhou": sil})["pred_voxel"])
        assert np.isfinite(got.numpy()).all() and got.shape == ref.shape
        d = np.abs(got.numpy() - ref)
        # eval-mode float32 forward; voxel-face crossings as in the CLI
        # test of the inference path
        assert (d <= 1e-3 * max(np.abs(ref).max(), 1.0)).mean() >= 0.999
    finally:
        shutil.rmtree(logdir, ignore_errors=True)


def test_cli_train_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda is valid here")
    from genre_shapehd_tpu_torch.cli import train
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--net", "genre_full_model", "--dataset", "synthetic",
                    "--logdir", str(tmp_path / "logs"), "--epoch", "1"])
    assert not os.path.exists(tmp_path / "logs")
