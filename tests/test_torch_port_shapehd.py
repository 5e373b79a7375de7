"""PyTorch port, 3D-WGAN-GP and ShapeHD against the JAX package at
64² -> 32³ on the CPU: ``Conv3D`` / ``Deconv3D`` with and without a bias
(the one-channel ``k4 s2 p1`` deconv on K3's plain version),
``VoxelGenerator`` and ``VoxelDiscriminator``; the WGAN-GP step on the JAX
step's own draws (D's loss and gradient penalty, both nets' gradients, G's
BatchNorm statistics, the skipped G update under ``--gan_d_iter 2`` and
the carried ``err_g``); ShapeHD's loss, train step (only ``net`` moves)
and eval outputs; ``--gan``, ``--marrnet2`` and ``--marrnet1_file`` from
JAX checkpoints; the JAX ``Trainer`` resuming port checkpoints of both;
``cli.test --net shapehd`` against the JAX ``ModelTest``; and the family's
four models chained through ``cli.train`` on procedural scenes.

Both packages run in float32, JAX with Flax's two-pass batch variance;
the tolerances are stated at each check.
"""

import functools
import glob
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch

from genre_shapehd_tpu import nn as jnn
from genre_shapehd_tpu.core.registry import get_model as jax_model
from genre_shapehd_tpu.data import procedural as jax_procedural
from genre_shapehd_tpu.models.base import default_opt as jax_opt
from genre_shapehd_tpu.nn import voxel_nets as jvn
from genre_shapehd_tpu.parallel import mesh as pmesh
from genre_shapehd_tpu.train.loop import Trainer as JaxTrainer
from genre_shapehd_tpu.train.state import ModelState
from genre_shapehd_tpu_torch import nn as tnn
from genre_shapehd_tpu_torch.cli import test as port_cli
from genre_shapehd_tpu_torch.core.checkpoint import load_checkpoint
from genre_shapehd_tpu_torch.core.convert import jax_to_torch, torch_to_jax
from genre_shapehd_tpu_torch.core.registry import get_dataset, get_model
from genre_shapehd_tpu_torch.data import procedural
from genre_shapehd_tpu_torch.models.base import default_opt
from genre_shapehd_tpu_torch.train.loop import Trainer

from _torch_port_util import (exact_flax_variance, grad_agreement,
                              jax_test_outputs, procedural_batch,
                              release_memory, save_jax_state, to_np,
                              write_photos)

torch.set_num_threads(4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = dict(im_size=64, vox_res=32, sph_res=32, z_res=64, padding_margin=16)
BATCH = 4
LR = 1e-4
SUBPROCESS_ENV = dict(os.environ, GENRE_PROCEDURAL_CACHE="",
                      OMP_NUM_THREADS="2")


@pytest.fixture(autouse=True, scope="module")
def _no_disk_cache():
    """No on-disk scene cache; at the end, the module's cached models and
    the memory they held are let go (a test worker runs other files after
    this one)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (procedural, jax_procedural):
            mp.setattr(mod.Dataset, "disk_cache_dir", "")
        yield
    _wgangp_steps.cache_clear()
    _shapehd.cache_clear()
    release_memory()


def _models(net, **flags):
    kw = dict(DIMS, lr=LR, no_aug=True, batch_size=BATCH,
              procedural_length=8, **flags)
    return (jax_model(net)(jax_opt(**kw)),
            get_model(net)(default_opt(device="cpu", **kw)))


def _close(got, ref, tol, what):
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(np.asarray(got, np.float64) - ref).max())
    assert err <= tol * scale, (what, err, scale)


def _with_random_biases(params, seed):
    """A copy of a JAX-layout tree with every bias drawn ~ N(0, 1)."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else (
            rng.standard_normal(v.shape).astype(np.float32)
            if k == "bias" else np.array(v)) for k, v in tree.items()}
    return walk(params)


@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("layer", ["conv", "deconv_final", "deconv"])
def test_conv_layers_match_jax(layer, use_bias):
    """``Conv3D(3 -> 6, k4 s2 p1)``, ``Deconv3D(5 -> 1, k4 s2 p1)`` (K3's
    route, its plain version here) and ``Deconv3D(5 -> 6, k4 s2 p1)``
    with and without a bias: the parameter tree of the Flax layer, and its
    output within 1e-5 of the scale."""
    rng = np.random.default_rng(2)
    cin = 3 if layer == "conv" else 5
    x = rng.standard_normal((2, 8, 8, 8, cin)).astype(np.float32)
    if layer == "conv":
        jmod = jvn.Conv3D(6, 4, 2, 1, use_bias=use_bias)
        tmod = tnn.Conv3D(cin, 6, 4, 2, 1, use_bias=use_bias)
    else:
        feat = 1 if layer == "deconv_final" else 6
        jmod = jvn.Deconv3D(feat, 4, 2, 1, use_bias=use_bias)
        tmod = tnn.Deconv3D(cin, feat, 4, 2, 1, use_bias=use_bias)
    params = _with_random_biases(to_np(jmod.init(jax.random.PRNGKey(0),
                                                 x)["params"]), 3)
    sd = jax_to_torch(params, {})
    assert sorted(sd) == sorted(tmod.state_dict())
    tmod.load_state_dict(sd)
    ref = np.asarray(jmod.apply({"params": params}, x))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    _close(got.permute(0, 2, 3, 4, 1).numpy(), ref, 1e-5, layer)


@pytest.mark.parametrize("train", [False, True])
def test_generator_and_discriminator_match_jax(train):
    """``VoxelGenerator`` (nz 200, nf 64, 32³; no bias; its last layer on
    K3's plain version) in eval and train mode, its moved statistics, and
    ``VoxelDiscriminator`` (nf 64, 32³) on its output: within 1e-4 of
    their scales."""
    rng = np.random.default_rng(5)
    z = rng.standard_normal((2, 200)).astype(np.float32)
    jg, tg = jnn.VoxelGenerator(200, 64, 32), tnn.VoxelGenerator(200, 64, 32)
    jd, td = jnn.VoxelDiscriminator(64, 32), tnn.VoxelDiscriminator(64, 32)
    gv = to_np(jax.jit(lambda r: jg.init(r, z, train=False))(
        jax.random.PRNGKey(1)))
    dv = to_np(jax.jit(lambda r: jd.init(r, np.zeros((1, 32, 32, 32),
                                                       np.float32)))(
        jax.random.PRNGKey(2)))
    tg.load_state_dict(jax_to_torch(gv["params"], gv["batch_stats"]))
    td.load_state_dict(jax_to_torch(dv["params"], {}))
    tg.train(train)
    with exact_flax_variance():
        if train:
            gen, mut = jax.jit(lambda v, z: jg.apply(
                v, z, train=True, mutable=["batch_stats"]))(gv, z)
            stats = mut["batch_stats"]
        else:
            gen = jax.jit(lambda v, z: jg.apply(v, z, train=False))(gv, z)
            stats = gv["batch_stats"]
        score = jax.jit(jd.apply)(dv, gen)
    with torch.no_grad():
        tgen = tg(torch.from_numpy(z))
        tscore = td(torch.from_numpy(np.array(gen)))
    _close(tgen.numpy(), np.asarray(gen), 1e-4, "generator")
    _close(tscore.numpy(), np.asarray(score), 1e-4, "discriminator")
    sd = tg.state_dict()
    for k, v in jax_to_torch({}, to_np(stats)).items():
        if "running_" in k:
            _close(sd[k].numpy(), v.numpy(), 1e-4, k)


def _draws(rng, b, nz=200):
    """The JAX step's own z1, alpha, z2 (``jax.random.split(rng, 3)``)."""
    k1, k2, k3 = jax.random.split(rng, 3)
    return tuple(np.array(a) for a in (
        jax.random.normal(k1, (b, nz)),
        jax.random.uniform(k2, (b, 1, 1, 1)),
        jax.random.normal(k3, (b, nz))))


def _solids(n, res, seed):
    """(n, res, res, res) occupancy: a random ellipsoid each."""
    rng = np.random.default_rng(seed)
    c = (np.arange(res) + 0.5) / res - 0.5
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    out = []
    for _ in range(n):
        a = rng.uniform(0.15, 0.4, 3)
        out.append(((x / a[0]) ** 2 + (y / a[1]) ** 2 + (z / a[2]) ** 2
                    < 1.0).astype(np.float32))
    return np.stack(out)


def _adam_mu(opt_state):
    return to_np(opt_state[0].mu)


@functools.lru_cache(maxsize=1)
def _wgangp_steps():
    """Two JAX WGAN-GP steps under --gan_d_iter 2 (G updated at step 0,
    skipped at step 1), their draws, and the trees before and after."""
    jm, _ = _models("wgangp", canon_voxel=True, gan_d_iter=2)
    state = jm.init_state(jax.random.PRNGKey(0))
    batch = {"voxel_canon": _solids(BATCH, 32, 1)}
    rngs = (jax.random.PRNGKey(7), jax.random.PRNGKey(8))
    step = jax.jit(jm.train_step)
    states, metrics = [state], []
    with exact_flax_variance():
        for rng in rngs:
            state, m = step(state, batch, rng)
            states.append(state)
            metrics.append(to_np(m))
    return jm, batch, [_draws(r, BATCH) for r in rngs], states, metrics


def _grads_of(mu, mu_prev, b1=0.5):
    """Adam's first moment after a step: b1 mu_prev + (1 - b1) g."""
    return jax.tree.map(lambda m, p: (m - b1 * p) / (1 - b1), mu, mu_prev)


def test_wgangp_steps_match_jax_on_its_draws():
    """Two port steps, each from the JAX step's start, on the JAX steps'
    draws: every
    metric (D's terms and gradient penalty, err_g; rtol 1e-4), D's
    gradients at both steps and G's at step 0 (read from Adam's first
    moment in JAX; worst cosine 0.999, norm ratio within 1 %), G's
    statistics after two updates and after the D phase alone (1e-4 of
    their scale); at step 1 (--gan_d_iter 2) G's weights stay bit for bit
    and err_g is step 0's, carried."""
    jm, batch, draws, states, metrics = _wgangp_steps()
    _, tm = _models("wgangp", canon_voxel=True, gan_d_iter=2)
    tm.init_state(0)
    tbatch = {"voxel_canon": torch.from_numpy(batch["voxel_canon"])}
    for i in range(2):
        # each step from the JAX step's start (Adam's first steps, about
        # lr sign(g), would carry float32 differences of tiny gradients)
        for name, net in tm.net_modules().items():
            net.load_state_dict(jax_to_torch(
                to_np(states[i].params[name]),
                to_np(states[i].batch_stats[name])))
        g_before = {k: v.clone() for k, v in tm.net_g.state_dict().items()}
        got = tm.train_step(tbatch, tuple(torch.from_numpy(d)
                                          for d in draws[i]))
        ref = metrics[i]
        assert sorted(got) == sorted(ref)
        for k, v in ref.items():
            np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4,
                                       err_msg=f"step {i} {k}")
        for name in (("net_d", "net_g") if i == 0 else ("net_d",)):
            mu = _adam_mu(states[i + 1].opt_state[name])
            prev = _adam_mu(states[i].opt_state[name])
            cos, ratio, stray = grad_agreement(
                tm.net_modules()[name], _grads_of(mu, prev), "")
            assert cos >= 0.999 and ratio <= 0.01 and stray <= 1e-4, (
                i, name, cos, ratio, stray)
        sd = tm.net_g.state_dict()
        for k, v in jax_to_torch({}, to_np(
                states[i + 1].batch_stats["net_g"])).items():
            if "running_" in k:
                _close(sd[k].numpy(), v.numpy(), 1e-4, f"step {i} {k}")
        if i == 1:
            for k, v in g_before.items():
                if "running_" not in k and "num_batches" not in k:
                    assert torch.equal(sd[k], v), k
            assert float(got["err_g"]) == float(err_g0)
            assert float(ref["err_g"]) == float(metrics[0]["err_g"])
        err_g0 = got["err_g"]


@functools.lru_cache(maxsize=1)
def _shapehd():
    """Both packages' ShapeHD (w_gan_loss 0.5, so that the critic's term
    counts) from the JAX start, the batch, and the JAX step's loss terms,
    gradients, statistics and predictions."""
    jm, tm = _models("shapehd", canon_sup=True, w_gan_loss=0.5)
    state = jm.init_state(jax.random.PRNGKey(0))
    batch = procedural_batch(jm, tm, BATCH)
    with exact_flax_variance():
        grads, (loss, stats, pred) = jax.jit(
            jax.grad(jm._loss, has_aux=True), static_argnums=3)(
                state.params["net"], state, batch, True)
        _, (_, _, eval_pred) = jax.jit(jm._loss, static_argnums=3)(
            state.params["net"], state, batch, False)
    return jm, tm, state, batch, to_np(dict(
        grads=grads, loss=loss, stats=stats, pred=pred, eval=eval_pred))


def _port_shapehd_from(state, tm):
    tm.init_state(0)
    for name, net in tm.net_modules().items():
        net.load_state_dict(jax_to_torch(to_np(state.params[name]),
                                         to_np(state.batch_stats[name])))


def test_shapehd_train_step_matches_jax_and_moves_net_only():
    """ShapeHD's train step from the JAX start: the loss terms (sup, gan,
    loss; rtol 1e-4), ``net``'s gradients (worst cosine 0.999, norm ratio
    within 1 %) and statistics (1e-4 of their scale); ``net_noft`` and
    ``net_d`` stay bit for bit, and their parameters take no gradient."""
    jm, tm, state, batch, ref = _shapehd()
    _port_shapehd_from(state, tm)
    before = {name: {k: v.clone() for k, v in net.state_dict().items()}
              for name, net in tm.net_modules().items()}
    got = tm.train_step(batch)
    assert sorted(got) == sorted(ref["loss"]) == ["gan", "loss", "sup"]
    for k, v in ref["loss"].items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4,
                                   err_msg=k)
    assert abs(float(got["gan"])) > 1e-3 * float(got["sup"])
    cos, ratio, stray = grad_agreement(tm.net, ref["grads"], "")
    assert cos >= 0.999 and ratio <= 0.01 and stray <= 1e-4, (cos, ratio)
    sd = tm.net.state_dict()
    for k, v in jax_to_torch({}, ref["stats"]).items():
        if "running_" in k:
            _close(sd[k].numpy(), v.numpy(), 1e-4, k)
    assert any(not torch.equal(v, before["net"][k]) for k, v in sd.items())
    for name in ("net_noft", "net_d"):
        net = tm.net_modules()[name]
        assert all(p.grad is None and not p.requires_grad
                   for p in net.parameters())
        for k, v in net.state_dict().items():
            assert torch.equal(v, before[name][k]), (name, k)


def test_shapehd_eval_and_loss_match_jax():
    """In eval mode the finetuned and the frozen net's voxels and their
    critic scores are the JAX package's (1e-4 of their scales), and
    ``compute_loss`` on the same predictions too (rtol 1e-5)."""
    jm, tm, state, batch, ref = _shapehd()
    _port_shapehd_from(state, tm)
    losses, got = tm.eval_step(batch)
    assert sorted(got) == sorted(ref["eval"])
    for k, v in ref["eval"].items():
        _close(got[k].numpy(), v, 1e-4, k)
    rng = np.random.default_rng(8)
    pred = {"voxel": rng.standard_normal((2, 32, 32, 32)).astype(
        np.float32), "is_real": rng.standard_normal(2).astype(np.float32)}
    gt = {"voxel_canon": (rng.random((2, 32, 32, 32)) > 0.6).astype(
        np.float32)}
    want, want_terms = jm.compute_loss(pred, gt)
    have, terms = tm.compute_loss(
        {k: torch.from_numpy(v) for k, v in pred.items()},
        {k: torch.from_numpy(v) for k, v in gt.items()})
    for k in ("loss", "sup", "gan"):
        np.testing.assert_allclose(float(terms[k]), float(want_terms[k]),
                                   rtol=1e-5, err_msg=k)


def test_wgangp_and_shapehd_dataset_contract_matches_jax():
    """``requires``, ``gt_names``, ``metrics`` and the procedural sample
    as the JAX models' (WGAN-GP without preprocessing)."""
    for net, flags in (("wgangp", dict(canon_voxel=True)),
                       ("shapehd", dict(canon_sup=True))):
        jm, tm = _models(net, **flags)
        assert tm.requires == jm.requires, net
        assert tm.gt_names == jm.gt_names and tm.metrics == jm.metrics
        assert (tm.preprocess is None) == (jm.preprocess is None)
        a = get_dataset("procedural")(tm.opt, "train", model=tm)[2]
        b = jax_procedural.Dataset(jm.opt, "train", model=jm)[2]
        assert sorted(a) == sorted(b)
        for k, v in b.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(a[k], v, err_msg=k)


def test_jax_trainer_resumes_port_wgangp_and_shapehd_checkpoints(tmp_path):
    """Port checkpoints after two steps, loaded by the JAX ``Trainer``:
    WGAN-GP's two nets, two optax Adam states (count 2) and ``last_err_g``;
    ShapeHD's three nets and one Adam state.  Given the port's next
    gradients, the JAX optimizers take the port's next steps (Adam's
    arithmetic in float32 in both: within 1e-3 lr plus one ulp of the
    parameter)."""
    from optax._src.transform import ScaleByAdamState
    jmw, tmw = _models("wgangp", canon_voxel=True)
    tmw.init_state(0)
    wbatch = {"voxel_canon": torch.from_numpy(_solids(2, 32, 4))}
    jms, tms = _models("shapehd", canon_sup=True, w_gan_loss=0.5)
    tms.init_state(0)
    sbatch = procedural_batch(jms, tms, 2)
    path = str(tmp_path / "checkpoint.pt")
    for model, jm, batch, opt_names in ((tmw, jmw, wbatch,
                                         ("net_g", "net_d")),
                                        (tms, jms, sbatch, ("net",))):
        for _ in range(2):
            model.train_step(batch)
        Trainer(model, model.opt).save(path, 2, 0.7)
        # on one of the 8 virtual CPU devices: replicated on all 8, the
        # states of both models took 11 GB
        trainer = JaxTrainer(jm, jm.opt,
                             mesh=pmesh.make_mesh(jax.devices()[:1]))
        trainer.initialize(jax.random.PRNGKey(0))
        trainer.load(path)
        os.remove(path)                  # 0.5 GB
        st = trainer.state
        assert trainer.start_epoch == 2
        for name, net in model.net_modules().items():
            want = {k: v.numpy() for k, v in net.state_dict().items()
                    if "num_batches" not in k}
            got = jax_to_torch(to_np(st.params[name]),
                               to_np(st.batch_stats.get(name) or {}))
            for k, v in want.items():
                np.testing.assert_array_equal(got[k].numpy(), v,
                                              err_msg=f"{name}.{k}")
        if model is tmw:
            np.testing.assert_array_equal(
                np.asarray(st.extra["last_err_g"]),
                np.float32(model.last_err_g))
        entries = model.optimizer_entries()
        before = {n: {k: v.clone() for k, v in entries[n][1].state_dict()
                      .items()} for n in opt_names}
        model.train_step(batch)
        for name in opt_names:
            opt_state, params = st.opt_state[name], st.params[name]
            tx = {"net_g": getattr(jm, "tx_g", None),
                  "net_d": getattr(jm, "tx_d", None),
                  "net": getattr(jm, "tx", None)}[name]
            assert jax.tree.structure(opt_state) == jax.tree.structure(
                tx.init(params))
            assert type(opt_state[0]) is ScaleByAdamState
            assert int(opt_state[0].count) == 2
            net = entries[name][1]
            grads = {n: p.grad for n, p in net.named_parameters()}
            updates, _ = tx.update(torch_to_jax(grads)[0], opt_state, params)
            after = jax_to_torch(to_np(optax.apply_updates(params, updates)),
                                 {})
            sd = net.state_dict()
            for k, v in after.items():
                p0 = before[name][k].numpy()
                d = np.abs((sd[k] - before[name][k]).numpy()
                           - (v.numpy() - p0))
                assert (d <= 1e-3 * LR + np.spacing(np.abs(p0))).all(), (
                    name, k, d.max())
        del trainer, st


def test_port_loads_jax_checkpoints_through_gan_and_marrnet2(tmp_path):
    """``--marrnet2`` and ``--gan`` with checkpoints the JAX package
    wrote: ``net`` and ``net_noft`` equal the MarrNet-2 checkpoint and
    ``net_d`` the WGAN-GP checkpoint's second net, bit for bit."""
    jm2, _ = _models("marrnet2")
    m2 = jm2.init_state(jax.random.PRNGKey(3))
    jmw, _ = _models("wgangp", canon_voxel=True)
    w = jmw.init_state(jax.random.PRNGKey(4))
    paths = {k: str(tmp_path / f"{k}.pt") for k in ("marrnet2", "wgangp")}
    save_jax_state(paths["marrnet2"], jm2, m2, with_optimizers=False)
    save_jax_state(paths["wgangp"], jmw, w, with_optimizers=False)
    _, tm = _models("shapehd", canon_sup=True, marrnet2=paths["marrnet2"],
                    gan=paths["wgangp"])
    tm.init_state(0)
    want = {"net": jax_to_torch(to_np(m2.params["net"]),
                                to_np(m2.batch_stats["net"])),
            "net_d": jax_to_torch(to_np(w.params["net_d"]), {})}
    want["net_noft"] = want["net"]
    for name, net in tm.net_modules().items():
        for k, v in net.state_dict().items():
            if "num_batches" not in k:
                assert torch.equal(v, want[name][k]), (name, k)
    for path in paths.values():
        os.remove(path)


def test_cli_test_shapehd_matches_jax(tmp_path):
    """``cli.test --net shapehd --marrnet1_file`` with checkpoints the JAX
    package wrote (ShapeHD's three nets, MarrNet-1) on three photos: the
    JAX ``ModelTest``'s ``.npz`` keys and arrays (cv2 against the port's
    resize, then float32 nets: 99.9 % of the values within 1e-3 of their
    scale, the mean within 1e-4) and the same visualizer files."""
    photos = str(tmp_path / "photos")
    write_photos(photos, 3)
    rgb_glob = os.path.join(photos, "*_rgb.png")
    mask_glob = os.path.join(photos, "*_silhouette.png")
    jm, _, state, _, _ = _shapehd()
    ckpt = str(tmp_path / "shapehd.pt")
    save_jax_state(ckpt, jm, state, with_optimizers=False)
    jm1, tm1 = _models("marrnet1", pred_depth_minmax=True)
    tm1.init_state(5)
    params, stats = torch_to_jax(tm1.net.state_dict())
    # MarrNet-1's silhouette decoder scaled so that the 0.3 x 100 mask
    # keeps part of each photo
    layer = params["decoder_silhou"]["Deconv_1"]["ConvTranspose_0"]
    layer["kernel"] = layer["kernel"] * np.float32(40.0)
    m1 = str(tmp_path / "marrnet1.pt")
    save_jax_state(m1, jm1, ModelState(
        params={"net": params}, batch_stats={"net": stats}, opt_state={},
        step=0), with_optimizers=False)
    jax_out = str(tmp_path / "jax_out")
    jax_test_outputs("shapehd", jax_opt(
        batch_size=2, vis_workers=0, workers=2, net_file=ckpt,
        marrnet1_file=m1, input_rgb=rgb_glob, input_mask=mask_glob,
        **DIMS), jax_out)
    port_out = str(tmp_path / "port_out")
    assert port_cli.main([
        "--net", "shapehd", "--net_file", ckpt, "--marrnet1_file", m1,
        "--input_rgb", rgb_glob, "--input_mask", mask_glob,
        "--output_dir", port_out, "--batch_size", "2", "--workers", "2",
        "--device", "cpu"] + [
        # GenRe's --padding_margin is no ShapeHD flag, in either package
        f"--{k}={v}" for k, v in DIMS.items() if k != "padding_margin"]
    ) == 0
    names = sorted(os.path.basename(p) for p in
                   glob.glob(os.path.join(port_out, "*.npz")))
    assert names == ["batch0000.npz", "batch0001.npz"]
    fg = []
    for name in names:
        ref = np.load(os.path.join(jax_out, name))
        got = np.load(os.path.join(port_out, name))
        assert sorted(got.files) == sorted(ref.files) == sorted(
            ["rgb_path", "rgb", "pred_silhou", "pred_normal", "pred_depth",
             "pred_voxel", "pred_voxel_noft"])
        for k in got.files:
            if k == "rgb_path":
                assert list(got[k]) == list(ref[k])
                continue
            g, r = got[k], ref[k]
            assert g.shape == r.shape and np.isfinite(g).all(), k
            d = np.abs(g - r)
            scale = max(float(np.abs(r).max()), 1e-3)
            assert (d <= 1e-3 * scale).mean() >= 0.999, (k, d.max())
            assert d.mean() <= 1e-4 * scale, (k, d.mean())
        fg.append(float((ref["pred_silhou"] > 0.3).mean()))
    assert 0.02 < min(fg) and max(fg) < 0.98, fg
    for batch_dir in ("batch0000", "batch0001"):
        assert sorted(os.listdir(os.path.join(port_out, batch_dir))) == \
            sorted(os.listdir(os.path.join(jax_out, batch_dir)))
    for path in (ckpt, m1):
        os.remove(path)


def _flat(path, index=0):
    net = load_checkpoint(path)["nets"][index]
    return {k: v.numpy() for k, v in jax_to_torch(
        net["params"], net.get("batch_stats") or {}).items()
        if not k.endswith("num_batches_tracked")}


def test_family_chains_through_cli_train(tmp_path):
    """``cli.train --device cpu`` in a fresh process (which loads no JAX
    module) on procedural scenes, 2 steps each: marrnet1
    --pred_depth_minmax; marrnet2 --canon_sup; wgangp --canon_voxel
    --gan_d_iter 2; shapehd --canon_sup --marrnet2 <marrnet2> --gan
    <wgangp> --w_gan_loss 1e-3; marrnet --canon_sup --marrnet1 <marrnet1>
    --marrnet2 <marrnet2>.  Every metric is logged; WGAN-GP writes two
    nets, two Adam states (G's count 1 under --gan_d_iter 2, D's 2) and
    ``last_err_g``; ShapeHD keeps ``net_noft`` equal to the MarrNet-2
    checkpoint and ``net_d`` to the critic, bit for bit, and moves
    ``net``; MarrNet keeps MarrNet-1 equal to its checkpoint, statistics
    included, and moves MarrNet-2."""
    logdir = str(tmp_path / "logs")
    common = ["--dataset", "procedural", "--procedural_length", "4",
              "--batch_size", "2", "--epoch", "1", "--epoch_batches", "2",
              "--eval_batches", "1", "--workers", "2", "--logdir", logdir,
              "--device", "cpu", "--manual_seed", "1", "--save_net", "0",
              "--lr", "1e-3"] + [
        f"--{k}={v}" for k, v in DIMS.items() if k != "padding_margin"]
    ck = {net: os.path.join(logdir, f"{net}_procedural_0.001", "0",
                            "checkpoint.pt")
          for net in ("marrnet1", "marrnet2", "wgangp", "shapehd",
                      "marrnet")}
    runs = [
        ["--net", "marrnet1", "--pred_depth_minmax"],
        ["--net", "marrnet2", "--canon_sup"],
        ["--net", "wgangp", "--canon_voxel", "--gan_d_iter", "2"],
        ["--net", "shapehd", "--canon_sup", "--marrnet2", ck["marrnet2"],
         "--gan", ck["wgangp"], "--w_gan_loss", "1e-3"],
        ["--net", "marrnet", "--canon_sup", "--marrnet1", ck["marrnet1"],
         "--marrnet2", ck["marrnet2"]]]
    # each run's best.pt (after one epoch the same as its checkpoint.pt)
    # is deleted at once: the five checkpoints take ~2 GB
    code = (
        "import glob, json, os, sys\n"
        "from genre_shapehd_tpu_torch.cli import train\n"
        "common, runs, logdir = json.loads(sys.argv[1])\n"
        "for extra in runs:\n"
        "    assert train.main(extra + common) == 0\n"
        "    for p in glob.glob(os.path.join(logdir, '*', '0', 'best.pt')):\n"
        "        os.remove(p)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', "
        "'optax', 'genre_shapehd_tpu') or m.startswith('genre_shapehd_tpu.'))"
        "\nsys.exit(1 if bad else 0)\n")
    try:
        res = subprocess.run(
            [sys.executable, "-c", code, json.dumps([common, runs, logdir])],
            cwd=REPO, capture_output=True, text=True, timeout=600,
            env=SUBPROCESS_ENV)
        assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
        for net, metric in (("marrnet2", "loss"), ("wgangp", "err_d_gp"),
                            ("shapehd", "gan"), ("marrnet", "loss")):
            rows = open(os.path.join(os.path.dirname(ck[net]),
                                     "epoch_loss.csv")).read().splitlines()
            assert metric in rows[0] and len(rows) == 3, (net, rows)
        w = load_checkpoint(ck["wgangp"])
        assert w["net_names"] == w["opt_names"] == ["net_g", "net_d"]
        assert [int(o[0].args[0]) for o in w["optimizers"]] == [1, 2]
        assert np.isfinite(float(w["extra"]["last_err_g"]))
        m2, d = _flat(ck["marrnet2"]), _flat(ck["wgangp"], 1)
        s = {i: _flat(ck["shapehd"], i) for i in range(3)}
        for k, v in m2.items():
            np.testing.assert_array_equal(s[1][k], v, err_msg=k)
        for k, v in d.items():
            np.testing.assert_array_equal(s[2][k], v, err_msg=k)
        assert any(not np.array_equal(s[0][k], v) for k, v in m2.items())
        m1, mn = _flat(ck["marrnet1"]), _flat(ck["marrnet"])
        for k, v in m1.items():
            np.testing.assert_array_equal(mn["marrnet1." + k], v, err_msg=k)
        assert any(not np.array_equal(mn["marrnet2." + k], v)
                   for k, v in m2.items() if "running_" not in k)
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
