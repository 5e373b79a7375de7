"""PyTorch port, GenRe's staged training against the JAX package at
64² -> 32³ (sph_res 32, z_res 64) on procedural scenes, float32, on the
CPU: a MarrNet-1 train step with and without ``--pred_depth_minmax``, the
parameter trees of ``--decoder_width`` and ``--f32_heads``, a
``depth_pred_with_sph_inpaint`` train step with net1 frozen, the oracle
flags, ``pack_output``, ``--net1_path`` with checkpoints of either
package, and the three stages chained through ``cli.train``.

The JAX reference of a train step runs in float64 with Flax's two-pass
batch variance (``jax_step``); the port in float32, held to the
tolerances of ``tests/test_torch_port_train.py``.
"""

import functools
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from genre_shapehd_tpu.core.checkpoint import load_checkpoint as jax_load
from genre_shapehd_tpu.core.checkpoint import save_checkpoint as jax_save
from genre_shapehd_tpu.core.registry import get_model as jax_model
from genre_shapehd_tpu.data import procedural as jax_procedural
from genre_shapehd_tpu.data.loader import collate as jax_collate
from genre_shapehd_tpu.models.base import default_opt as jax_opt
from genre_shapehd_tpu.train.state import (ModelState,
                                          state_to_reference_payload)
from genre_shapehd_tpu_torch.core.checkpoint import load_checkpoint
from genre_shapehd_tpu_torch.core.convert import jax_to_torch, torch_to_jax
from genre_shapehd_tpu_torch.core.registry import get_dataset, get_model
from genre_shapehd_tpu_torch.data import procedural
from genre_shapehd_tpu_torch.data.loader import collate
from genre_shapehd_tpu_torch.models.base import default_opt
from genre_shapehd_tpu_torch.train.loop import Trainer

from _torch_port_util import calibrate, check_step, jax_step

torch.set_num_threads(4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGED = dict(im_size=64, vox_res=32, sph_res=32, z_res=64,
              padding_margin=16)
BATCH = 4
LR = 1e-4
#: subprocesses keep their scenes in memory only and use 2 threads (the
#: test run shares the host's cores between its workers)
SUBPROCESS_ENV = dict(os.environ, GENRE_PROCEDURAL_CACHE="",
                      OMP_NUM_THREADS="2")


@pytest.fixture(autouse=True, scope="module")
def _no_disk_cache():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (procedural, jax_procedural):
            mp.setattr(mod.Dataset, "disk_cache_dir", "")
        yield


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


def _models(net, **flags):
    kw = dict(STAGED, lr=LR, no_aug=True, batch_size=BATCH,
              procedural_length=8, **flags)
    return (jax_model(net)(jax_opt(**kw)),
            get_model(net)(default_opt(device="cpu", **kw)))


def _batches(jm, tm):
    """The first training batch of each package's procedural dataset
    (the same scenes), as arrays."""
    out = []
    for pkg, model, make in ((jax_procedural.Dataset, jm, jax_collate),
                             (get_dataset("procedural"), tm, collate)):
        ds = pkg(model.opt, "train", model=model)
        b = make([ds[i] for i in range(BATCH)])
        out.append({k: v for k, v in b.items() if isinstance(v, np.ndarray)})
    ref, got = out
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    return got


@functools.lru_cache(maxsize=2)
def _marrnet1(minmax):
    jm, tm = _models("marrnet1", pred_depth_minmax=minmax)
    state = jm.init_state(jax.random.PRNGKey(0))
    batch = _batches(jm, tm)
    return jm, tm, state, batch, jax_step(jm, state, batch)


@pytest.mark.parametrize("minmax", [False, True])
def test_marrnet1_train_step_matches_jax(minmax):
    jm, tm, state, batch, ref = _marrnet1(minmax)
    tm.init_state(0)
    tm.load_weights(_to_np(state.params["net"]),
                    _to_np(state.batch_stats["net"]))
    before = {k: v.clone() for k, v in tm.net.state_dict().items()}
    got = tm.train_step(batch)
    assert ("depth_minmax" in got) == minmax
    check_step(tm.net, ref, before, got, LR, {"": (0.999, 0.01)})


@pytest.mark.parametrize("net,flags", [
    ("marrnet1", dict(pred_depth_minmax=True, decoder_width=1.5)),
    ("marrnet1", dict(f32_heads=True)),
    ("depth_pred_with_sph_inpaint", dict(decoder_width=1.5,
                                         f32_heads=True))])
def test_net1_flags_build_the_jax_tree(net, flags):
    """``--decoder_width`` and ``--f32_heads`` give the JAX package's
    parameter tree (names and shapes); under a bfloat16 autocast the f32
    heads' outputs stay float32."""
    jm, tm = _models(net, **flags, dtype="bfloat16")
    s = STAGED["im_size"]
    args = (np.zeros((1, s, s, 3), np.float32),)
    if net != "marrnet1":
        args += (np.zeros((1, s, s, 1), np.float32),)
    shapes = jax.eval_shape(lambda: jm.net.init(jax.random.PRNGKey(0),
                                                *args, train=False))
    ref = {k: tuple(v.shape) for k, v in jax_to_torch(
        jax.tree.map(lambda x: np.zeros(x.shape, np.float32),
                     shapes["params"]),
        jax.tree.map(lambda x: np.zeros(x.shape, np.float32),
                     shapes["batch_stats"])).items()}
    got = {k: tuple(v.shape) for k, v in tm.net.state_dict().items()}
    assert got == ref
    net1 = tm.net if net == "marrnet1" else tm.net.net1
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        out = net1(torch.zeros(2, s, s, 3))
    want = torch.float32 if flags.get("f32_heads") else torch.bfloat16
    assert {k: v.dtype for k, v in out.items()} == dict.fromkeys(out, want)


@functools.lru_cache(maxsize=1)
def _stage2():
    """The stage-2 model of both packages with calibrated weights (so
    that the geometry between the nets sees many points), the batch, and
    the JAX step."""
    jm, tm = _models("depth_pred_with_sph_inpaint")
    state = jm.init_state(jax.random.PRNGKey(0))
    batch = _batches(jm, tm)
    params, stats = calibrate(_to_np(state.params["net"]),
                              _to_np(state.batch_stats["net"]),
                              batch["rgb"], batch["silhou"], cfg=STAGED,
                              stage2=True)
    state = state.replace(params={"net": params})
    return jm, tm, params, stats, batch, jax_step(jm, state, batch)


def test_depth_inpaint_train_step_matches_jax():
    """Non-joint: the spherical loss trains net2 only.  Every net1
    gradient is exactly 0 in both packages, and net1's weights and
    BatchNorm statistics stay bit for bit."""
    jm, tm, params, stats, batch, ref = _stage2()
    tm.init_state(0)
    tm.load_weights(params, stats)
    assert ref["pred"]["proj_depth"].max() > -49.0      # points in the cube
    before = {k: v.clone() for k, v in tm.net.state_dict().items()}
    got = tm.train_step(batch)
    check_step(tm.net, ref, before, got, LR,
               {"net1.": None, "net2.": (0.995, 0.03)})
    sd = tm.net.state_dict()
    for k, v in before.items():
        if k.startswith("net1."):
            assert torch.equal(sd[k], v), k
    for k, v in jax_to_torch({}, ref["stats"]).items():
        if k.startswith("net1.") and "running_" in k:
            assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("net,flag", [
    ("depth_pred_with_sph_inpaint", "gt_depth_input"),
    ("depth_pred_with_sph_inpaint", "gt_minmax_input"),
    ("depth_pred_with_sph_inpaint", "load_offline"),
    ("genre_full_model", "gt_sph_full")])
def test_oracle_flags_match_jax(net, flag):
    """Each oracle's eval-mode forward gives JAX's ``proj_depth`` (5e-2)
    and ``pred_sph_full`` (2e-3) at the same weights and batch; the
    oracles really take the ground truth in."""
    jm, tm = _models(net, **{flag: True})
    _, _, params, stats, _, _ = _stage2()
    if net == "genre_full_model":
        tm.init_state(0)
        full, full_stats = torch_to_jax(tm.net.state_dict())
        full["depth_and_inpaint"], full_stats["depth_and_inpaint"] = \
            params, stats
        params, stats = full, full_stats
    batch = _batches(jm, tm)
    ref, _ = jax.jit(jm._forward, static_argnums=3)(params, stats, batch,
                                                     False)
    ref = _to_np(ref)
    tm.load_weights(params, stats)
    _, got = tm.eval_step(batch)
    got = {k: v.numpy() for k, v in got.items()}
    for k, tol in (("pred_sph_full", 2e-3), ("proj_depth", 5e-2)):
        err = float(np.abs(got[k] - ref[k]).max())
        assert err <= tol, (k, err)
    if flag == "gt_sph_full":
        np.testing.assert_array_equal(got["pred_sph_full"],
                                      batch["spherical_object"])
        for k in ("pred_proj_sph_full", "pred_voxel"):
            d = np.abs(got[k] - ref[k]) <= 1e-3 * max(np.abs(ref[k]).max(), 1)
            assert d.mean() >= 0.999, (k, d.mean())
    elif flag == "load_offline":
        m = STAGED["padding_margin"]
        np.testing.assert_array_equal(
            got["pred_sph_partial"][:, m:-m, m:-m],
            batch["spherical_depth"])
    else:
        # ground-truth min/max: the camera backprojection lands in the cube
        assert (ref["proj_depth"] > -49.0).sum() > 200


@pytest.mark.parametrize("net,flags", [
    ("marrnet1", dict(pred_depth_minmax=True)),
    ("depth_pred_with_sph_inpaint", {}),
    ("genre_full_model", dict(joint_train=True))])
def test_pack_output_matches_jax(net, flags):
    """``pack_output`` (``postprocess`` and ``mask`` of the 2.5D maps,
    the spherical maps, the voxels, the ground truths) gives the JAX
    package's arrays for the same predictions and batch."""
    jm, tm = _models(net, **flags)
    rng = np.random.default_rng(5)
    n, s, r = 2, STAGED["im_size"], STAGED["vox_res"]
    p = STAGED["sph_res"] + 2 * STAGED["padding_margin"]
    shapes = dict(normal=(n, s, s, 3), depth=(n, s, s, 1),
                  silhou=(n, s, s, 1), depth_minmax=(n, 2),
                  pred_sph_full=(n, p, p, 1), pred_sph_partial=(n, p, p, 1),
                  proj_depth=(n, r, r, r), pred_voxel=(n, r, r, r),
                  pred_proj_depth=(n, r, r, r),
                  pred_proj_sph_full=(n, r, r, r))
    pred = {k: rng.standard_normal(v).astype(np.float32) * 50
            for k, v in shapes.items()}
    batch = {"silhou": (rng.random((n, s, s, 1)) > 0.5).astype(
        np.float32) * 100, "depth_minmax": pred["depth_minmax"] + 1,
        "spherical_object": pred["pred_sph_full"] + 1,
        "voxel": (pred["pred_voxel"] > 0).astype(np.float32),
        "rgb_path": ["procedural://vali/0", "procedural://vali/1"]}
    ref = jm.pack_output(pred, batch)
    got = tm.pack_output({k: torch.from_numpy(v) for k, v in pred.items()},
                         batch)
    assert sorted(got) == sorted(ref)
    assert got.pop("rgb_path") == ref.pop("rgb_path")
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def _port_marrnet1_checkpoint(path):
    """A port MarrNet-1 after one step on the JAX start, through the
    Trainer's checkpoint."""
    _, tm, state, batch, _ = _marrnet1(True)
    tm.init_state(0)
    tm.load_weights(_to_np(state.params["net"]),
                    _to_np(state.batch_stats["net"]))
    tm.train_step(batch)
    Trainer(tm, tm.opt).save(path, 1, 0.5)
    return tm


def test_net1_path_reads_checkpoints_of_either_package(tmp_path):
    """``--net1_path``: a JAX MarrNet-1 checkpoint and a port one load
    into stage 2's net1, whose outputs then equal the standalone
    MarrNet-1's (loaded from the same checkpoint) to 1e-5; net2 keeps its
    seeded init.  The JAX stage-2 model reads the port's checkpoint to
    the same weights."""
    jm, _, state, batch, ref = _marrnet1(True)
    jax_path = str(tmp_path / "jax_net1.pt")
    port_path = str(tmp_path / "port_net1.pt")
    try:
        state = state.replace(batch_stats={"net": jax.tree.map(
            lambda x: np.asarray(x, np.float32), ref["stats"])})
        jax_save(jax_path, state_to_reference_payload(
            state, jm.net_names, jm.optimizer_names, 1, 0.5))
        _port_marrnet1_checkpoint(port_path)
        rgb = torch.from_numpy(batch["rgb"])
        _, plain = _models("depth_pred_with_sph_inpaint")
        plain.init_state(0)
        for path in (jax_path, port_path):
            _, alone = _models("marrnet1", pred_depth_minmax=True)
            alone.init_state(0)
            Trainer(alone, alone.opt).load(path)
            _, tm = _models("depth_pred_with_sph_inpaint", net1_path=path)
            tm.init_state(0)
            tm.net.eval()
            alone.net.eval()
            with torch.no_grad():
                want, got = alone.net(rgb), tm.net.net1(rgb)
            for k, v in want.items():
                scale = max(float(v.abs().max()), 1.0)
                assert float((got[k] - v).abs().max()) <= 1e-5 * scale, k
            sd, ref_sd = tm.net.state_dict(), plain.net.state_dict()
            for k, v in sd.items():
                if k.startswith("net2."):
                    assert torch.equal(v, ref_sd[k]), k

        jm2, _ = _models("depth_pred_with_sph_inpaint")
        empty = ModelState(params={"net": {}}, batch_stats={"net": {}},
                           opt_state={}, step=0)
        state = jm2.load_subnet(empty, "net1", port_path)
        src = load_checkpoint(port_path)["nets"][0]
        for tree, key in ((state.params["net"]["net1"], "params"),
                          (state.batch_stats["net"]["net1"], "batch_stats")):
            for a, b in zip(jax.tree.leaves(_to_np(tree)),
                            jax.tree.leaves(src[key])):
                np.testing.assert_array_equal(a, b)
        assert jax.tree.structure(_to_np(state.params["net"]["net1"])) == \
            jax.tree.structure(src["params"])
        assert jax_load(port_path)["epoch"] == 1
    finally:
        for path in (jax_path, port_path):
            if os.path.exists(path):
                os.remove(path)


def _flat(net):
    """A checkpoint's net as {state_dict key: array}."""
    return {k: v.numpy() for k, v in jax_to_torch(
        net["params"], net["batch_stats"]).items()
        if not k.endswith("num_batches_tracked")}


def _seeded_init(net):
    """The weights ``cli.train --manual_seed 1`` starts ``net`` from."""
    _, tm = _models(net)
    tm.init_state(1)
    return {k: v.numpy() for k, v in tm.net.state_dict().items()}


def _moved(after, before, prefix):
    """Whether a weight under ``prefix`` differs between the two."""
    return any(not np.array_equal(v, before[k]) for k, v in after.items()
               if k.startswith(prefix) and "running_" not in k)


def test_three_stages_chain_through_cli_train(tmp_path):
    """``cli.train`` in a fresh process (which loads no JAX module) runs
    the reference's three scripts on procedural scenes: marrnet1
    --pred_depth_minmax, then depth_pred_with_sph_inpaint --net1_path
    <stage 1>, then genre_full_model --inpaint_path <stage 2>
    --surface_weight 10.  Stage 2 keeps net1 bit for bit (weights and
    BatchNorm statistics) and moves net2; stage 3 keeps the stage-2 net's
    weights and moves the refine net."""
    logdir = str(tmp_path / "logs")
    common = ["--dataset", "procedural", "--procedural_length", "4",
              "--batch_size", "2", "--epoch", "1", "--epoch_batches", "2",
              "--eval_batches", "1", "--workers", "2", "--logdir", logdir,
              "--device", "cpu", "--log_time", "--optim", "adam",
              "--manual_seed", "1", "--save_net", "0"] + [
        f"--{k}={v}" for k, v in STAGED.items() if k != "padding_margin"]
    run = lambda net, lr: os.path.join(                       # noqa: E731
        logdir, f"{net}_procedural_{lr}", "0", "checkpoint.pt")
    ck1, ck2 = run("marrnet1", 0.001), run("depth_pred_with_sph_inpaint",
                                           0.0001)
    stages = [
        ["--net", "marrnet1", "--pred_depth_minmax", "--lr", "1e-3"],
        ["--net", "depth_pred_with_sph_inpaint", "--pred_depth_minmax",
         "--net1_path", ck1, "--lr", "1e-4"],
        ["--net", "genre_full_model", "--pred_depth_minmax",
         "--inpaint_path", ck2, "--surface_weight", "10", "--lr", "1e-4"]]
    code = (
        "import json, sys\n"
        "from genre_shapehd_tpu_torch.cli import train\n"
        "common, stages = json.loads(sys.argv[1])\n"
        "for extra in stages:\n"
        "    assert train.main(extra + common) == 0\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', "
        "'optax', 'genre_shapehd_tpu') or m.startswith('genre_shapehd_tpu.'))"
        "\nprint('jax modules:', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    try:
        res = subprocess.run(
            [sys.executable, "-c", code, json.dumps([common, stages])],
            cwd=REPO, capture_output=True, text=True, timeout=600,
            env=SUBPROCESS_ENV)
        assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
        for net, lr, metric in (("marrnet1", "0.001", "depth_minmax"),
                                ("depth_pred_with_sph_inpaint", "0.0001",
                                 "spherical"),
                                ("genre_full_model", "0.0001",
                                 "voxel_loss")):
            rows = open(os.path.join(logdir, f"{net}_procedural_{lr}", "0",
                                     "epoch_loss.csv")).read().splitlines()
            assert metric in rows[0] and len(rows) == 3, rows
        s1, s2, s3 = (_flat(load_checkpoint(p)["nets"][0])
                      for p in (ck1, ck2, run("genre_full_model", 0.0001)))
        # stage 2: net1 is stage 1's checkpoint, statistics included; net2
        # moved from its seeded init
        assert sorted("net1." + k for k in s1) == sorted(
            k for k in s2 if k.startswith("net1."))
        for k, v in s1.items():
            np.testing.assert_array_equal(s2["net1." + k], v, err_msg=k)
        init2 = _seeded_init("depth_pred_with_sph_inpaint")
        assert _moved(s2, init2, "net2.")
        # stage 3: the stage-2 net's weights and net1's statistics stay,
        # the refine net moved from its seeded init
        for k, v in s2.items():
            if "running_" not in k or k.startswith("net1."):
                np.testing.assert_array_equal(s3["depth_and_inpaint." + k],
                                              v, err_msg=k)
        assert _moved(s3, _seeded_init("genre_full_model"), "refine_net.")
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
