"""PyTorch port, MarrNet-2 and MarrNet against the JAX package at
64² -> 32³ on the CPU: ``ResNet18Encoder`` and ``VoxelDecoder`` (eval and
train mode, BatchNorm statistics included), ``Marrnet2Net`` and
``MarrnetNet``, each model's dataset contract, ``compute_loss`` and
``pack_output``, one train step of each (MarrNet-1 frozen bit for bit
inside MarrNet), ``--marrnet1`` / ``--marrnet2`` from checkpoints of
either package, ``cli.test --net marrnet`` against the JAX ``ModelTest``
on the same photos and checkpoint, and the family's quality benchmark,
``tools/qualrun_shapehd_torch.py --tiny --cpu``.

Both packages run in float32, JAX with Flax's two-pass batch variance (a
float64 reference, as the GenRe tests use, costs XLA's CPU convolutions
25 s a MarrNet-2 step).  A forward is held to 1e-4 of its output's
scale, the statistics to 1e-4 of theirs, a train step to
``check_step``'s bounds.
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
import pytest
import torch

from genre_shapehd_tpu.core.registry import get_model as jax_model
from genre_shapehd_tpu.data import procedural as jax_procedural
from genre_shapehd_tpu.models.base import default_opt as jax_opt
from genre_shapehd_tpu.nn import ResNet18Encoder as JaxEncoder
from genre_shapehd_tpu.nn import VoxelDecoder as JaxDecoder
from genre_shapehd_tpu.train.state import ModelState
from genre_shapehd_tpu_torch.cli import test as port_cli
from genre_shapehd_tpu_torch.core.checkpoint import (load_checkpoint,
                                                     net_payload)
from genre_shapehd_tpu_torch.core.checkpoint import save_checkpoint as \
    port_save
from genre_shapehd_tpu_torch.core.convert import jax_to_torch, torch_to_jax
from genre_shapehd_tpu_torch.core.registry import get_dataset, get_model
from genre_shapehd_tpu_torch.data import png, procedural
from genre_shapehd_tpu_torch.models.base import default_opt
from genre_shapehd_tpu_torch.nn import ResNet18Encoder, VoxelDecoder
from genre_shapehd_tpu_torch.train.loop import Trainer

from _torch_port_util import (check_step, exact_flax_variance, jax_step,
                              jax_test_outputs, procedural_batch,
                              release_memory, save_jax_state, to_np,
                              write_photos)

torch.set_num_threads(4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = dict(im_size=64, vox_res=32, sph_res=32, z_res=64, padding_margin=16)
BATCH = 4
LR = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _no_disk_cache():
    """No on-disk scene cache; at the end, the module's cached models and
    the memory they held are let go (a test worker runs other files after
    this one)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (procedural, jax_procedural):
            mp.setattr(mod.Dataset, "disk_cache_dir", "")
        yield
    _setup.cache_clear()
    release_memory()


def _models(net, **flags):
    kw = dict(DIMS, lr=LR, no_aug=True, batch_size=BATCH,
              procedural_length=8, **flags)
    return (jax_model(net)(jax_opt(**kw)),
            get_model(net)(default_opt(device="cpu", **kw)))


def _close(got, ref, tol, what):
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(np.asarray(got) - ref).max())
    assert err <= tol * scale, (what, err, scale)


def _apply(module, variables, args, train):
    """The Flax module (jitted, two-pass variance): (output, batch
    statistics after the call)."""
    with exact_flax_variance():
        if train:
            out, mut = jax.jit(lambda v, *a: module.apply(
                v, *a, train=True, mutable=["batch_stats"]))(
                    variables, *args)
            return to_np(out), to_np(mut["batch_stats"])
        out = jax.jit(lambda v, *a: module.apply(v, *a, train=False))(
            variables, *args)
        return to_np(out), to_np(variables.get("batch_stats", {}))


def test_registry_resolves_the_family():
    for net in ("marrnet2", "marrnet", "wgangp", "shapehd"):
        assert get_model(net).__module__.endswith("models." + net)
    for net in ("marrnet", "shapehd"):
        assert get_model(net, test=True).__name__ == "ModelTest"


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("which", ["encoder", "decoder"])
def test_encoder_and_decoder_match_jax(which, train):
    """``ResNet18Encoder`` (4 channels in, 200 out) and ``VoxelDecoder``
    (200 -> nf 512 at 4³ -> 1 at 32³, the last layer on K3's plain
    version): outputs within 1e-4 of their scale and, in train mode, the
    moved BatchNorm statistics within 1e-4 of theirs."""
    rng = np.random.default_rng(3)
    if which == "encoder":
        x = rng.standard_normal((2, 64, 64, 4)).astype(np.float32)
        jmod, tmod = JaxEncoder(200), ResNet18Encoder(4, 200)
        targ = torch.from_numpy(x).permute(0, 3, 1, 2)
    else:
        x = rng.standard_normal((2, 200)).astype(np.float32)
        jmod, tmod = JaxDecoder(200, 512, 32), VoxelDecoder(200, 512, 32)
        targ = torch.from_numpy(x)
    variables = jax.jit(lambda r: jmod.init(r, x, train=False))(
        jax.random.PRNGKey(1))
    variables = to_np(variables)
    tmod.load_state_dict(jax_to_torch(variables["params"],
                                      variables["batch_stats"]))
    tmod.train(train)
    ref, stats = _apply(jmod, variables, (x,), train)
    with torch.no_grad():
        got = tmod(targ)
    assert got.shape == ref.shape
    _close(got.numpy(), ref, 1e-4, which)
    sd = tmod.state_dict()
    for k, v in jax_to_torch({}, stats).items():
        if "running_" in k:
            _close(sd[k].numpy(), v.numpy(), 1e-4, k)


def _calibrated_marrnet(params, stats, rgb):
    """MarrNet's JAX-layout trees with MarrNet-1's silhouette decoder
    scaled to output std 40 (measured with the port's net in eval mode),
    so that the 0.3 x 100 threshold keeps part of each image."""
    from genre_shapehd_tpu_torch.models.marrnet import MarrnetNet
    params = jax.tree.map(np.array, params)
    net = MarrnetNet(30.0, DIMS["vox_res"], DIMS["im_size"]).eval()
    net.load_state_dict(jax_to_torch(params, stats))
    with torch.no_grad():
        std = float(net(torch.from_numpy(rgb))["silhou"].std())
    layer = params["marrnet1"]["decoder_silhou"]["Deconv_1"][
        "ConvTranspose_0"]
    layer["kernel"] = layer["kernel"] * np.float32(40.0 / std)
    return params, stats


@functools.lru_cache(maxsize=2)
def _setup(net):
    """Both packages' model, the JAX start (MarrNet calibrated), the
    batch, and the JAX train step."""
    jm, tm = _models(net, canon_sup=True)
    state = jm.init_state(jax.random.PRNGKey(0))
    batch = procedural_batch(jm, tm, BATCH)
    params, stats = (to_np(state.params["net"]),
                     to_np(state.batch_stats["net"]))
    if net == "marrnet":
        params, stats = _calibrated_marrnet(params, stats, batch["rgb"])
        state = state.replace(params={"net": params})
    return jm, tm, params, stats, batch, jax_step(jm, state, batch,
                                                  "float32")


@pytest.mark.parametrize("net", ["marrnet2", "marrnet"])
def test_nets_match_jax_in_eval_mode(net):
    """``Marrnet2Net`` on the batch's 2.5D maps and ``MarrnetNet`` on its
    photos give the JAX nets' voxel logits (and MarrNet-1's maps) within
    1e-4 of their scale; MarrNet's mask keeps part of each image."""
    jm, tm, params, stats, batch, _ = _setup(net)
    args = ((batch["rgb"],) if net == "marrnet" else
            (batch["depth"], batch["normal"], batch["silhou"]))
    ref, _ = _apply(jm.net, {"params": params, "batch_stats": stats},
                        args, train=False)
    tm.init_state(0)
    tm.load_weights(params, stats)
    _, got = tm.eval_step(batch)
    if net == "marrnet2":
        ref = {"voxel": ref}
    else:
        fg = (ref["silhou"] > 30.0).mean()
        assert 0.05 < fg < 0.95, fg
    for k, v in ref.items():
        _close(got[k].numpy(), v, 1e-4, k)


@pytest.mark.parametrize("net", ["marrnet2", "marrnet"])
def test_train_step_matches_jax(net):
    """One train step of each model against the JAX step: the
    BCE loss (rtol 1e-4), the gradients, the statistics and Adam's step
    (``check_step``).  Inside MarrNet, MarrNet-1's gradients are 0 in both
    packages and its weights and statistics stay bit for bit."""
    jm, tm, params, stats, batch, ref = _setup(net)
    tm.init_state(0)
    tm.load_weights(params, stats)
    before = {k: v.clone() for k, v in tm.net.state_dict().items()}
    got = tm.train_step(batch)
    bounds = ({"": (0.999, 0.01)} if net == "marrnet2" else
              {"marrnet1.": None, "marrnet2.": (0.999, 0.01)})
    check_step(tm.net, ref, before, got, LR, bounds)
    if net == "marrnet":
        sd = tm.net.state_dict()
        for k, v in before.items():
            if k.startswith("marrnet1."):
                assert torch.equal(sd[k], v), k


@pytest.mark.parametrize("net,flags", [("marrnet2", {}),
                                       ("marrnet2", dict(canon_sup=True)),
                                       ("marrnet", dict(canon_sup=True))])
def test_dataset_contract_and_loss_match_jax(net, flags):
    """``requires``, ``gt_names`` and ``metrics`` as the JAX model's, the
    same procedural sample, and ``compute_loss`` on the same predictions
    and ground truth (rtol 1e-5: float32 means over 65,536 voxels in
    another order)."""
    jm, tm = _models(net, **flags)
    assert tm.requires == jm.requires
    assert tm.gt_names == jm.gt_names and tm.metrics == jm.metrics
    a = get_dataset("procedural")(tm.opt, "train", model=tm)[1]
    b = jax_procedural.Dataset(jm.opt, "train", model=jm)[1]
    assert sorted(a) == sorted(b)
    for k, v in b.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(a[k], v, err_msg=k)
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 32, 32, 32)).astype(np.float32) * 3
    gt = (rng.random((2, 32, 32, 32)) > 0.7).astype(np.float32)
    batch = {jm.voxel_key: gt}
    jpred = {"voxel": logits} if net == "marrnet" else logits
    ref, ref_terms = jm.compute_loss(jpred, batch)
    got, terms = tm.compute_loss({"voxel": torch.from_numpy(logits)},
                                 {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    assert sorted(terms) == sorted(ref_terms) == ["loss"]
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


@pytest.mark.parametrize("net", ["marrnet2", "marrnet"])
def test_pack_output_matches_jax(net):
    """``pack_output`` gives the JAX package's arrays (MarrNet: the photo
    denormalised, the silhouette in [0, 1], normal and depth masked by
    it) for the same predictions and batch."""
    jm, tm = _models(net, canon_sup=True)
    rng = np.random.default_rng(6)
    n, s, r = 2, DIMS["im_size"], DIMS["vox_res"]
    pred = {"voxel": rng.standard_normal((n, r, r, r)),
            "normal": rng.standard_normal((n, s, s, 3)) * 50,
            "depth": rng.standard_normal((n, s, s, 1)) * 50,
            "silhou": rng.standard_normal((n, s, s, 1)) * 80}
    pred = {k: v.astype(np.float32) for k, v in pred.items()}
    batch = {"rgb": rng.standard_normal((n, s, s, 3)).astype(np.float32),
             "voxel_canon": (pred["voxel"] > 0).astype(np.float32),
             "rgb_path": ["a.png", "b.png"]}
    ref = jm.pack_output(pred if net == "marrnet" else pred["voxel"], batch)
    got = tm.pack_output({k: torch.from_numpy(v) for k, v in pred.items()},
                         batch)
    assert sorted(got) == sorted(ref)
    assert got.pop("rgb_path") == ref.pop("rgb_path")
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def _flat(net):
    return {k: v.numpy() for k, v in jax_to_torch(
        net["params"], net.get("batch_stats") or {}).items()
        if not k.endswith("num_batches_tracked")}


def test_pretrained_subnets_load_from_either_package(tmp_path):
    """``--marrnet1`` and ``--marrnet2``: checkpoints of the JAX package
    and of the port load into MarrNet's two nets bit for bit (statistics
    included); the JAX MarrNet reads the port's checkpoints to the same
    trees."""
    paths = {}
    for net, flags, seed in (("marrnet1", dict(pred_depth_minmax=True), 1),
                             ("marrnet2", {}, 2)):
        jm, tm = _models(net, **flags)
        # each package writes its own weights (Adam's state left out: 3x
        # the size, and the subnets' loading does not read it)
        for pkg, seed_ in (("jax", seed + 10), ("port", seed)):
            tm.init_state(seed_)
            params, stats = torch_to_jax(tm.net.state_dict())
            paths[pkg, net] = str(tmp_path / f"{pkg}_{net}.pt")
            if pkg == "jax":
                save_jax_state(paths[pkg, net], jm, ModelState(
                    params={"net": params}, batch_stats={"net": stats},
                    opt_state={}, step=0), with_optimizers=False)
            else:
                port_save(paths[pkg, net], net_payload(params, stats))
    for pkg in ("jax", "port"):
        _, tm = _models("marrnet", canon_sup=True,
                        marrnet1=paths[pkg, "marrnet1"],
                        marrnet2=paths[pkg, "marrnet2"])
        tm.init_state(0)
        sd = tm.net.state_dict()
        for sub in ("marrnet1", "marrnet2"):
            want = _flat(load_checkpoint(paths[pkg, sub])["nets"][0])
            assert sorted(want) == sorted(
                k[len(sub) + 1:] for k in sd if k.startswith(sub + ".")
                and not k.endswith("num_batches_tracked"))
            for k, v in want.items():
                np.testing.assert_array_equal(sd[f"{sub}.{k}"].numpy(), v,
                                              err_msg=f"{pkg} {sub}.{k}")
    jm, _ = _models("marrnet", canon_sup=True,
                    marrnet1=paths["port", "marrnet1"],
                    marrnet2=paths["port", "marrnet2"])
    state = jm.init_state(jax.random.PRNGKey(0))
    for sub in ("marrnet1", "marrnet2"):
        src = load_checkpoint(paths["port", sub])["nets"][0]
        got = _flat({"params": to_np(state.params["net"][sub]),
                     "batch_stats": to_np(state.batch_stats["net"][sub])})
        for k, v in _flat(src).items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    for path in paths.values():
        os.remove(path)


def test_cli_test_marrnet_matches_jax(tmp_path):
    """``cli.test --net marrnet --device cpu`` on three photos and a JAX
    checkpoint writes the JAX ``ModelTest``'s ``.npz`` keys and arrays
    (the photo, MarrNet-1's maps, the voxel logits; cv2 against the
    port's resize, then float32 nets: 99.9 % of the values within 1e-3 of
    their scale, the mean within 1e-4) and the same visualizer files, each
    mesh a parsable .obj."""
    photos = str(tmp_path / "photos")
    write_photos(photos, 3)
    rgb_glob = os.path.join(photos, "*_rgb.png")
    mask_glob = os.path.join(photos, "*_silhouette.png")
    jm, tm, params, stats, batch, _ = _setup("marrnet")
    ckpt = str(tmp_path / "marrnet.pt")
    state = jax_model("marrnet")(jax_opt(**DIMS)).init_state(
        jax.random.PRNGKey(0))
    save_jax_state(ckpt, jm, state.replace(
        params={"net": params}, batch_stats={"net": stats}),
        with_optimizers=False)
    jax_out = str(tmp_path / "jax_out")
    jax_test_outputs("marrnet", jax_opt(
        batch_size=2, vis_workers=0, workers=2, net_file=ckpt,
        input_rgb=rgb_glob, input_mask=mask_glob, **DIMS), jax_out)
    port_out = str(tmp_path / "port_out")
    assert port_cli.main([
        "--net", "marrnet", "--net_file", ckpt, "--input_rgb", rgb_glob,
        "--input_mask", mask_glob, "--output_dir", port_out,
        "--batch_size", "2", "--workers", "2", "--device", "cpu"] + [
        # GenRe's --padding_margin is no MarrNet flag, in either package
        f"--{k}={v}" for k, v in DIMS.items() if k != "padding_margin"]
    ) == 0
    names = sorted(os.path.basename(p) for p in
                   glob.glob(os.path.join(port_out, "*.npz")))
    assert names == ["batch0000.npz", "batch0001.npz"]
    for name in names:
        ref = np.load(os.path.join(jax_out, name))
        got = np.load(os.path.join(port_out, name))
        assert sorted(got.files) == sorted(ref.files) == sorted(
            ["rgb_path", "rgb", "pred_silhou", "pred_normal", "pred_depth",
             "pred_voxel"])
        assert list(got["rgb_path"]) == list(ref["rgb_path"])
        for k in ("rgb", "pred_silhou", "pred_normal", "pred_depth",
                  "pred_voxel"):
            g, r = got[k], ref[k]
            assert g.shape == r.shape and np.isfinite(g).all(), k
            d = np.abs(g - r)
            scale = max(float(np.abs(r).max()), 1e-3)
            assert (d <= 1e-3 * scale).mean() >= 0.999, (k, d.max())
            assert d.mean() <= 1e-4 * scale, (k, d.mean())
    for batch_dir in ("batch0000", "batch0001"):
        files = sorted(os.listdir(os.path.join(port_out, batch_dir)))
        assert files == sorted(os.listdir(os.path.join(jax_out, batch_dir)))
        for f in files:
            path = os.path.join(port_out, batch_dir, f)
            if f.endswith(".obj"):
                lines = open(path).read().splitlines()
                assert lines and all(ln[:2] in ("v ", "f ") for ln in lines)
            else:
                assert png.read_png(path).size > 0, f
    os.remove(ckpt)


def test_qualrun_shapehd_torch_tiny_writes_the_jax_report(tmp_path):
    """``tools/qualrun_shapehd_torch.py --tiny --cpu`` at 2 steps a stage
    and the critic weight ``auto:0.25`` writes ``qualrun_shapehd.json``
    with the JAX tool's keys, finite IoU, Chamfer and critic scores, the
    weight set from the gradient probe, and its markdown."""
    logdir = tmp_path / "q"
    out = tmp_path / "Q.md"
    try:
        res = subprocess.run(
            [sys.executable, "tools/qualrun_shapehd_torch.py", "--tiny",
             "--cpu", "--steps_m2", "2", "--steps_gan", "2", "--steps_shd",
             "2", "--train_n", "8", "--batch", "2", "--workers", "2",
             "--w_gan_loss", "auto:0.25", "--logdir", str(logdir),
             "--out", str(out)],
            cwd=REPO, capture_output=True, text=True, timeout=600,
            env=dict(os.environ, GENRE_PROCEDURAL_CACHE="",
                     OMP_NUM_THREADS="2"))
        assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
        report = json.loads((logdir / "qualrun_shapehd.json").read_text())
        assert sorted(report) == sorted(
            ["backend", "config", "untrained", "stageA", "marrnet2",
             "stageB", "critic_separation", "stageC", "shapehd",
             "shapehd_sweep"])
        assert report["backend"] == "cpu"
        for key in ("untrained", "marrnet2", "shapehd"):
            r = report[key]
            assert r["n_items"] == 16 and r["chamfer_n"] == 16, key
            assert 0.0 <= r["iou_best"] <= 1.0
            assert np.isfinite(r["chamfer_mean"])
        assert np.isfinite(report["shapehd"]["critic_score"])
        auto, = report["shapehd_sweep"]
        split = auto["grad_split"]
        np.testing.assert_allclose(
            auto["w_gan_loss"], 0.25 / split["gan_over_sup_unit"], rtol=1e-6)
        assert split["gan_over_sup"] == 0.25
        assert [r["epoch"] for r in report["critic_separation"]] == [-1]
        text = out.read_text()
        assert "| IoU @best th |" in text and "D(G(z))" in text
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
