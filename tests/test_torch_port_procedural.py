"""PyTorch port, the procedural dataset against the JAX package's:
``generate_sample`` bit for bit, the ``Dataset`` per model ``requires``
(``--no_aug``), the shared on-disk cache, the seeded augmentation and the
scene generation in worker processes; and the quality benchmark on it,
``tools/qualrun_torch.py``.  Sizes 64² -> 32³, sph_res 32."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from genre_shapehd_tpu.core.registry import get_model as jax_model
from genre_shapehd_tpu.data import procedural as jax_procedural
from genre_shapehd_tpu.models.base import default_opt as jax_opt
from genre_shapehd_tpu_torch.core.registry import get_dataset, get_model
from genre_shapehd_tpu_torch.data import procedural
from genre_shapehd_tpu_torch.models.base import default_opt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the reduced scale of the staged tests
DIMS = dict(im_size=64, vox_res=32, sph_res=32, z_res=64, padding_margin=16)


@pytest.fixture
def no_disk_cache(monkeypatch):
    """Both packages' datasets without the on-disk cache and with empty
    in-memory caches."""
    for mod in (procedural, jax_procedural):
        monkeypatch.setattr(mod.Dataset, "disk_cache_dir", "")
        monkeypatch.setattr(mod.Dataset, "_cache", {})


@pytest.mark.parametrize("seed", [0, 7, 1_000_003])
def test_generate_sample_equals_jax(seed):
    ref = jax_procedural.generate_sample(seed, 64, 32, 32)
    got = procedural.generate_sample(seed, 64, 32, 32)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert got["silhou"].sum() > 0 and got["voxel"].sum() > 0


#: each model of the staged workflow, with the flags that change what it
#: reads from the dataset
MODELS = [
    ("marrnet1", {}),
    ("marrnet1", dict(pred_depth_minmax=True)),
    ("depth_pred_with_sph_inpaint", {}),
    ("depth_pred_with_sph_inpaint", dict(joint_train=True)),
    ("depth_pred_with_sph_inpaint", dict(gt_depth_input=True)),
    ("genre_full_model", {}),
    ("genre_full_model", dict(gt_minmax_input=True, gt_sph_full=True)),
]


@pytest.mark.parametrize("net,flags", MODELS)
def test_dataset_matches_jax_per_model(net, flags, no_disk_cache):
    """Each model's ``requires`` reads the same keys, shapes and values in
    both packages, train and held-out, without augmentation."""
    kw = dict(DIMS, no_aug=True, procedural_length=8, **flags)
    jm = jax_model(net)(jax_opt(**kw))
    tm = get_model(net)(default_opt(device="cpu", **kw))
    assert tm.requires == jm.requires
    assert tm.gt_names == jm.gt_names and tm.metrics == jm.metrics
    for mode, i in (("train", 3), ("vali", 1)):
        ref = jax_procedural.Dataset(jm.opt, mode, model=jm)
        got = get_dataset("procedural")(tm.opt, mode, model=tm)
        assert len(got) == len(ref) == (8 if mode == "train" else 16)
        a, b = got[i], ref[i]
        assert sorted(a) == sorted(b), (sorted(a), sorted(b))
        assert a["rgb_path"] == b["rgb_path"]
        for k, v in b.items():
            if isinstance(v, np.ndarray):
                assert a[k].shape == v.shape, k
                np.testing.assert_array_equal(a[k], v.astype(a[k].dtype),
                                              err_msg=f"{mode} {k}")


def test_disk_cache_is_shared_with_jax(tmp_path, monkeypatch):
    """A scene the JAX package cached on disk is read by the port without
    generating it again, and the other way round: same file names, same
    keys, same values."""
    for mod in (procedural, jax_procedural):
        monkeypatch.setattr(mod.Dataset, "disk_cache_dir", str(tmp_path))
        monkeypatch.setattr(mod.Dataset, "_cache", {})
    opt = dict(DIMS, procedural_length=16)
    jds = jax_procedural.Dataset(jax_opt(**opt), "train")
    tds = procedural.Dataset(default_opt(device="cpu", **opt), "train")
    ref = jds._raw(2)                            # JAX writes scene 2
    assert [p.name for p in tmp_path.iterdir()] == [
        "s4_i64_v32_r32_p4_train.npz"]

    def refuse(*args, **kwargs):
        raise AssertionError("generated a cached scene")
    monkeypatch.setattr(procedural, "generate_sample", refuse)
    got = tds._raw(2)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    monkeypatch.undo()
    for mod in (procedural, jax_procedural):
        monkeypatch.setattr(mod.Dataset, "disk_cache_dir", str(tmp_path))
        monkeypatch.setattr(mod.Dataset, "_cache", {})
    tds._raw(5)                                  # the port writes scene 5
    monkeypatch.setattr(jax_procedural, "generate_sample", refuse)
    ref = jds._raw(5)
    np.testing.assert_array_equal(
        ref["voxel"], procedural.generate_sample(10, 64, 32, 32)["voxel"])


def test_augmentation_is_seeded_by_manual_seed(no_disk_cache):
    """Train-mode augmentation draws from a generator seeded by
    (--manual_seed, pass, index, train): two datasets agree, another seed
    or --no_aug differs, and held-out samples are never augmented."""
    def rgb(mode="train", **kw):
        opt = default_opt(device="cpu", **DIMS, procedural_length=8, **kw)
        model = get_model("marrnet1")(opt)
        return get_dataset("procedural")(opt, mode, model=model)[2]["rgb"]
    a, b = rgb(manual_seed=3), rgb(manual_seed=3)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - rgb(manual_seed=4)).max() > 1e-3
    assert np.abs(a - rgb(manual_seed=3, no_aug=True)).max() > 1e-3
    np.testing.assert_array_equal(rgb("vali", manual_seed=3),
                                  rgb("vali", manual_seed=4))


def test_augmentation_draws_anew_each_loader_pass(no_disk_cache):
    """The loader gives the dataset its pass number: the second pass
    over a scene draws another augmentation than the first."""
    from genre_shapehd_tpu_torch.data.loader import DataLoader
    opt = default_opt(device="cpu", **DIMS, procedural_length=2,
                      manual_seed=3)
    ds = get_dataset("procedural")(opt, "train",
                                   model=get_model("marrnet1")(opt))
    loader = DataLoader(ds, 1, num_workers=1)
    first, second = (next(iter(loader))["rgb"][0] for _ in range(2))
    assert np.abs(first - second).max() > 1e-3
    ds.set_epoch(1)
    np.testing.assert_array_equal(ds[0]["rgb"], second)


def test_warm_in_worker_processes_equals_generation(tmp_path, monkeypatch):
    """``Dataset.warm`` in 2 spawned processes caches what generation in
    this process makes, in memory and on disk."""
    monkeypatch.setattr(procedural.Dataset, "disk_cache_dir", str(tmp_path))
    monkeypatch.setattr(procedural.Dataset, "_cache", {})
    opt = default_opt(device="cpu", **DIMS, procedural_length=3)
    ds = procedural.Dataset(opt, "train")
    assert ds.warm(workers=2) == 3
    assert ds.warm(workers=2) == 0               # all cached now
    assert len(list(tmp_path.iterdir())) == 3
    for i in range(3):
        ref = procedural.generate_sample(ds._seed(i), 64, 32, 32)
        got = ds._raw(i)
        for k, v in ref.items():
            np.testing.assert_array_equal(
                got[k], v.astype(np.float16).astype(np.float32)
                if k != "voxel" else v.astype(np.float32), err_msg=k)


def test_qualrun_torch_tiny_writes_the_jax_report(tmp_path):
    """``tools/qualrun_torch.py --tiny --cpu --full_pipeline`` at 2 steps
    a stage writes ``qualrun.json`` with the JAX tool's keys and its
    markdown, with finite IoU and Chamfer before and after training."""
    logdir = tmp_path / "q"
    out = tmp_path / "Q.md"
    try:
        res = subprocess.run(
            [sys.executable, "tools/qualrun_torch.py", "--tiny", "--cpu",
             "--full_pipeline", "--steps0", "2", "--steps1", "2",
             "--steps2", "2", "--steps2b", "2", "--train_n", "8",
             "--batch", "2", "--workers", "2",
             "--logdir", str(logdir), "--out", str(out)],
            cwd=REPO, capture_output=True, text=True, timeout=600,
            env=dict(os.environ, GENRE_PROCEDURAL_CACHE="",
                     OMP_NUM_THREADS="2"))
        assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
        report = json.loads((logdir / "qualrun.json").read_text())
        assert sorted(report) == ["backend", "config", "stage0", "stage1",
                                  "stage2", "trained", "untrained"]
        for key in ("untrained", "trained"):
            r = report[key]
            assert sorted(r) == ["chamfer_mean", "chamfer_n", "iou_0.5",
                                 "iou_best", "iou_best_th", "iou_by_th",
                                 "n_items"]
            assert r["n_items"] == 16 and r["chamfer_n"] == 16
            assert 0.0 <= r["iou_best"] <= 1.0
            assert np.isfinite(r["chamfer_mean"])
        assert report["backend"] == "cpu"
        assert report["config"]["full_pipeline"] is True
        text = out.read_text()
        assert "| surface IoU @best th |" in text and "stage 0" in text
    finally:
        shutil.rmtree(logdir, ignore_errors=True)


def _tool_defaults(path, monkeypatch):
    """The defaults of a tool's flags: its ``main`` run up to its parse,
    which returns the parser's defaults instead."""
    import argparse
    import importlib.util

    class Parsed(Exception):
        pass

    def capture(self, args=None, namespace=None):
        raise Parsed({a.dest: a.default for a in self._actions})
    spec = importlib.util.spec_from_file_location(
        os.path.basename(path)[:-3], os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        m.setattr(sys, "argv", [path])
        with pytest.raises(Parsed) as e:
            mod.main()
    return e.value.args[0]


def test_qualrun_torch_takes_the_jax_tools_stage_flags(tmp_path,
                                                       monkeypatch):
    """``tools/qualrun_torch.py --tiny --cpu --full_pipeline`` with the
    JAX tool's stage flags (``--init0``, ``--lr0``, ``--lr0b``, ``--init2``,
    ``--joint2``, ``--w25d``, ``--lr2``; their defaults the JAX tool's):
    the report's config holds each value, stage 0 starts at ``--lr0``
    from ``--init0``, stage 2 at ``--lr2`` from ``--init2``, jointly,
    after the probe of its gradients into net1 (the JAX tool's
    ``joint_grad_split`` keys, finite), in the JAX tool's stage order.
    One step a stage, 2 scenes a batch, one held-out batch."""
    new = ("init0", "lr0", "lr0b", "init2", "joint2", "w25d", "lr2")
    ref = _tool_defaults("tools/qualrun.py", monkeypatch)
    got = _tool_defaults("tools/qualrun_torch.py", monkeypatch)
    assert {k: got[k] for k in new} == {k: ref[k] for k in new}
    from genre_shapehd_tpu_torch.core.checkpoint import save_checkpoint
    from genre_shapehd_tpu_torch.train.state import \
        state_to_reference_payload
    paths = {}
    for net, flags in (("marrnet1", dict(pred_depth_minmax=True)),
                       ("genre_full_model", {})):
        model = get_model(net)(default_opt(device="cpu", **DIMS, **flags))
        model.init_state(4)
        paths[net] = str(tmp_path / f"{net}.pt")
        save_checkpoint(paths[net], state_to_reference_payload(model, 0,
                                                               0.0))
    logdir = tmp_path / "q"
    try:
        res = subprocess.run(
            [sys.executable, "tools/qualrun_torch.py", "--tiny", "--cpu",
             "--full_pipeline", "--steps0", "1", "--steps0b", "1",
             "--steps1", "1", "--steps2", "1", "--train_n", "8",
             "--batch", "2", "--workers", "2", "--eval_batches", "1",
             "--init0", paths["marrnet1"], "--lr0", "2e-3", "--lr0b",
             "3e-4", "--init2", paths["genre_full_model"], "--joint2",
             "--w25d", "0.5", "--lr2", "5e-4", "--logdir", str(logdir)],
            cwd=REPO, capture_output=True, text=True, timeout=600,
            env=dict(os.environ, GENRE_PROCEDURAL_CACHE="",
                     OMP_NUM_THREADS="2"))
        assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
        report = json.loads((logdir / "qualrun.json").read_text())
        cfg = report["config"]
        assert {k: cfg[k] for k in new} == dict(
            init0=paths["marrnet1"], lr0=2e-3, lr0b=3e-4,
            init2=paths["genre_full_model"], joint2=True, w25d=0.5,
            lr2=5e-4)
        split = report["joint_grad_split"]
        assert sorted(split) == ["net1_grad_norm_25d", "net1_grad_norm_vox",
                                 "vox_over_25d"]
        # the voxel loss reaches net1 only where its depth lands points in
        # the cube, which one step of an untrained net1 need not do
        assert all(np.isfinite(v) and v >= 0 for v in split.values()), split
        assert split["net1_grad_norm_25d"] > 0, split
        lines = [ln for ln in res.stdout.splitlines()
                 if ln.startswith("[qualrun] ")]
        order = ["stage0: marrnet1 at lr 0.002 from " + paths["marrnet1"],
                 "stage0: {", "stage1: {", "untrained: ",
                 "stage2: genre_full_model at lr 0.0005, joint (w25d 0.5) "
                 "from " + paths["genre_full_model"],
                 "joint grad split at stage-2 start", "stage2: {",
                 "trained: "]
        at = [next(i for i, ln in enumerate(lines)
                   if ln.startswith("[qualrun] " + o)) for o in order]
        assert at == sorted(at), list(zip(order, at))
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)
