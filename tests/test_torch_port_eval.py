"""PyTorch port, reconstruct-then-score on the host side: the native
iso-surface extractor, surface sampling, ``cli.eval_chamfer`` and the
visualizer against ``tools/eval_chamfer.py`` and the JAX package's
``viz`` on the same seeded grids."""

import io
import json
import os
import sys
from contextlib import redirect_stdout

import cv2
import numpy as np
import pytest
import torch

from genre_shapehd_tpu.viz import Visualizer as JaxVisualizer
from genre_shapehd_tpu.viz import marching_cubes as jax_marching_cubes
from genre_shapehd_tpu_torch.cli import eval_chamfer as port_eval
from genre_shapehd_tpu_torch.viz import Visualizer, marching_cubes, mcubes
from genre_shapehd_tpu_torch.viz.visualizer import save_iso_obj

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
from tools import eval_chamfer as jax_eval  # noqa: E402

torch.set_num_threads(2)


def _solid(res, seed):
    """A seeded solid in {0, 1}: an ellipsoid joined with a box."""
    rng = np.random.default_rng(seed)
    c = (np.arange(res) + 0.5) / res - 0.5
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    r = rng.uniform(0.15, 0.3, 3)
    o = rng.uniform(-0.1, 0.1, 3)
    ell = ((x - o[0]) / r[0]) ** 2 + ((y - o[1]) / r[1]) ** 2 \
        + ((z - o[2]) / r[2]) ** 2 < 1
    h = rng.uniform(0.05, 0.2, 3)
    box = (np.abs(x + o[0]) < h[0]) & (np.abs(y) < h[1]) & (np.abs(z) < h[2])
    return (ell | box).astype(np.float32)


def _logits(res, seed):
    """A noisy logit field around a solid (what a prediction looks like)."""
    rng = np.random.default_rng(seed + 100)
    return ((_solid(res, seed) - 0.5) * 6.0
            + rng.standard_normal((res,) * 3)).astype(np.float32)


def test_marching_cubes_equals_jax_package_and_builds_under_build():
    vol = _logits(24, 0)
    for iso in (0.0, 0.7):
        v, f = marching_cubes(vol, iso, spacing=(1 / 24,) * 3)
        jv, jf = jax_marching_cubes(vol, iso, spacing=(1 / 24,) * 3)
        assert len(f) > 100 and f.dtype == np.int32 and v.dtype == np.float32
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_array_equal(f, jf)
    v, f = marching_cubes(np.zeros((8, 8, 8), np.float32), 0.5)
    assert v.shape == (0, 3) and f.shape == (0, 3)
    so = mcubes.library_path()
    assert so.is_file() and so.parent == mcubes.BUILD_DIR
    assert mcubes.BUILD_DIR == mcubes.PACKAGE_DIR.parent / "build" / "native"
    with pytest.raises(ValueError):
        marching_cubes(np.zeros((4, 4)), 0.5)


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_surface_equals_tools_eval_chamfer(seed):
    vol = _solid(32, seed)
    got = port_eval.sample_surface(vol, 0.5, 257,
                                   np.random.default_rng(seed))
    ref = jax_eval.sample_surface(vol, 0.5, 257, np.random.default_rng(seed))
    assert got.shape == (257, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    assert np.abs(got).max() <= 0.5
    empty = port_eval.sample_surface(np.zeros((8, 8, 8)), 0.5, 16,
                                     np.random.default_rng(0))
    np.testing.assert_array_equal(empty, np.zeros((16, 3), np.float32))


def test_chamfer_between_voxels_matches_tools_eval_chamfer():
    pred, gt = _logits(32, 2), _solid(32, 3)
    for kw in (dict(), dict(th=0.4, use_sigmoid=False, n_points=300, seed=5)):
        p = pred if kw.get("use_sigmoid", True) else _solid(32, 2)
        got = port_eval.chamfer_between_voxels(p, gt, device="cpu", **kw)
        ref = jax_eval.chamfer_between_voxels(p, gt, **kw)
        # same samples; float32 distances summed in another order
        assert abs(got - ref) <= 1e-5, (got, ref)
        assert 0.0 < got < 1.0
    # an empty prediction scores against the surface without NaN, and two
    # empty grids score sqrt(1e-20) twice
    flat = np.full((32,) * 3, -9.0, np.float32)
    got = port_eval.chamfer_between_voxels(flat, gt, device="cpu")
    assert np.isfinite(got) and abs(
        got - jax_eval.chamfer_between_voxels(flat, gt)) <= 1e-5
    assert port_eval.chamfer_between_voxels(
        flat, np.zeros((32,) * 3, np.float32), device="cpu") < 1e-9


def _write_pairs(tmp_path, n):
    pred_dir, gt_dir = tmp_path / "pred", tmp_path / "gt"
    pred_dir.mkdir()
    gt_dir.mkdir()
    for i in range(n):
        np.savez(pred_dir / f"batch{i:04d}.npz",
                 pred_voxel=np.stack([_logits(32, i), _logits(32, i + 50)]))
        np.savez(gt_dir / f"batch{i:04d}.npz", voxel=_solid(32, i))
    np.savez(pred_dir / "unpaired.npz", pred_voxel=_logits(32, 9))
    return str(pred_dir), str(gt_dir)


def _run_main(module, argv):
    """stdout of ``module.main``; the JAX tool reads ``sys.argv``."""
    buf = io.StringIO()
    old = sys.argv
    try:
        with redirect_stdout(buf):
            if module is jax_eval:
                sys.argv = ["eval_chamfer.py"] + argv
                module.main()
            else:
                assert module.main(argv + ["--device", "cpu"]) == 0
    finally:
        sys.argv = old
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def test_eval_directory_and_main_match_tools_eval_chamfer(tmp_path):
    pred_dir, gt_dir = _write_pairs(tmp_path, 3)
    got = port_eval.eval_directory(pred_dir, gt_dir, "pred_voxel", "voxel",
                                   0.25, True, 1024, device="cpu")
    ref = jax_eval.eval_directory(pred_dir, gt_dir, "pred_voxel", "voxel",
                                  0.25, True, 1024)
    assert list(got) == list(ref) == [f"batch{i:04d}.npz" for i in range(3)]
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-5, (k, got[k], ref[k])

    argv = ["--pred_dir", pred_dir, "--gt_dir", gt_dir, "--n_points", "512"]
    got, ref = _run_main(port_eval, argv), _run_main(jax_eval, argv)
    assert sorted(got) == sorted(ref) == ["mean_chamfer_distance", "n_items",
                                          "per_item"]
    assert got["n_items"] == ref["n_items"] == 3
    assert abs(got["mean_chamfer_distance"]
               - ref["mean_chamfer_distance"]) <= 1e-5
    assert list(got["per_item"]) == list(ref["per_item"])
    for k in ref["per_item"]:
        assert abs(got["per_item"][k] - ref["per_item"][k]) <= 1e-5

    argv = ["--pred", os.path.join(pred_dir, "unpaired.npz"), "--gt",
            os.path.join(gt_dir, "batch0001.npz"), "--th", "0.3"]
    got, ref = _run_main(port_eval, argv), _run_main(jax_eval, argv)
    assert list(got) == list(ref) == ["chamfer_distance"]
    assert abs(got["chamfer_distance"] - ref["chamfer_distance"]) <= 1e-5


def test_eval_main_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda is valid here")
    pred_dir, gt_dir = _write_pairs(tmp_path, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        port_eval.main(["--pred_dir", pred_dir, "--gt_dir", gt_dir])


def _pack(seed, photo):
    rng = np.random.default_rng(seed)
    return {
        "pred_voxel": np.stack([_logits(16, seed), _logits(16, seed + 1)]),
        "pred_proj_depth": rng.random((2, 16, 16, 16)).astype(np.float32),
        "pred_proj_sph_full": np.zeros((2, 16, 16, 16), np.float32),
        "rgb": rng.random((2, 12, 14, 3)).astype(np.float32),
        "pred_spherical_full": rng.random((2, 10, 10, 1)).astype(np.float32),
        "pred_depth_minmax": rng.random((2, 2)).astype(np.float32),
        "rgb_path": [photo, "missing.png"],
    }


@pytest.mark.parametrize("workers", [0, 2])
def test_visualizer_writes_what_the_jax_visualizer_writes(tmp_path, workers):
    photo = str(tmp_path / "photo_rgb.png")
    cv2.imwrite(photo, np.full((5, 6, 3), 128, np.uint8))
    pack = _pack(4, photo)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    viz = Visualizer(n_workers=workers)
    viz.visualize(pack, 3, port_dir)
    viz.close()
    JaxVisualizer(n_workers=0).visualize(pack, 3, jax_dir)
    names = sorted(os.listdir(jax_dir))
    assert sorted(os.listdir(port_dir)) == names
    assert "0006_00_rgb.png" in names and "0007_12_pred_voxel.obj" in names
    for name in names:
        a, b = os.path.join(port_dir, name), os.path.join(jax_dir, name)
        if name.endswith(".png"):
            # the encoders differ (zlib settings), the pixels do not
            np.testing.assert_array_equal(
                cv2.imread(a, cv2.IMREAD_UNCHANGED),
                cv2.imread(b, cv2.IMREAD_UNCHANGED))
        else:
            with open(a) as fa, open(b) as fb:
                assert fa.read() == fb.read(), name


def test_save_iso_obj_text_subsampled_and_failures(tmp_path):
    """More triangles than ``max_tris``: the same seeded subsample and the
    same text as the JAX package; a failing batch surfaces in close()."""
    from genre_shapehd_tpu.viz import save_iso_obj as jax_save
    vol = _logits(16, 6)
    a, b = str(tmp_path / "a.obj"), str(tmp_path / "b.obj")
    save_iso_obj(vol, a, 0.0, max_tris=200)
    jax_save(vol, b, 0.0, max_tris=200)
    text = open(a).read()
    assert text == open(b).read()
    assert text.count("\nf ") + text.startswith("f ") == 200
    viz = Visualizer(n_workers=1)
    viz.visualize({"pred_voxel": np.zeros((1, 4, 4))}, 0, str(tmp_path / "x"))
    with pytest.raises(Exception):
        viz.close()
