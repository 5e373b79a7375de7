"""PyTorch port, host side and entry point: PNG I/O and the crop/resize
preprocessing against cv2, ``cli.test`` against the JAX package's
``ModelTest.test_on_batch`` on the same photos and checkpoint, the
package's import hygiene, and the CUDA default."""

import glob
import os
import subprocess
import sys

import cv2
import jax
import numpy as np
import pytest
import torch

from genre_shapehd_tpu.core.checkpoint import save_checkpoint
from genre_shapehd_tpu.core.registry import get_dataset, get_model
from genre_shapehd_tpu.data import preprocess as jpp
from genre_shapehd_tpu.data.loader import DataLoader
from genre_shapehd_tpu.models.base import default_opt
from genre_shapehd_tpu_torch.cli import test as port_cli
from genre_shapehd_tpu_torch.data import png
from genre_shapehd_tpu_torch.data import preprocess as tpp

from _torch_port_util import TINY, calibrate, photo, scene_inputs

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_filtered_png(path, img, ftype):
    """A PNG whose rows all use filter ``ftype`` (0 None, 1 Sub, 2 Up,
    3 Average, 4 Paeth), to exercise every branch of the reader."""
    import struct
    import zlib
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    x = img.reshape(h, w * ch).astype(np.int32)
    left, up, upleft = (np.zeros_like(x) for _ in range(3))
    left[:, ch:], up[1:], upleft[1:, ch:] = x[:, :-ch], x[:-1], x[:-1, :-ch]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    pred = [np.zeros_like(x), left, up, (left + up) >> 1, paeth][ftype]
    rows = ((x - pred) & 0xFF).astype(np.uint8)
    raw = np.concatenate([np.full((h, 1), ftype, np.uint8), rows], 1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2, 4: 6}[ch], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(png._SIGNATURE + png._chunk(b"IHDR", ihdr)
                + png._chunk(b"IDAT", zlib.compress(raw.tobytes()))
                + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
def test_png_roundtrip_against_cv2(tmp_path, filter_type):
    rgb, mask = photo(37, 53, filter_type)
    rgba = np.concatenate([rgb, mask[..., None]], -1)
    for name, img in (("rgb", rgb), ("gray", mask), ("rgba", rgba)):
        path = str(tmp_path / f"{name}.png")
        _write_filtered_png(path, img, filter_type)
        np.testing.assert_array_equal(png.read_png(path), img)
        ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if ref.ndim == 3:
            ref = cv2.cvtColor(ref, cv2.COLOR_BGR2RGB if ref.shape[2] == 3
                               else cv2.COLOR_BGRA2RGBA)
        np.testing.assert_array_equal(ref, img)
    # and a file cv2 wrote (libpng picks the filter of each row)
    noisy = np.random.default_rng(9).integers(0, 256, (31, 41, 3), np.uint8)
    noisy[:, :20] = rgb[:31, :20]
    path = str(tmp_path / "cv2.png")
    cv2.imwrite(path, cv2.cvtColor(noisy, cv2.COLOR_RGB2BGR))
    np.testing.assert_array_equal(png.read_png(path), noisy)
    np.testing.assert_array_equal(
        tpp.imread_rgb(path), jpp.imread_rgb(path))
    # the package's own (unfiltered) writer
    png.write_png(path, rgb)
    np.testing.assert_array_equal(png.read_png(path), rgb)


def test_crop_and_resize_match_cv2():
    rgb, mask = photo(150, 200, 7)
    im, m = rgb / 255.0, mask / 255.0
    bbox = jpp.get_bbox(m, 0.95)
    assert tpp.get_bbox(m, 0.95) == bbox
    for pad_zero in (True, False):
        for src in (im, m):
            ref = jpp.crop(src, bbox, 480, 85, pad_zero=pad_zero)
            got = tpp.crop(src, bbox, 480, 85, pad_zero=pad_zero)
            assert got.shape == ref.shape
            # cv2 keeps its interpolation weights in float32: ~1e-7
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    crop = jpp.crop(im, bbox, 480, 85, pad_zero=False)
    for size in (256, 64):
        ref = jpp.resize(crop, size)
        got = tpp.resize(crop, size)
        assert got.shape == ref.shape == (size, size, 3)
        # bicubic weights in float32 in cv2, float64 here
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def _write_photos(d, n):
    os.makedirs(d)
    for i in range(n):
        rgb, mask = photo(90 + 7 * i, 120 - 5 * i, 100 + i)
        _write_filtered_png(os.path.join(d, f"{i:02d}_rgb.png"), rgb, i % 5)
        png.write_png(os.path.join(d, f"{i:02d}_silhouette.png"), mask)


def test_cli_matches_jax_test_on_batch(tmp_path):
    photos = str(tmp_path / "photos")
    _write_photos(photos, 3)
    rgb_glob = os.path.join(photos, "*_rgb.png")
    mask_glob = os.path.join(photos, "*_silhouette.png")

    # a checkpoint in the JAX package's format, from Model.init_state,
    # with three output layers rescaled so the geometry sees the cube
    opt = default_opt(batch_size=2, vis_workers=0, workers=2, **TINY)
    state = get_model("genre_full_model")(opt).init_state(
        jax.random.PRNGKey(0))
    to_np = lambda t: jax.tree.map(np.asarray, t)          # noqa: E731
    params, stats = calibrate(to_np(state.params["net"]),
                              to_np(state.batch_stats["net"]),
                              *scene_inputs(2, TINY["im_size"], seed=1))
    ckpt = str(tmp_path / "genre.pt")
    save_checkpoint(ckpt, {
        "nets": [{"params": params, "batch_stats": stats}],
        "optimizers": [to_np(state.opt_state["net"])],
        "epoch": 0, "loss_eval": 1.0,
        "net_names": ["net"], "opt_names": ["net"]})

    jax_out = str(tmp_path / "jax_out")
    test_opt = default_opt(batch_size=2, vis_workers=0, workers=2,
                           net_file=ckpt, output_dir=jax_out,
                           input_rgb=rgb_glob, input_mask=mask_glob, **TINY)
    mt = get_model("genre_full_model", test=True)(test_opt)
    ds = get_dataset("test")(test_opt, model=mt)
    for i, batch in enumerate(DataLoader(ds, 2, shuffle=False, num_workers=2,
                                         drop_last=False)):
        mt.test_on_batch(i, batch)

    port_out = str(tmp_path / "port_out")
    rc = port_cli.main([
        "--net", "genre_full_model", "--net_file", ckpt,
        "--input_rgb", rgb_glob, "--input_mask", mask_glob,
        "--output_dir", port_out, "--batch_size", "2", "--workers", "2",
        "--dtype", "float32", "--device", "cpu"] + [
        f"--{k}={v}" for k, v in TINY.items()])
    assert rc == 0

    names = sorted(os.path.basename(p) for p in
                   glob.glob(os.path.join(port_out, "*.npz")))
    assert names == ["batch0000.npz", "batch0001.npz"]
    hits = 0
    for name in names:
        ref = np.load(os.path.join(jax_out, name))
        got = np.load(os.path.join(port_out, name))
        assert sorted(got.files) == sorted(
            ["pred_voxel", "pred_proj_depth", "pred_proj_sph_full",
             "rgb_path"])
        assert list(got["rgb_path"]) == list(ref["rgb_path"])
        for k in ("pred_voxel", "pred_proj_depth", "pred_proj_sph_full"):
            g, r = got[k], ref[k]
            assert g.shape == r.shape and np.isfinite(g).all(), k
            # cv2 vs torch preprocessing (~1e-6), then float32 nets: a
            # point can cross a voxel face under floor(), so most voxels,
            # not all, agree tightly
            d = np.abs(g - r)
            scale = max(float(np.abs(r).max()), 1.0)
            assert (d <= 1e-3 * scale).mean() >= 0.999, (k, d.max())
            assert d.mean() <= 1e-3 * scale, (k, d.mean())
        hits += int((ref["pred_proj_depth"] > 2e-4).sum())
    assert hits > 200, hits      # the camera backprojection saw points

    # the visualizer: the same files as the JAX package's, every mesh a
    # parsable .obj, every photo copied
    for batch, n_items in (("batch0000", 2), ("batch0001", 1)):
        files = sorted(os.listdir(os.path.join(port_out, batch)))
        assert files == sorted(os.listdir(os.path.join(jax_out, batch)))
        assert len(files) == 4 * n_items, files
        for f in files:
            path = os.path.join(port_out, batch, f)
            if f.endswith(".obj"):
                lines = open(path).read().splitlines()
                assert lines and all(
                    ln[:2] in ("v ", "f ") and len(ln.split()) == 4
                    for ln in lines), path
            else:
                assert f.endswith("_00_rgb.png"), f
                assert png.read_png(path).shape[2] == 3


def test_port_imports_no_jax(tmp_path):
    """Importing every port module (``cli.train`` and the training
    modules among them), and reading a JAX checkpoint whose optimizer
    state pickles optax objects, loads no JAX module."""
    import optax
    params = {"Dense_0": {"kernel": np.arange(6.0).reshape(2, 3),
                          "bias": np.zeros(3)}}
    ckpt = str(tmp_path / "adam.pt")
    save_checkpoint(ckpt, {
        "nets": [{"params": params, "batch_stats": {}}],
        "optimizers": [jax.tree.map(np.asarray, optax.adam(1e-3).init(
            params))], "epoch": 3, "loss_eval": 0.5})
    code = (
        "import importlib, pkgutil, sys\n"
        "import genre_shapehd_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from genre_shapehd_tpu_torch.core.checkpoint import load_net\n"
        f"params, stats = load_net({ckpt!r})\n"
        "assert params['Dense_0']['kernel'].shape == (2, 3), params\n"
        "bad = sorted(m for m in sys.modules if m in "
        "('jax', 'flax', 'optax', 'genre_shapehd_tpu') or "
        "m.startswith('genre_shapehd_tpu.'))\n"
        "n = sum(m.startswith('genre_shapehd_tpu_torch.') "
        "for m in sys.modules)\n"
        "for m in ('viz.visualizer', 'viz.mcubes', 'cli.eval_chamfer', "
        "'ops.chamfer', 'ops.cuda.chamfer_kernel', "
        "'ops.cuda.subpixel_kernel', 'cli.train', 'train.loop', "
        "'train.state', 'train.loggers', 'data.synthetic', 'ops.voxel', "
        "'models.marrnet1'):\n"
        "    assert 'genre_shapehd_tpu_torch.' + m in sys.modules, m\n"
        "print(n, bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    # every module: the scoring path's and the training path's too
    assert int(res.stdout.split()[0]) >= 48, res.stdout


def test_cli_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        port_cli.main(["--net", "genre_full_model", "--net_file", "x.pt",
                       "--input_rgb", "none", "--output_dir",
                       str(tmp_path / "out"), "--device", "cuda"])
    assert not os.path.exists(tmp_path / "out")
