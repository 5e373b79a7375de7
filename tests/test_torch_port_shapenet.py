"""PyTorch port, GenRe's ShapeNet training path against the JAX package on
the CPU: 16-bit PNG reading against cv2, the ``shapenet`` dataset on a
ShapeNet-layout tree written from procedural scenes at 480² (8-bit RGB,
normal and silhouette PNGs, 16-bit depth PNGs, ``.npy``, ``.npz``, a
``.mat`` per model and an item without voxels), the class tables, the
command lines of ``scripts/train_marrnet1.sh``, ``train_inpaint.sh``,
``train_full_genre.sh`` and ``finetune_genre_joint.sh`` in both parsers,
and those four command lines through ``cli.train --dataset shapenet
--device cpu`` at 64² -> 32³ on a smaller tree.
"""

import glob
import json
import os
import shutil
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from genre_shapehd_tpu.cli import options as jax_options
from genre_shapehd_tpu.core.registry import get_dataset as jax_dataset
from genre_shapehd_tpu.core.registry import get_model as jax_model
from genre_shapehd_tpu.data import preprocess as jpp
from genre_shapehd_tpu.data import shapenet as jax_shapenet
from genre_shapehd_tpu.models.base import default_opt as jax_opt
from genre_shapehd_tpu_torch.cli import options
from genre_shapehd_tpu_torch.core.registry import get_dataset, get_model
from genre_shapehd_tpu_torch.data import png, shapenet
from genre_shapehd_tpu_torch.data import preprocess as tpp
from genre_shapehd_tpu_torch.data.procedural import generate_sample
from genre_shapehd_tpu_torch.models.base import default_opt

from _shapenet_tree import script_argv, write_shapenet_tree
from _torch_port_util import release_memory

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAIR, CAR = "03001627", "02958343"
#: (item, train, missing modalities): two classes, train and vali items,
#: a model with two views (one .mat for both) and a view without voxels
ITEMS = [
    (f"{CHAIR}/c0/c0_view000", True, ()),
    (f"{CHAIR}/c0/c0_view001", True, ("voxel",)),
    (f"{CHAIR}/c1/c1_view000", True, ()),
    (f"{CAR}/k0/k0_view000", True, ()),
    (f"{CHAIR}/c2/c2_view000", False, ()),
    (f"{CHAIR}/c2/c2_view001", False, ()),
    (f"{CHAIR}/c3/c3_view000", False, ()),
    (f"{CAR}/k1/k1_view000", False, ()),
]
SCRIPTS = ("train_marrnet1.sh", "train_inpaint.sh", "train_full_genre.sh",
           "finetune_genre_joint.sh")


def _write_tree(root, size, vox_res, sph_res):
    write_shapenet_tree(root, [
        dict(item=item, train=train, missing=missing,
             sample=generate_sample(100 + i, size, vox_res, sph_res))
        for i, (item, train, missing) in enumerate(ITEMS)])


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("shapenet480"))
    _write_tree(root, 480, 32, 32)
    yield root
    shutil.rmtree(root, ignore_errors=True)
    release_memory()


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_read_png_16_bit_matches_cv2(tmp_path, channels):
    """16-bit files that cv2 wrote (libpng picks each row's filter) and
    that the port wrote read as cv2 reads them; ``imread_rgb`` divides by
    65535 as the JAX package's does."""
    rng = np.random.default_rng(channels)
    shape = (37, 53) if channels == 1 else (37, 53, channels)
    img = rng.integers(0, 65536, shape).astype(np.uint16)
    img[:, :20] = np.linspace(0, 65535, 20).astype(np.uint16)[None, :, None] \
        if channels > 1 else np.linspace(0, 65535, 20).astype(np.uint16)
    path = str(tmp_path / "cv2.png")
    bgr = {1: None, 3: cv2.COLOR_RGB2BGR, 4: cv2.COLOR_RGBA2BGRA}[channels]
    cv2.imwrite(path, img if bgr is None else cv2.cvtColor(img, bgr))
    for p in (path, str(tmp_path / "port.png")):
        if p != path:
            png.write_png(p, img)
        ref = cv2.imread(p, cv2.IMREAD_UNCHANGED)
        assert ref.dtype == np.uint16
        if channels > 1:
            ref = cv2.cvtColor(ref, cv2.COLOR_BGR2RGB if channels == 3
                               else cv2.COLOR_BGRA2RGBA)
        got = png.read_png(p)
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(tpp.imread_rgb(p), jpp.imread_rgb(p))


def _row_filters(path):
    """The filter type of each row of a non-interlaced PNG."""
    import struct
    import zlib
    with open(path, "rb") as f:
        data = f.read()
    pos, idat = 8, b""
    while pos < len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        if ctype == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB",
                                               data[pos + 8:pos + 18])
        elif ctype == b"IDAT":
            idat += data[pos + 8:pos + 8 + length]
        pos += 12 + length
    stride = w * {0: 1, 2: 3, 6: 4}[color] * depth // 8 + 1
    return set(zlib.decompress(idat)[::stride][:h])


@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, "adaptive"])
def test_png_row_filters_round_trip_through_cv2(tmp_path, filters):
    """The port's writer under each row filter (and libpng's adaptive
    choice) writes files that cv2 reads as the image, and the port's
    reader (anti-diagonal decoding once Average or Paeth rows occur)
    reads them as cv2 does: 8- and 16-bit, 1, 3 and 4 channels."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[:29, :41]
    for bits in (8, 16):
        dtype, top = (np.uint8, 255) if bits == 8 else (np.uint16, 65535)
        smooth = (xx * 3 + yy * 5) / (41 * 3 + 29 * 5)
        for channels in (1, 3, 4):
            im = np.stack([np.roll(smooth, k, 1) for k in range(channels)],
                          -1)
            im = np.clip(im + rng.normal(0, 0.02, im.shape), 0, 1)
            img = np.round(im * top).astype(dtype)
            img[5] = rng.integers(0, top + 1, img[5].shape)     # noisy row
            img = img[..., 0] if channels == 1 else img
            path = str(tmp_path / f"f{filters}_{bits}_{channels}.png")
            png.write_png(path, img, filters)
            want = {filters} if filters != "adaptive" else None
            got_filters = _row_filters(path)
            assert got_filters == want if want else len(got_filters) > 1
            ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
            if channels > 1:
                ref = cv2.cvtColor(ref, cv2.COLOR_BGR2RGB if channels == 3
                                   else cv2.COLOR_BGRA2RGBA)
            np.testing.assert_array_equal(ref, img)
            got = png.read_png(path)
            assert got.dtype == img.dtype
            np.testing.assert_array_equal(got, ref)


def _unfilter_bytewise(rows, ftypes, bpp):
    """The PNG specification's unfiltering, byte by byte."""
    h, stride = rows.shape
    out = np.zeros((h, stride), np.int64)
    for y in range(h):
        for i in range(stride):
            a = out[y, i - bpp] if i >= bpp else 0
            b = out[y - 1, i] if y > 0 else 0
            c = out[y - 1, i - bpp] if y > 0 and i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            pred = (0, a, b, (a + b) // 2, paeth)[ftypes[y]]
            out[y, i] = (int(rows[y, i]) + pred) % 256
    return out.astype(np.uint8)


def test_unfilter_by_diagonals_equals_the_bytewise_loop():
    """Random bytes under a random filter per row, at shapes wider,
    taller and narrower than a pixel's bytes: the anti-diagonal decoder
    equals the specification's byte loop exactly."""
    rng = np.random.default_rng(11)
    for h, w, bpp in ((7, 5, 3), (5, 9, 1), (12, 4, 2), (1, 6, 4),
                      (6, 1, 8)):
        rows = rng.integers(0, 256, (h, w * bpp)).astype(np.uint8)
        ftypes = rng.integers(0, 5, h).astype(np.uint8)
        ftypes[0] = 4
        np.testing.assert_array_equal(
            png._unfilter_diagonals(rows, ftypes, bpp),
            _unfilter_bytewise(rows, ftypes, bpp))


def test_class_tables_equal_jax():
    assert shapenet.CLASS_ALIASES == jax_shapenet.CLASS_ALIASES
    assert shapenet.CLASS_LIST == jax_shapenet.CLASS_LIST
    assert shapenet.STATUS_AND_SUFFIX == jax_shapenet.STATUS_AND_SUFFIX


class _AllModalities:
    """A stand-in model that requires every modality and leaves the
    sample as it is read."""
    requires = list(shapenet.STATUS_AND_SUFFIX)

    @staticmethod
    def preprocess(data, mode="train", rng=None):
        return data


def _both(tree, mode, model_j, model_t, **opt):
    """Both packages' datasets on the tree; their item lists must be
    equal, in order."""
    kw = dict(data_root=tree, **opt)
    ref = jax_dataset("shapenet")(jax_opt(**kw), mode, model=model_j)
    got = get_dataset("shapenet")(default_opt(device="cpu", **kw), mode,
                                  model=model_t)
    assert got.samples == ref.samples
    return ref, got


@pytest.mark.parametrize("mode,classes,n", [
    ("train", "chair", 2), ("train", "drc", 3), ("vali", "chair", 3),
    ("vali", f"{CHAIR}+{CAR}", 4)])
def test_dataset_reads_what_jax_reads(tree, mode, classes, n):
    """Every modality as it is read (8- and 16-bit PNGs, ``.npy``,
    ``.npz``, the model's ``.mat``), bit for bit and float32, and the
    same items in the same order: the car is left out unless named, the
    view without voxels always; without a model, only the rgb is read."""
    ref, got = _both(tree, mode, _AllModalities, _AllModalities,
                     classes=classes)
    assert len(got) == n
    for i in range(n):
        r, g = ref[i], got[i]
        assert sorted(g) == sorted(r)
        for k, v in r.items():
            if isinstance(v, np.ndarray):
                assert g[k].dtype == np.float32, k
                np.testing.assert_array_equal(g[k], v, err_msg=k)
            else:
                assert g[k] == v, k
    assert got[0]["depth"].shape == (480, 480)
    assert len(np.unique(got[0]["depth"])) > 256           # 16-bit steps
    assert got[0]["voxel_canon"].shape == (32, 32, 32)
    ref, got = _both(tree, mode, None, None, classes=classes)
    assert len(got) == len(ref) >= n
    for i in range(len(got)):
        np.testing.assert_array_equal(got[i]["rgb"], ref[i]["rgb"])


@pytest.mark.parametrize("net,flags", [
    ("marrnet1", dict(pred_depth_minmax=True)),
    ("depth_pred_with_sph_inpaint", {}),
    ("genre_full_model", {}),
    ("marrnet2", dict(canon_sup=True))])
def test_dataset_vali_preprocess_matches_jax(tree, net, flags):
    """Vali-mode samples through the models' ``preprocess`` (480² -> 256²
    bicubic, 2.5D maps scaled by 100, silhouettes binarized, spherical
    maps padded, voxels to the train frame): the same keys and float32
    arrays, equal but for the resize, whose bicubic weights cv2 keeps in
    float32 (1e-5 of [0, 1], as ``test_torch_port_cli.py`` holds it)."""
    kw = dict(im_size=256, vox_res=32, sph_res=32, z_res=64, **flags)
    jm = jax_model(net)(jax_opt(**kw))
    tm = get_model(net)(default_opt(device="cpu", **kw))
    assert sorted(tm.requires) == sorted(jm.requires)
    ref, got = _both(tree, "vali", jm, tm, classes="chair")
    assert len(got) == 3
    tol = {"rgb": 1e-5 / 0.224, "depth": 1e-3, "normal": 1e-3}
    for i in range(len(got)):
        r, g = ref[i], got[i]
        assert sorted(g) == sorted(r)
        for k, v in r.items():
            if not isinstance(v, np.ndarray):
                assert g[k] == v, k
                continue
            assert g[k].dtype == np.float32 and g[k].shape == v.shape, k
            if k in tol:
                assert v.shape[:2] == (256, 256)
                np.testing.assert_allclose(g[k], v, rtol=0, atol=tol[k],
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(g[k], v, err_msg=k)


def test_augmentation_draws_anew_each_loader_pass(tree):
    """Train-mode augmentation is seeded by (--manual_seed, pass, index,
    train): the loader's second pass over a view draws another colour
    and lighting jitter than its first, and a dataset set to that pass
    draws it again."""
    from genre_shapehd_tpu_torch.data.loader import DataLoader
    opt = default_opt(device="cpu", data_root=tree, classes="chair",
                      manual_seed=3, im_size=64, pred_depth_minmax=True)
    model = get_model("marrnet1")(opt)
    ds = get_dataset("shapenet")(opt, "train", model=model)
    loader = DataLoader(ds, 1, num_workers=1)
    first, second = (next(iter(loader))["rgb"][0] for _ in range(2))
    assert np.abs(first - second).max() > 1e-3
    again = get_dataset("shapenet")(opt, "train", model=model)
    again.set_epoch(1)
    np.testing.assert_array_equal(again[0]["rgb"], second)
    again.set_epoch(0)
    np.testing.assert_array_equal(again[0]["rgb"], first)


def _parse_both(argv):
    ref, _ = jax_options.parse_train(argv)
    got, _ = options.parse_train(argv)
    return vars(ref), vars(got)


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_command_lines_parse_alike(script):
    """A script's arguments, verbatim, parse in both packages' parsers to
    the same values for every key both have, every flag the script sets
    among them; ``--suffix '{classes}'`` formats to the class.  A JAX
    flag that nothing reads (``--save_net_opt``) is an error in the
    port, not a silent no-op."""
    env = {"NET1": "n1.pt", "INPAINT": "inpaint.pt"}
    argv = script_argv(script, "chair", env)
    ref, got = _parse_both(argv)
    shared = sorted(set(ref) & set(got))
    assert [k for k in shared if ref[k] != got[k]] == []
    set_by_script = {a[2:] for a in argv if a.startswith("--")}
    assert set_by_script <= set(shared), set_by_script - set(shared)
    assert {"tensorboard", "classes", "suffix"} <= set_by_script
    assert got["dataset"] == "shapenet" and got["classes"] == "chair"
    assert got["suffix"].format(**got) == "chair"
    assert got["device"] == "cuda"
    with pytest.raises(SystemExit):
        options.parse_train(argv + ["--save_net_opt"])


def _stage_argv(script, env, extra):
    return script_argv(script, CHAIR, env) + extra


def test_tensorboard_without_tensorboardx_stops_before_the_first_step(
        tmp_path, monkeypatch):
    """Where tensorboardX cannot be imported, ``--tensorboard`` raises an
    ImportError that names it once the model is built, before any step,
    checkpoint or log row."""
    from genre_shapehd_tpu_torch.cli import train as cli_train
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    root = str(tmp_path / "shapenet")
    write_shapenet_tree(root, [
        dict(item=item, train=train,
             sample=generate_sample(100 + i, 64, 32, 32))
        for i, (item, train, _) in enumerate(ITEMS)])
    logs = str(tmp_path / "logs")
    argv = _stage_argv("train_marrnet1.sh", {}, [
        "--logdir", logs, "--data_root", root, "--device", "cpu",
        "--im_size", "64", "--epoch", "1", "--log_batch"])
    assert "--tensorboard" in argv
    with pytest.raises(ImportError, match="tensorboardX"):
        cli_train.main(argv)
    run = os.path.join(logs, f"marrnet1_shapenet_0.001_{CHAIR}", "0")
    assert sorted(os.listdir(run)) == ["opt.pt", "opt.txt"]


def test_scripts_train_on_a_shapenet_tree_through_cli_train(tmp_path):
    """The four scripts' command lines, verbatim but for smaller epochs,
    ``--logdir``, the tree's ``--data_root``, the small sizes and
    ``--device cpu``, through ``cli.train`` in a fresh process (which
    loads no JAX module): MarrNet-1, stage 2 on its checkpoint, stage 3
    on stage 2's, the joint fine-tune resumed from stage 3's logdir.
    Each writes the eval visualizations, ``batch0000.npz`` and a
    TensorBoard event file; the car is left out, and the view without
    voxels where voxels are read.  A checkpoint is deleted once the next
    stage has read it (GenRe's with Adam's moments is 1.2 GB)."""
    root = str(tmp_path / "shapenet")
    _write_tree(root, 128, 32, 32)
    logs = str(tmp_path / "logs")
    small = ["--epoch", "1", "--epoch_batches", "2", "--eval_batches", "1",
             "--batch_size", "2", "--workers", "2", "--vis_batches_vali",
             "1", "--vis_workers", "0", "--data_root", root, "--device",
             "cpu", "--manual_seed", "1", "--im_size", "64", "--vox_res",
             "32", "--sph_res", "32", "--z_res", "64", "--logdir", logs]
    run = lambda net, lr: os.path.join(                       # noqa: E731
        logs, f"{net}_shapenet_{lr}_{CHAIR}", "0")
    d1, d2, d3 = (run("marrnet1", 0.001),
                  run("depth_pred_with_sph_inpaint", 0.0001),
                  run("genre_full_model", 0.0001))
    ck = lambda d: os.path.join(d, "checkpoint.pt")          # noqa: E731
    best = lambda d: os.path.join(d, "best.pt")              # noqa: E731
    # (argv, files to delete after the run)
    stages = [
        (_stage_argv("train_marrnet1.sh", {}, small), [best(d1)]),
        (_stage_argv("train_inpaint.sh", {"NET1": ck(d1)}, small),
         [ck(d1), best(d2)]),
        (_stage_argv("train_full_genre.sh", {"INPAINT": ck(d2)}, small),
         [ck(d2), best(d3)]),
        (_stage_argv("finetune_genre_joint.sh", {}, small + ["--epoch",
                                                              "2"]),
         [ck(d3), best(d3)])]
    code = (
        "import json, os, sys\n"
        "from genre_shapehd_tpu_torch.cli import train\n"
        "for argv, done in json.loads(sys.argv[1]):\n"
        "    assert train.main(argv) == 0\n"
        "    for f in done:\n"
        "        os.remove(f)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', "
        "'optax', 'genre_shapehd_tpu') or m.startswith('genre_shapehd_tpu.'))"
        "\nprint('jax modules:', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    try:
        res = subprocess.run(
            [sys.executable, "-c", code, json.dumps(stages)], cwd=REPO,
            capture_output=True, text=True, timeout=600,
            env=dict(os.environ, OMP_NUM_THREADS="2"))
        assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
        views = [ln.split(";")[0] for ln in res.stdout.splitlines()
                 if ln.startswith("[setup] ") and "vali samples" in ln]
        assert views == ["[setup] 3 train / 3 vali samples"] * 2 + [
            "[setup] 2 train / 3 vali samples"] * 2, views
        for d, metric, epochs in ((d1, "depth_minmax", (1,)),
                                  (d2, "spherical", (1,)),
                                  (d3, "voxel_loss", (1, 2))):
            with open(os.path.join(d, "epoch_loss.csv")) as f:
                rows = f.read().splitlines()
            assert metric in rows[0] and len(rows) == 1 + 2 * len(epochs)
            for e in epochs:
                vis = os.path.join(d, f"epoch{e:04d}_vali")
                with np.load(os.path.join(vis, "batch0000.npz")) as z:
                    assert all(np.isfinite(z[k]).all() for k in z.files)
                assert glob.glob(os.path.join(vis, "0000_*"))
            assert glob.glob(os.path.join(d, "tensorboard", "events.out.*"))
        # stage 3's visualizations include the voxels' meshes; the joint
        # epoch also draws the 2.5D maps
        assert glob.glob(os.path.join(d3, "epoch0001_vali",
                                      "*pred_voxel.obj"))
        assert glob.glob(os.path.join(d3, "epoch0002_vali",
                                      "*pred_depth.png"))
    finally:
        shutil.rmtree(logs, ignore_errors=True)
