"""Test data in the layouts the JAX package reads from disk, for the
tests and ``chip_smoke.py`` alike (it imports nothing of JAX or of the
JAX package): a ShapeNet-layout tree written from procedural scenes,
and the command line of a ``scripts/*.sh`` or ``scripts_torch/*.sh``
launch script."""

import os
import subprocess
import tempfile

import numpy as np
from scipy.io import savemat

from genre_shapehd_tpu_torch.data.png import write_png
from genre_shapehd_tpu_torch.data.shapenet import STATUS_AND_SUFFIX


def to_png_bits(im01, bits=8):
    """[0, 1] floats -> uint8 (``bits`` 8) or uint16 (16), rounded."""
    maxv = (1 << bits) - 1
    return np.round(np.clip(im01, 0.0, 1.0) * maxv).astype(
        np.uint16 if bits == 16 else np.uint8)


def write_shapenet_tree(root, items):
    """A ShapeNet-layout tree under ``root``, as ``data/shapenet.py``
    reads it.  ``items``: dicts with ``item`` ('<synset>/<model>/<model>
    _viewNNN'), ``train`` (bool), ``sample`` (a procedural scene's raw
    modalities: rgb, depth, silhou, normal in [0, 1], depth_minmax,
    voxel, spherical_object (1, R, R)) and optionally ``missing``, the
    modalities whose status is False and whose file is not written.

    Files: ``_rgb.png`` and ``_normal.png`` 8-bit RGB,
    ``_silhouette.png`` 8-bit grayscale, ``_depth.png`` 16-bit grayscale,
    ``.npy`` the depth min/max, ``_gt_rotvox_samescale_128.npz`` the
    voxels as uint8, ``_spherical.npz`` the object spherical map (also as
    the depth one), ``_voxel_normalized_128.mat`` (scipy) the voxels, once
    per model.  The PNGs' rows are filtered as libpng chooses
    (``write_png(..., filters="adaptive")``), as a renderer writes
    them."""
    status = {k: [] for k in STATUS_AND_SUFFIX}
    names, is_train = [], []
    for it in items:
        item, s = it["item"], it["sample"]
        missing = set(it.get("missing", ()))
        names.append(item)
        is_train.append(bool(it["train"]))
        base = os.path.join(root, item)
        os.makedirs(os.path.dirname(base), exist_ok=True)
        canon = os.path.join(root, item.split("_view")[0]) \
            + STATUS_AND_SUFFIX["voxel_canon"]["suffix"]
        vox = np.asarray(s["voxel"]).astype(np.uint8)
        writers = {
            "rgb": lambda p: write_png(p, to_png_bits(s["rgb"]),
                                       "adaptive"),
            "normal": lambda p: write_png(p, to_png_bits(s["normal"]),
                                          "adaptive"),
            "silhou": lambda p: write_png(p, to_png_bits(s["silhou"]),
                                          "adaptive"),
            "depth": lambda p: write_png(p, to_png_bits(s["depth"], 16),
                                         "adaptive"),
            "depth_minmax": lambda p: np.save(
                p, np.asarray(s["depth_minmax"], np.float32)),
            "voxel": lambda p: np.savez_compressed(p, voxel=vox),
            "spherical": lambda p: np.savez(
                p, obj_spherical=s["spherical_object"][0],
                depth_spherical=s["spherical_object"][0]),
            "voxel_canon": lambda p: os.path.exists(p) or savemat(
                p, {"voxel": vox}, do_compression=True),
        }
        for key, write in writers.items():
            status[key].append(key not in missing)
            if key not in missing:
                write(canon if key == "voxel_canon"
                      else base + STATUS_AND_SUFFIX[key]["suffix"])
    lists = os.path.join(root, "status")
    os.makedirs(lists, exist_ok=True)

    def put(name, lines):
        with open(os.path.join(lists, name), "w") as f:
            f.write("".join(f"{x}\n" for x in lines))
    put("items_all.txt", names)
    put("is_train.txt", is_train)
    for key, flags in status.items():
        put(STATUS_AND_SUFFIX[key]["status"], flags)


def script_argv(script, cls, env=None,
                module="genre_shapehd_tpu.cli.train", scripts="scripts",
                tensorboardx=True, with_stderr=False, extra=()):
    """The arguments that ``<scripts>/<script> <cls> <extra...>`` (no
    class for a ``cls`` of None) passes to ``python -m <module>``,
    verbatim: the
    script runs with a stand-in ``python`` first on PATH that records
    them (``env`` adds variables, e.g. NET1 or INPAINT).  The stand-in
    answers ``python -c ...`` (the port's scripts ask it whether
    tensorboardX imports) with success if ``tensorboardx``, else with
    failure.  ``scripts`` is the scripts' directory under the repository:
    ``scripts`` (the JAX package's) or ``scripts_torch`` (the port's).
    With ``with_stderr``, returns (the arguments, the script's stderr)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "argv")
        fake = os.path.join(d, "python")
        with open(fake, "w") as f:
            f.write('#!/bin/sh\nif [ "$1" = -c ]; then exit $C_STATUS; fi\n'
                    'for a in "$@"; do printf \'%s\\0\' "$a"; '
                    'done > "$ARGV_FILE"\n')
        os.chmod(fake, 0o755)
        res = subprocess.run(
            ["bash", os.path.join(repo, scripts, script)]
            + ([] if cls is None else [cls]) + list(extra),
            check=True, stdin=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True,
            env=dict(os.environ, **(env or {}), ARGV_FILE=out,
                     C_STATUS="0" if tensorboardx else "1",
                     PATH=d + os.pathsep + os.environ["PATH"]))
        with open(out) as f:
            argv = f.read().split("\0")[:-1]
    assert argv[:2] == ["-m", module], argv[:2]
    return (argv[2:], res.stderr) if with_stderr else argv[2:]
