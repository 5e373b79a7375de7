"""Async visualization: images, spherical maps, voxel iso-surface .obj
dumps (counterpart of ``genre_shapehd_tpu/viz/visualizer.py``: the same
typed channels, file names and .obj text; images are written by the
port's own PNG encoder instead of cv2).

Array layout: images arrive channel-last (N, H, W, C); voxels (N, X, Y, Z).
The heavy work (native iso-surface extraction and .obj writing, zlib)
releases the interpreter lock, so a thread pool overlaps it with the next
batch.  :meth:`Visualizer.close` waits for everything submitted.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from os.path import join
from shutil import copyfile
from typing import Dict, Optional

import numpy as np

from ..data import preprocess as pp
from .mcubes import marching_cubes, write_obj

VOXEL_ISOSURF_TH = 0.25
#: triangles beyond this are subsampled for .obj dumps -- untrained nets
#: produce noise surfaces with millions of triangles
MAX_OBJ_TRIS = 2_000_000


def save_iso_obj(df: np.ndarray, path: str, th: float,
                 shift: bool = True, max_tris: int = MAX_OBJ_TRIS) -> None:
    """Clamp the field so the iso level exists, extract at 1/res spacing,
    shift to [-0.5, 0.5]^3, write the .obj."""
    df = np.asarray(df, dtype=np.float32).copy()
    if th < df.min():
        df[0, 0, 0] = th - 1
    if th > df.max():
        df[-1, -1, -1] = th + 1
    res = max(df.shape)
    verts, faces = marching_cubes(df, th, spacing=(1 / res,) * 3)
    if shift:
        verts = verts - 0.5
    if len(faces) > max_tris:
        keep = np.random.default_rng(0).choice(len(faces), max_tris,
                                               replace=False)
        faces = faces[keep]
        # the extractor emits unshared vertices (3 per tri) -- compact
        verts = verts[faces.reshape(-1)]
        faces = np.arange(faces.size, dtype=np.int64).reshape(-1, 3)
    write_obj(path, verts, faces)


class Visualizer:
    paths = ["rgb_path", "silhou_path", "depth_path", "normal_path"]
    imgs = ["rgb", "pred_depth", "pred_silhou", "pred_normal"]
    voxels = ["pred_voxel_noft", "pred_voxel", "gen_voxel"]   # sigmoid'ed
    txts = ["gt_depth_minmax", "pred_depth_minmax", "disc", "scores"]
    sphmaps = ["pred_spherical_full", "pred_spherical_partial",
               "gt_spherical_full"]
    voxels_gt = ["pred_proj_depth", "gt_voxel", "pred_proj_sph_full"]

    def __init__(self, n_workers: int = 4, param_f: Optional[str] = None):
        self.pool = (ThreadPoolExecutor(n_workers) if n_workers > 0 else None)
        self._futures = []
        # a JSON parameter file {"voxel": {"isosurf_thres": x}} overrides
        # the iso level
        self.isosurf_th = VOXEL_ISOSURF_TH
        if param_f:
            with open(param_f) as f:
                params = json.load(f)
            self.isosurf_th = float(
                params.get("voxel", {}).get("isosurf_thres", VOXEL_ISOSURF_TH))

    def visualize(self, pack: Dict, batch_idx: int, outdir: str) -> None:
        if self.pool is not None:
            self._futures.append(self.pool.submit(
                self._visualize, pack, batch_idx, outdir, self.isosurf_th))
        else:
            self._visualize(pack, batch_idx, outdir, self.isosurf_th)

    def close(self) -> None:
        """Wait for every submitted batch; re-raise the first failure."""
        futures, self._futures = self._futures, []
        if self.pool is not None:
            self.pool.shutdown(wait=True)
            self.pool = None
        for fut in futures:
            fut.result()

    @classmethod
    def _visualize(cls, pack: Dict, batch_idx: int, outdir: str,
                   isosurf_th: float = VOXEL_ISOSURF_TH) -> None:
        os.makedirs(outdir, exist_ok=True)
        bsize = cls._batch_size(pack)
        base = batch_idx * (bsize or 0)
        counter = 0
        for k in cls.paths:
            patt = join(outdir, "{:04d}_%02d_" % counter
                        + k.split("_")[0] + ".png")
            cls._cp_img(pack.get(k), patt, base)
            counter += 1
        for k in cls.imgs:
            patt = join(outdir, "{:04d}_%02d_" % counter + k + ".png")
            cls._vis_img(pack.get(k), patt, base)
            counter += 1
        for k in cls.voxels_gt:
            patt = join(outdir, "{:04d}_%02d_" % counter + k + ".obj")
            cls._vis_voxel(pack.get(k), patt, base, isosurf_th,
                           use_sigmoid=False)
            counter += 1
        for k in cls.voxels:
            patt = join(outdir, "{:04d}_%02d_" % counter + k + ".obj")
            cls._vis_voxel(pack.get(k), patt, base, isosurf_th)
            counter += 1
        for k in cls.txts:
            patt = join(outdir, "{:04d}_%02d_" % counter + k + ".txt")
            cls._vis_txt(pack.get(k), patt, base)
            counter += 1
        for k in cls.sphmaps:
            patt = join(outdir, "{:04d}_%02d_" % counter + k + ".png")
            cls._vis_sph(pack.get(k), patt, base)
            counter += 1

    @staticmethod
    def _batch_size(pack):
        for v in pack.values():
            if hasattr(v, "shape") and len(v.shape) > 0:
                return v.shape[0]
        return None

    @staticmethod
    def _cp_img(paths, pattern, counter):
        if paths is None:
            return
        for i, path in enumerate(paths):
            if isinstance(path, str) and os.path.isfile(path):
                copyfile(path, pattern.format(counter + i))

    @staticmethod
    def _vis_img(img, pattern, counter):
        if img is None or isinstance(img, str):
            return
        img = np.asarray(img)
        for i, im in enumerate(img):          # (H, W, C)
            pp.imwrite_rgb(pattern.format(counter + i),
                           np.clip(im, 0.0, 1.0))

    @staticmethod
    def _vis_sph(img, pattern, counter):
        if img is None or isinstance(img, str):
            return
        img = np.asarray(img)
        for i, im in enumerate(img):
            im = im[..., 0] if im.ndim == 3 else im
            denom = max(float(im.max()), 1e-8)
            pp.imwrite_rgb(pattern.format(counter + i), im / denom)

    @classmethod
    def _vis_voxel(cls, voxels, pattern, counter, th, use_sigmoid=True):
        if voxels is None:
            return
        for i, v in enumerate(np.asarray(voxels)):
            if v.ndim == 4:
                v = v[..., 0] if v.shape[-1] == 1 else v[0]
            if use_sigmoid:
                v = 1.0 / (1.0 + np.exp(-v))
            save_iso_obj(v, pattern.format(counter + i), th)

    @staticmethod
    def _vis_txt(txts, pattern, counter):
        if txts is None:
            return
        for i, t in enumerate(txts):
            with open(pattern.format(counter + i), "w") as f:
                f.write(f"{t}\n")
