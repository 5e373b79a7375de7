"""Procedural shape dataset (counterpart of
``genre_shapehd_tpu/data/procedural.py``): analytic scenes with exact
multi-modal ground truth.

Random unions of rotated ellipsoids and boxes, rendered analytically
(closed-form ray casting) into every modality GenRe's staged training
reads: depth, silhouette, normals, shaded RGB, solid voxel occupancy and
spherical depth maps, geometrically consistent with each other.  The
arrays equal the JAX package's bit for bit for the same seed and sizes,
and both packages share the on-disk cache (same file names, same keys).

Frame conventions (``ops/camera_bp.py``, ``ops/render_sph_fast.py``):
  * glob frame: voxel cube [-0.5, 0.5]^3; camera at (-cam_dist, 0, 0)
    looking in +x.
  * cam_bp-frame pixel (a, b) of an HxW map: ih = a-(H-1)/2,
    iw = b-(W-1)/2; ray direction v = (1, -iw/fl, -ih/fl) (plane-depth
    parametrisation); stored ray depth = plane depth * |v|.
  * image frame: the inverse of ops.coords.depth_image_to_cambp_frame,
    i.e. image = flip(cambp_map, axis=0).T.
  * spherical map (lat, lon) uses ops.sph.gen_sph_grid directions; the
    stored value is the renderer's normalised depth t = 1 - r_entry where
    r_entry is the glob radius at which the inward ray dir*r (r: 1 -> 0)
    first enters the union.  Background pixels hold 1.0.

Train-time augmentation draws from a generator seeded by
``(--manual_seed, pass, index, train)``, the pass being the loader's
(``set_epoch``): each pass over the scenes draws anew.
"""

from __future__ import annotations

import os
import tempfile
import threading
from concurrent.futures import ProcessPoolExecutor
from contextlib import contextmanager
from multiprocessing import get_context
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops.camera_bp import CAM_DIST, FL_GENRE
from ..ops.sph import gen_sph_grid

_BIG = 1e9

#: fixed albedo palette (one colour per primitive slot)
_PALETTE = np.array(
    [[0.85, 0.35, 0.30], [0.30, 0.70, 0.40], [0.30, 0.45, 0.85],
     [0.85, 0.75, 0.30], [0.65, 0.40, 0.80]], np.float32)
_LIGHT1 = np.array([0.5, 0.6, 0.62], np.float32)
_LIGHT2 = np.array([-0.6, -0.3, 0.74], np.float32)


def _rand_rotation(rng: np.random.Generator) -> np.ndarray:
    """Uniform random rotation matrix (quaternion method)."""
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)


class Scene:
    """A union of K rotated primitives (ellipsoids / boxes) near the origin.

    Every primitive contains the origin, so the union is connected; all
    points stay inside the voxel cube (|coord| <= ~0.45) and the camera
    view cone.
    """

    def __init__(self, seed: int, max_prims: int = 4):
        rng = np.random.default_rng(seed)
        k = int(rng.integers(2, max_prims + 1))
        self.is_box: List[bool] = []
        self.center = np.zeros((k, 3), np.float32)
        self.half = np.zeros((k, 3), np.float32)      # semi-axes/half-extents
        self.rot = np.zeros((k, 3, 3), np.float32)    # local->world columns
        for i in range(k):
            box = bool(rng.random() < 0.5)
            if box:
                h = rng.uniform(0.10, 0.19, size=3)
            else:
                h = rng.uniform(0.12, 0.30, size=3)
            c = rng.normal(size=3)
            c = c / np.linalg.norm(c) * rng.uniform(0.0, 0.10)
            rot = _rand_rotation(rng)
            # guarantee the origin is inside: local coords of the origin
            loc = rot.T @ (-c)
            scale = np.max(np.abs(loc) / h) if box else \
                np.linalg.norm(loc / h)
            if scale > 0.9:
                c = c * (0.85 / scale)
            self.is_box.append(box)
            self.center[i] = c
            self.half[i] = h
            self.rot[i] = rot
        self.k = k

    # ---------------------------------------------------------- geometry
    def _local(self, pts: np.ndarray, i: int) -> np.ndarray:
        """World points (..., 3) -> primitive-local coordinates."""
        return (pts - self.center[i]) @ self.rot[i]

    def contains(self, pts: np.ndarray) -> np.ndarray:
        """(..., 3) world points -> bool inside-union."""
        inside = np.zeros(pts.shape[:-1], bool)
        for i in range(self.k):
            loc = self._local(pts, i)
            if self.is_box[i]:
                inside |= np.all(np.abs(loc) <= self.half[i], axis=-1)
            else:
                inside |= np.sum((loc / self.half[i]) ** 2, axis=-1) <= 1.0
        return inside

    def _intersect(self, orig: np.ndarray, dirs: np.ndarray, i: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Ray/primitive intersection interval.

        orig: (3,) or (P, 3); dirs: (P, 3).  Returns (t_in, t_out, hit)
        with t along ``dirs`` (unnormalised); misses hold +/-_BIG.
        """
        o = self._local(orig, i)
        if o.ndim == 1:
            o = o[None]
        u = dirs @ self.rot[i]
        h = self.half[i]
        if self.is_box[i]:
            with np.errstate(divide="ignore", invalid="ignore"):
                inv = 1.0 / u
            t1 = (-h - o) * inv
            t2 = (h - o) * inv
            # u==0 axes: inside slab iff |o|<=h, else miss
            para_ok = np.abs(u) > 1e-12
            lo = np.where(para_ok, np.minimum(t1, t2), -_BIG)
            hi = np.where(para_ok, np.maximum(t1, t2), _BIG)
            miss_para = np.any(~para_ok & (np.abs(o) > h), axis=-1)
            t_in = np.max(lo, axis=-1)
            t_out = np.min(hi, axis=-1)
            hit = (t_out >= t_in) & ~miss_para
        else:
            os_, us = o / h, u / h
            a = np.sum(us * us, axis=-1)
            b = np.sum(os_ * us, axis=-1)
            c = np.sum(os_ * os_, axis=-1) - 1.0
            disc = b * b - a * c
            hit = disc >= 0
            sq = np.sqrt(np.maximum(disc, 0.0))
            t_in = (-b - sq) / a
            t_out = (-b + sq) / a
        t_in = np.where(hit, t_in, _BIG)
        t_out = np.where(hit, t_out, -_BIG)
        return t_in, t_out, hit

    def _normal_at(self, pts: np.ndarray, i: int) -> np.ndarray:
        """Outward world-frame surface normal of primitive i at pts (P, 3)."""
        loc = self._local(pts, i)
        h = self.half[i]
        if self.is_box[i]:
            rel = np.abs(loc) / h
            axis = np.argmax(rel, axis=-1)
            n_loc = np.zeros_like(loc)
            np.put_along_axis(n_loc, axis[:, None],
                              np.sign(np.take_along_axis(
                                  loc, axis[:, None], axis=-1)), axis=-1)
        else:
            n_loc = loc / (h ** 2)
        n = n_loc @ self.rot[i].T
        return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True),
                              1e-12)

    # --------------------------------------------------------- rendering
    def render_camera(self, size: int = 256, fl: float = FL_GENRE,
                      cam_dist: float = CAM_DIST):
        """Analytic camera render in the cam_bp pixel frame.

        Returns dict with 'depth' (ray depth, -1 in background), 'silhou',
        'normal' (world frame, zeros in bg) and 'prim' (hit primitive id,
        -1 bg), each (size, size[, 3]) in the CAM_BP frame (use
        :func:`cambp_to_image_frame` for network inputs).
        """
        idx = np.arange(size, dtype=np.float32) - (size - 1) / 2.0
        ih, iw = np.meshgrid(idx, idx, indexing="ij")
        dirs = np.stack([np.ones_like(ih), -iw / fl, -ih / fl],
                        axis=-1).reshape(-1, 3).astype(np.float32)
        orig = np.array([-cam_dist, 0.0, 0.0], np.float32)
        best = np.full(dirs.shape[0], _BIG, np.float32)
        prim = np.full(dirs.shape[0], -1, np.int32)
        for i in range(self.k):
            t_in, _, hit = self._intersect(orig, dirs, i)
            ok = hit & (t_in > 0) & (t_in < best)
            best = np.where(ok, t_in, best)
            prim = np.where(ok, i, prim)
        hit = prim >= 0
        pts = orig + best[:, None] * dirs
        normal = np.zeros_like(dirs)
        for i in range(self.k):
            sel = prim == i
            if np.any(sel):
                normal[sel] = self._normal_at(pts[sel], i)
        ray_depth = np.where(hit, best * np.linalg.norm(dirs, axis=-1), -1.0)
        return {
            "depth": ray_depth.reshape(size, size).astype(np.float32),
            "silhou": hit.reshape(size, size).astype(np.float32),
            "normal": normal.reshape(size, size, 3).astype(np.float32),
            "prim": prim.reshape(size, size),
        }

    def render_spherical(self, res: int = 128) -> np.ndarray:
        """Analytic GT spherical map (res, res): t = 1 - r_entry, bg 1.0."""
        dirs = gen_sph_grid(res).reshape(-1, 3)
        orig = np.zeros(3, np.float32)
        r_entry = np.zeros(dirs.shape[0], np.float32)
        for i in range(self.k):
            _, t_out, hit = self._intersect(orig, dirs, i)
            # line lam*dir: union entry (coming inward from lam=1) is the
            # largest outgoing boundary crossing in (0, 1]
            cand = np.where(hit & (t_out > 0) & (t_out <= 1.0), t_out, 0.0)
            r_entry = np.maximum(r_entry, cand)
        t = np.where(r_entry > 0, 1.0 - r_entry, 1.0)
        return t.reshape(res, res).astype(np.float32)

    def voxelize(self, res: int = 128) -> np.ndarray:
        """Solid occupancy on the glob-frame grid, (res, res, res) bool."""
        c = (np.arange(res, dtype=np.float32) + 0.5) / res - 0.5
        pts = np.stack(np.meshgrid(c, c, c, indexing="ij"),
                       axis=-1).reshape(-1, 3)
        return self.contains(pts).reshape(res, res, res)

    def shade(self, cam: Dict[str, np.ndarray]) -> np.ndarray:
        """Lambertian RGB image (cam_bp frame), white background."""
        n, prim = cam["normal"], cam["prim"]
        lam = (0.25 + 0.5 * np.maximum(n @ _LIGHT1, 0.0)
               + 0.35 * np.maximum(n @ _LIGHT2, 0.0))
        albedo = _PALETTE[np.clip(prim, 0, len(_PALETTE) - 1)]
        rgb = albedo * lam[..., None]
        return np.where((prim >= 0)[..., None], rgb, 1.0).astype(np.float32)


def cambp_to_image_frame(arr: np.ndarray) -> np.ndarray:
    """Inverse of ops.coords.depth_image_to_cambp_frame for (H, W[, C])."""
    return np.ascontiguousarray(np.swapaxes(np.flip(arr, axis=0), 0, 1))


def generate_sample(seed: int, im_size: int = 256, vox_res: int = 128,
                    sph_res: int = 128, max_prims: int = 4
                    ) -> Dict[str, np.ndarray]:
    """One raw sample with every modality, in dataset storage conventions.

    Matches datasets/shapenet.py value conventions: 'depth' is minmax-
    normalised to [0, 1] (1 = near) with 0 background, 'depth_minmax' holds
    the absolute ray-depth range, 'voxel' is the solid grid stored so that
    the genre preprocess transform (transpose(0,2,1) + flip(2),
    genre_full_model.py:90-92) maps it into the cam_bp/train frame, and
    'spherical' holds (1, R, R) object + partial-depth maps.
    """
    scene = Scene(seed, max_prims=max_prims)
    # FL_GENRE is defined for 256x256 crops (cam_bp module default); scale
    # with the render size so geometry is exact at im_size=256 and
    # optically equivalent below it
    cam = scene.render_camera(size=im_size, fl=FL_GENRE * im_size / 256.0)
    fg = cam["silhou"] > 0.5
    abs_d = cam["depth"]
    dmin = float(abs_d[fg].min())
    dmax = float(abs_d[fg].max())
    norm = 1.0 - (abs_d - dmin) / (dmax - dmin + 1e-4)
    depth_norm = np.where(fg, norm, 0.0).astype(np.float32)
    occ = scene.voxelize(vox_res)
    # store in the dataset/GT frame: train_frame_to_gt_voxel(occ_glob)
    vox_gt = np.swapaxes(np.flip(occ, axis=2), 1, 2)
    return {
        "rgb": cambp_to_image_frame(scene.shade(cam)),
        "depth": cambp_to_image_frame(depth_norm),
        "silhou": cambp_to_image_frame(cam["silhou"]),
        "normal": cambp_to_image_frame(
            (cam["normal"] + 1.0) * 0.5 * cam["silhou"][..., None]),
        "depth_minmax": np.array([dmin, dmax], np.float32),
        "voxel": np.ascontiguousarray(vox_gt),
        "spherical_object": scene.render_spherical(sph_res)[None],
    }


def pack(raw: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The cached form of a raw sample: voxels as bits, the rest float16."""
    return {k: (np.packbits(v) if k == "voxel" else v.astype(np.float16))
            for k, v in raw.items()}


def _generate_packed(args: Tuple[int, int, int, int, int]
                     ) -> Dict[str, np.ndarray]:
    return pack(generate_sample(*args))


#: thread counts of the math libraries, read when a process loads them
_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


@contextmanager
def _one_thread_per_child():
    """Spawned processes start with one math-library thread each: a pool
    of one process per core otherwise runs cores x cores BLAS threads."""
    saved = {k: os.environ.get(k) for k in _THREAD_VARS}
    os.environ.update(dict.fromkeys(_THREAD_VARS, "1"))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


class Dataset:
    """Model-driven procedural dataset (the shapenet.py contract).

    Deterministic per (mode, index); raw samples are cached packed
    (voxels as bits, images as float16) so epochs after the first are
    pure-cache reads.  Add ``--procedural_length`` samples per mode.
    :meth:`warm` generates the missing scenes in worker processes.
    """

    @classmethod
    def add_arguments(cls, parser):
        parser.add_argument("--procedural_length", type=int, default=512,
                            help="samples per mode in the procedural set")
        parser.add_argument("--procedural_max_prims", type=int, default=4)
        return parser, set()

    _cache: Dict[Tuple, Dict] = {}
    _lock = threading.Lock()
    #: on-disk cache shared across processes and with the JAX package
    #: (scenes are deterministic per (mode, seed, dims)); "" disables it
    disk_cache_dir = os.environ.get(
        "GENRE_PROCEDURAL_CACHE",
        os.path.join(tempfile.gettempdir(), "genre_procedural_cache"))

    def __init__(self, opt, mode: str = "train", model=None):
        self.mode = mode
        self.opt = opt
        self.requires = list(model.requires) if model is not None else \
            ["rgb", "depth", "silhou", "normal", "depth_minmax", "voxel",
             "spherical"]
        self.preprocess = getattr(model, "preprocess", None)
        self.im_size = getattr(opt, "im_size", 256)
        self.vox_res = getattr(opt, "vox_res", 128)
        self.sph_res = getattr(opt, "sph_res", 128)
        self.max_prims = getattr(opt, "procedural_max_prims", 4)
        self.length = int(getattr(opt, "procedural_length", 512))
        self.seed = getattr(opt, "manual_seed", None) or 0
        self.epoch = 0
        if mode != "train":
            self.length = max(self.length // 8, 16)

    def __len__(self):
        return self.length

    def set_epoch(self, epoch: int) -> None:
        """The loader's pass number, which seeds the augmentation."""
        self.epoch = epoch

    def _seed(self, i: int) -> int:
        return 2 * i + (1_000_003 if self.mode != "train" else 0)

    def _key(self, i: int) -> Tuple:
        return (self.mode, i, self.im_size, self.vox_res, self.sph_res,
                self.max_prims)

    def _disk_path(self, i: int) -> Optional[str]:
        if not self.disk_cache_dir:
            return None
        return os.path.join(
            self.disk_cache_dir, "s{}_i{}_v{}_r{}_p{}_{}.npz".format(
                self._seed(i), self.im_size, self.vox_res, self.sph_res,
                self.max_prims, self.mode))

    def _cached(self, i: int) -> Optional[Dict[str, np.ndarray]]:
        """The packed sample from memory or disk, or None."""
        with self._lock:
            packed = self._cache.get(self._key(i))
        if packed is None:
            path = self._disk_path(i)
            if path is not None and os.path.exists(path):
                try:
                    with np.load(path) as z:
                        packed = {k: z[k] for k in z.files}
                except Exception:            # partial write: regenerate
                    packed = None
            if packed is not None:
                with self._lock:
                    self._cache[self._key(i)] = packed
        return packed

    def _store(self, i: int, packed: Dict[str, np.ndarray]) -> None:
        path = self._disk_path(i)
        if path is not None:
            try:
                os.makedirs(self.disk_cache_dir, exist_ok=True)
                tmp = f"{path}.{os.getpid()}.tmp.npz"
                np.savez(tmp, **packed)
                os.replace(tmp, path)        # atomic vs concurrent runs
            except Exception:
                pass                         # the disk cache is best-effort
        with self._lock:
            self._cache[self._key(i)] = packed

    def _args(self, i: int) -> Tuple[int, int, int, int, int]:
        return (self._seed(i), self.im_size, self.vox_res, self.sph_res,
                self.max_prims)

    def warm(self, workers: int = 1) -> int:
        """Generate every scene not cached yet, in ``workers`` processes
        (spawned: the caller may hold a CUDA context); returns how many
        were generated."""
        missing = [i for i in range(len(self)) if self._cached(i) is None]
        if workers <= 1 or len(missing) <= 1:
            for i in missing:
                self._store(i, _generate_packed(self._args(i)))
            return len(missing)
        with _one_thread_per_child(), ProcessPoolExecutor(
                min(workers, len(missing)),
                mp_context=get_context("spawn")) as pool:
            for i, packed in zip(missing, pool.map(
                    _generate_packed, [self._args(i) for i in missing],
                    chunksize=4)):
                self._store(i, packed)
        return len(missing)

    def _raw(self, i: int) -> Dict[str, np.ndarray]:
        packed = self._cached(i)
        if packed is None:
            packed = _generate_packed(self._args(i))
            self._store(i, packed)
        v = self.vox_res
        out = {}
        for k, val in packed.items():
            if k == "voxel":
                out[k] = np.unpackbits(val)[:v ** 3].reshape(
                    v, v, v).astype(np.float32)
            else:
                out[k] = val.astype(np.float32)
        return out

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        raw = self._raw(i)
        sample: Dict[str, np.ndarray] = {}
        for key in self.requires:
            if key in ("rgb", "depth", "silhou", "normal", "depth_minmax",
                       "voxel"):
                sample[key] = raw[key]
            elif key == "mask":
                sample["mask"] = raw["silhou"]
            elif key == "voxel_canon":
                sample["voxel_canon"] = raw["voxel"]
            elif key == "spherical":
                sample["spherical_object"] = raw["spherical_object"]
                # the partial spherical map is rendered on the device
                # (models read this one only under --load_offline)
                sample["spherical_depth"] = raw["spherical_object"]
            else:
                raise KeyError(f"procedural dataset cannot make '{key}'")
        if self.preprocess is not None:
            train = self.mode == "train"
            aug = np.random.default_rng(
                [self.seed, self.epoch, i, int(train)])
            sample = self.preprocess(sample, mode=self.mode, rng=aug)
        sample["rgb_path"] = f"procedural://{self.mode}/{i}"
        return sample
