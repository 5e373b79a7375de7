"""Synthetic dataset: deterministic random samples shaped by the model's
``requires`` (counterpart of ``genre_shapehd_tpu/data/synthetic.py``),
for smoke runs, tests and timing.  Sample ``i`` of a mode is the same in
both packages; the model's train-time augmentation draws from a generator
seeded by ``(--manual_seed, i)``."""

from __future__ import annotations

from typing import Dict

import numpy as np


class Dataset:
    @classmethod
    def add_arguments(cls, parser):
        return parser, set()

    def __init__(self, opt, mode: str = "train", model=None):
        self.mode = mode
        self.requires = list(model.requires) if model is not None \
            else ["rgb", "depth", "silhou", "normal"]
        self.preprocess = getattr(model, "preprocess", None)
        self.im_size = getattr(opt, "im_size", 256)
        self.vox_res = getattr(opt, "vox_res", 128)
        self.sph_res = getattr(opt, "sph_res", 128)
        self.length = getattr(opt, "synthetic_length", 64)
        self.seed = getattr(opt, "manual_seed", None) or 0
        # deterministic per (index, mode): memoized, so the per-item
        # preprocess (the dominant host cost at full size) runs once
        self._cache: Dict[int, Dict[str, np.ndarray]] = {}

    def __len__(self):
        return self.length

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        if i not in self._cache:
            self._cache[i] = self._generate(i)
        return dict(self._cache[i])

    def _generate(self, i: int) -> Dict[str, np.ndarray]:
        train = self.mode == "train"
        rng = np.random.default_rng(i + (0 if train else 10_000))
        s, v = self.im_size, self.vox_res
        sample: Dict[str, np.ndarray] = {}
        silhou = np.zeros((s, s), np.float64)
        a, b = s // 4, 3 * s // 4
        silhou[a:b, a:b] = 1.0
        for key in self.requires:
            if key == "rgb":
                sample["rgb"] = rng.random((s, s, 3))
            elif key == "depth":
                d = np.zeros((s, s), np.float64)
                d[a:b, a:b] = 0.3 + 0.4 * rng.random((b - a, b - a))
                sample["depth"] = d
            elif key in ("silhou", "mask"):
                sample[key] = silhou.copy()
            elif key == "normal":
                sample["normal"] = rng.random((s, s, 3))
            elif key == "depth_minmax":
                lo = 2.0 + 0.2 * rng.random()
                sample["depth_minmax"] = np.array([lo, lo + 0.4])
            elif key in ("voxel", "voxel_canon"):
                sample[key] = (rng.random((v, v, v)) > 0.97).astype(
                    np.float64)
            elif key == "spherical":
                r = self.sph_res
                sample["spherical_object"] = 0.5 + 0.3 * rng.random((1, r, r))
                sample["spherical_depth"] = 0.5 + 0.3 * rng.random((1, r, r))
            else:
                raise KeyError(f"synthetic dataset cannot fake '{key}'")
        if self.preprocess is not None:
            aug = np.random.default_rng([self.seed, i, int(train)])
            sample = self.preprocess(sample, mode=self.mode, rng=aug)
        sample["rgb_path"] = f"synthetic://{self.mode}/{i}"
        return sample
