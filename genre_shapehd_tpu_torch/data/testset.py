"""Glob-pattern test dataset for photos + masks (counterpart of
``genre_shapehd_tpu/data/testset.py``): each required modality has an
``--input_<modality>`` glob, sorted lists pair 1:1, RGB loads in colour,
masks in grayscale under 'silhou', and the model's ``preprocess_wrapper``
runs on each sample."""

from __future__ import annotations

from glob import glob
from typing import Dict, List

import numpy as np

from . import preprocess as pp


class Dataset:
    def __init__(self, opt, mode: str = "test", model=None):
        assert model is not None, "test dataset is model-driven"
        self.preproc = model.preprocess_wrapper
        type2files: Dict[str, List[str]] = {
            k: sorted(glob(getattr(opt, "input_" + k)))
            for k in model.requires}
        lengths = {len(v) for v in type2files.values()}
        assert len(lengths) == 1, \
            "filelists for different modalities must be 1:1"
        self.length = lengths.pop()
        self.samples = [{k + "_path": v[i] for k, v in type2files.items()}
                        for i in range(self.length)]

    def __len__(self):
        return self.length

    def __getitem__(self, i: int) -> Dict:
        out: Dict = {}
        for k, v in self.samples[i].items():
            out[k] = v
            if k == "rgb_path":
                out["rgb"] = pp.imread_rgb(v)
            elif k == "mask_path":
                out["silhou"] = pp.imread_gray(v)
            else:
                raise NotImplementedError(k)
        out = self.preproc(out)
        for k, v in out.items():
            if isinstance(v, np.ndarray) and v.dtype != np.float32:
                out[k] = v.astype(np.float32)
        return out
