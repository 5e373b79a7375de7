"""Model base: device, compute dtype, test-mode preprocessing (counterpart
of the inference parts of ``genre_shapehd_tpu/models/base.py``)."""

from __future__ import annotations

from contextlib import nullcontext
from typing import Dict

import numpy as np
import torch

from ..core.device import resolve_device
from ..data import preprocess as pp

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def net_autocast(device: torch.device, dtype: torch.dtype):
    """Run the nets in ``dtype`` over float32 parameters -- what a Flax
    module with ``dtype=bfloat16`` does; float32 needs no context."""
    if dtype == torch.float32:
        return nullcontext()
    return torch.autocast(device.type, dtype=dtype)


def to_abs_depth(rel_depth: torch.Tensor,
                 depth_minmax: torch.Tensor) -> torch.Tensor:
    """Min-max denormalize; rel_depth (N,H,W,1), depth_minmax (N,2)."""
    dmin = depth_minmax[:, 0][:, None, None, None]
    dmax = depth_minmax[:, 1][:, None, None, None]
    return rel_depth * (dmax - dmin + 1e-4) + dmin


class ModelBase:
    silhou_thres = 0.999
    scale_25d = 100.0

    def __init__(self, opt):
        self.opt = opt
        self.dtype = DTYPES[opt.dtype]
        self.device = resolve_device(opt.device)
        self.im_size = opt.im_size

    def preprocess(self, data: Dict) -> Dict:
        """Per-sample host transform at test time (no photometric
        augmentation), channel-last: rgb resized and ImageNet-normalized;
        silhou resized, binarized at ``silhou_thres`` and scaled by
        ``scale_25d``."""
        out = dict(data)
        for key, val in data.items():
            if key == "rgb":
                im = pp.resize(val, self.im_size)
                out[key] = pp.normalize_colors(im).astype(np.float32)
            elif key == "silhou":
                im = val[..., 0] if val.ndim == 3 else val
                im = pp.resize(im, self.im_size, clamp=(im.min(), im.max()))
                im = pp.binarize(im, self.silhou_thres)
                out[key] = (im * self.scale_25d)[..., None].astype(np.float32)
        return out
