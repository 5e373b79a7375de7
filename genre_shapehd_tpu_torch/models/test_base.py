"""Test-time machinery: checkpoint load, photo cropping, per-batch
visualization and .npz output (counterpart of
``genre_shapehd_tpu/models/test_base.py``)."""

from __future__ import annotations

import os
from os.path import join
from typing import Dict

import numpy as np

from ..core.checkpoint import load_checkpoint
from ..data import preprocess as pp
from ..train.state import load_nets
from ..viz.visualizer import Visualizer
from .base import as_numpy

CROP_SILHOU_THRES = 0.95
CROP_IN_SIZE = 480
CROP_PAD = 85


class TestMixin:
    """Mixin over a Model providing the test-time contract."""

    def init_test(self, opt):
        self.output_dir = opt.output_dir
        self.visualizer = Visualizer(
            n_workers=getattr(opt, "vis_workers", 4),
            param_f=getattr(opt, "vis_param_f", None))

    #: whether the cropped silhouette stays a network input (GenRe yes,
    #: MarrNet and ShapeHD no)
    keep_silhou = False

    def load_net_file(self, net_file: str) -> None:
        """Every net of the checkpoint into the model's net of its name."""
        load_nets(load_checkpoint(net_file), self)

    def preprocess_wrapper(self, in_dict: Dict) -> Dict:
        """Crop photo and mask by the mask's bbox so framing matches
        renders; the cropped silhouette stays only with ``keep_silhou``."""
        bbox = pp.get_bbox(in_dict["silhou"], th=CROP_SILHOU_THRES)
        in_dict["rgb"] = pp.crop(in_dict["rgb"], bbox, CROP_IN_SIZE,
                                 CROP_PAD, pad_zero=False)
        if self.keep_silhou:
            in_dict["silhou"] = pp.crop(in_dict["silhou"], bbox, CROP_IN_SIZE,
                                        CROP_PAD, pad_zero=False)
        else:
            del in_dict["silhou"]
        return self.preprocess(in_dict, mode="test")

    def test_on_batch(self, batch_i: int, batch: Dict) -> Dict:
        """Predict one batch, hand it to the visualizer (meshes and images
        under ``<output_dir>/batch%04d/``) and write
        ``<output_dir>/batch%04d.npz``."""
        outdir = join(self.output_dir, f"batch{batch_i:04d}")
        os.makedirs(outdir, exist_ok=True)
        arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
        pred = {k: as_numpy(v) for k, v in self.predict_step(arrays).items()}
        output = self.pack_output(pred, batch)
        self.visualizer.visualize(output, batch_i, outdir)
        np.savez(outdir + ".npz",
                 **{k: v for k, v in output.items() if v is not None})
        return output
