"""Batch-convert Mitsuba camera XMLs to packed camera-parameter .npy files
with the PyTorch port's utilities (no JAX): the counterpart of
tools/xml_to_cam_params.py, with its flags and the same bytes.

  python tools/xml_to_cam_params_torch.py --input_dir xmls --output_dir cams

For every ``--pattern`` file under --input_dir, build a Camera from its
lookAt block and save ``Camera.pack()`` (res, sensor width, position,
axes, focal length) to --output_dir with the same stem.
"""

import argparse
import glob
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from genre_shapehd_tpu_torch.utils.cam_para import (  # noqa: E402
    raw_camparam_from_xml)
from genre_shapehd_tpu_torch.utils.camera import Camera  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input_dir", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--pattern", default="*.xml")
    args = ap.parse_args(argv)

    os.makedirs(args.output_dir, exist_ok=True)
    files = sorted(glob.glob(os.path.join(args.input_dir, args.pattern)))
    for path in files:
        cam_param = raw_camparam_from_xml(path)
        cam = Camera()
        cam.res = [cam_param["width"], cam_param["height"]]
        cam.set_diagonal((0.036 ** 2 + 0.024 ** 2) ** 0.5)
        cam.lookat(cam_param["origin"], cam_param["target"],
                   cam_param["up"])
        stem = os.path.splitext(os.path.basename(path))[0]
        np.save(os.path.join(args.output_dir, stem + ".npy"),
                np.asarray(cam.pack(), dtype=np.float64))
    print(f"converted {len(files)} xml files")
    return 0


if __name__ == "__main__":
    sys.exit(main())
