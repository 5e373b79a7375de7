"""Test entry point (counterpart of ``genre_shapehd_tpu/cli/test.py``).

  python -m genre_shapehd_tpu_torch.cli.test --net genre_full_model \\
      --net_file full_model.pt \\
      --input_rgb 'photos/*_rgb.png' --input_mask 'photos/*_silhouette.png' \\
      --output_dir output/test --suffix '{net}' --overwrite \\
      --dtype bfloat16 --device cuda

It takes the command lines of ``scripts/test_*.sh`` with the module
swapped, the model's flags included (``--decoder_width``,
``--f32_heads`` and ``--exact_render`` build GenRe's net as the
checkpoint was trained).  The output directory is ``--output_dir``,
with ``_<--suffix>`` (formatted with the options) appended when one is
given.  Writes one ``batch%04d.npz`` per batch (pred_voxel, pred_proj_depth,
pred_proj_sph_full, rgb_path) and, under ``batch%04d/``, a copy of each
photo and the iso-surface meshes (.obj) of the three voxel grids.
Its last line, ``[launches] {...}``, gives the hand-written kernels'
launches of the run (``ops/cuda/__init__.py::launch_line``).
"""

from __future__ import annotations

import os
import shutil
import sys

from ..core.device import resolve_device
from ..core.registry import get_dataset, get_model
from ..data.loader import DataLoader
from ..ops.cuda import launch_line
from . import options


def main(argv=None) -> int:
    opt = options.parse_test(argv)
    resolve_device(opt.device)           # no GPU with --device cuda: raise
    if opt.suffix:
        opt.output_dir += "_" + opt.suffix.format(**vars(opt))
    print("[setup] output directory", opt.output_dir)
    if os.path.isdir(opt.output_dir):
        if not opt.overwrite:
            raise RuntimeError(f"output directory {opt.output_dir} exists; "
                               "pass --overwrite to clobber")
        shutil.rmtree(opt.output_dir)
    os.makedirs(opt.output_dir)

    model = get_model(opt.net, test=True)(opt)
    print("[setup] model", type(model).__module__, "on", model.device,
          "in", opt.dtype)
    dataset = get_dataset(opt.dataset)(opt, model=model)
    loader = DataLoader(dataset, opt.batch_size, opt.workers)
    print("[setup]", len(dataset), "samples")
    for i, batch in enumerate(loader):
        model.test_on_batch(i, batch)
        print(f"[test] batch {i + 1}/{len(loader)} done")
    model.visualizer.close()             # meshes and images are on disk
    print(launch_line(model.device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
