"""Convert a reference PyTorch checkpoint (.pt) into the checkpoint format
that both packages read, with the PyTorch port alone (no JAX): the
counterpart of tools/convert_reference_checkpoint.py, with its flags.

  python tools/convert_reference_checkpoint_torch.py --src full_model.pt \\
      --net genre_full_model --dst genre_full_model_converted.pt
  python tools/convert_reference_checkpoint_torch.py \\
      --src resnet18-f37072fd.pth --net resnet18 --dst resnet18.pt

``--net`` is a model alias (marrnet1, marrnet2, marrnet, wgangp, shapehd,
depth_pred_with_sph_inpaint / depth_inpaint, genre_full_model / genre)
or ``resnet18``, a torchvision ResNet-18 ``state_dict`` for
``--backbone_init``.  The nets and Adam's moments are converted
(``genre_shapehd_tpu_torch/core/reference.py``); keys of the file that no
table reads are listed on stderr.  The output feeds ``cli.test
--net_file`` / ``--marrnet1_file`` and ``cli.train --net1_path``,
``--inpaint_path``, ``--marrnet1``, ``--marrnet2``, ``--gan``,
``--backbone_init`` and ``--resume`` of either package.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from genre_shapehd_tpu_torch.core.checkpoint import save_checkpoint  # noqa
from genre_shapehd_tpu_torch.core.reference import (  # noqa: E402
    ALIASES, convert_checkpoint)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, help="reference .pt checkpoint")
    ap.add_argument("--dst", required=True, help="output path")
    ap.add_argument("--net", required=True, choices=ALIASES,
                    help="model alias")
    args = ap.parse_args(argv)

    payload = torch.load(args.src, map_location="cpu", weights_only=True)
    out, unread = convert_checkpoint(args.net, payload)
    for key in unread:
        print(f"unread: {key}", file=sys.stderr)
    save_checkpoint(args.dst, out)
    print(f"wrote {args.dst} ({len(out['nets'])} nets, "
          f"{len(out['optimizers'])} optimizers, {args.net}"
          f"{f'; {len(unread)} keys unread' if unread else ''})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
