"""Hand-written CUDA kernels (sources in ``genre_shapehd_tpu_torch/csrc``)
and their Python wrappers.  Nothing here compiles or loads a kernel at
import time."""

import json


def launch_counts() -> dict:
    """Every hand-written kernel's launches since the process started (or
    their counts were last reset)."""
    from . import (chamfer_kernel, critic_conv_kernel, critic_stem_kernel,
                   render_kernel, subpixel_kernel)
    return {**render_kernel.launches, **subpixel_kernel.launches,
            **chamfer_kernel.launches, **critic_stem_kernel.launches,
            **critic_conv_kernel.launches}


def launch_line(device) -> str:
    """``[launches] {...}``: :func:`launch_counts`, K3's by shape
    (``BxCinxSxSxS`` on a cube, ``BxCinxXxYxZ z<lo>+<n>`` on a box or a Z
    slab) and the peak memory allocated on ``device`` (null on the CPU),
    as one JSON object: what a parent process reads of a ``cli.train`` or
    ``cli.test`` run."""
    import torch

    from . import subpixel_kernel
    shapes = {"{0}x{1}x{2}x{2}x{2}".format(*k): n
              for k, n in subpixel_kernel.cube_launches.items()}
    shapes.update({"{}x{}x{}x{}x{} z{}+{}".format(*k): n
                   for k, n in subpixel_kernel.slab_launches.items()})
    peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
            if torch.device(device).type == "cuda" else None)
    return "[launches] " + json.dumps({
        "launches": launch_counts(), "deconv_final_shapes": shapes,
        "peak_gib": peak})
