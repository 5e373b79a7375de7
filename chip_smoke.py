#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (genre_shapehd_tpu_torch).

  python3 chip_smoke.py

Needs one CUDA GPU and nvcc; imports nothing of JAX.  Phases, each
raising on failure:

 1. the card's name and power limit; build every CUDA kernel from
    genre_shapehd_tpu_torch/csrc (one nvcc per source, in parallel) and
    the host iso-surface library;
 2. each kernel against its plain PyTorch version at the main path's
    shapes (and K1, K2, K3, K5 again in float32, the default command's
    type, with their times, bounds and library calls): the renderer's
    K1/K2 (batch 8, V=128, R=128, S=256, M=192,
    bfloat16, the whole renderer within tests/test_pallas_render.py's
    bounds), the final deconv K3 (batch 8, Cin=40, S=64, bfloat16; and
    at dec6's Z slab under ``--sp 2``, (4, 40, 64 x 64 x 32) with a halo
    plane at each end, padded to 40 planes, bfloat16 and float32, beside
    its plain version and ``F.conv_transpose3d``) and
    the Chamfer kernel K4 (8 x 8192 points, a ragged pair and the eval
    protocol's 1 x 1024), the critic's first layer K6 (the ShapeHD
    cell's 128 x 1 x 128³ float32 -> bfloat16, within one bf16 rounding
    of the float64 result and two steps of its plain version under
    autocast, beside bf16 ``F.conv3d`` and ``F.leaky_relu``), its
    backward's mask kernel (the fine-tuning step's 64 x 64 x 64³,
    channels-last bf16 in, channels-first out, bit for bit the plain
    mask's), its
    middle layers K7 (the four shapes of one critic at batch 128,
    channels-last, within the same bounds, beside cuDNN in NCDHW and in
    channels_last_3d), plus
    float32 checks at smaller sizes with TF32 off; K1 and K5 also
    against ``F.grid_sample``, which computes each in one call; K1 on
    the float32 volume against the volume cast to bf16 (bit for bit),
    and one kernel per timed K1, K2, K3 and K5 call (torch.profiler; K3
    in float32 and K4 too); K1, K2, K3 and K5 at
    edge shapes (V = 34; odd S, S = 1, S > 64, Cin < 16, Cin > 288; V =
    33, S = 98, groups across a batch boundary; K3 also on boxes and Z
    slabs, from position 0 or 1, TMA and plain-load staging), K4 on
    clouds with exact
    copies (ties to the lowest index), and K2's and K5's ValueError for a
    slab larger than shared memory; kernel,
    plain, library and bound times (CUDA events, median of 25, L2 flushed
    before each), each kernel's share of its bound and achieved GB/s, K2's
    and K5's shared-memory plan;
 3. reconstruct: 16 generated photo + mask PNGs, a seeded GenreNet
    exported to a checkpoint in the JAX package's format,
    ``genre_shapehd_tpu_torch.cli.test`` at 256² -> 128³ in bfloat16,
    batch 8, on the card, with scripts/test_genre.sh's ``--suffix
    '{net}'`` (the output in ``<--output_dir>_genre_full_model``); launch
    counts of K1/K2/K3; the .npz files, and
    the visualizer's photo copies and .obj meshes, which must parse; then
    the users' default command, ``cli.test`` with no ``--dtype``
    (float32, PyTorch's default TF32 settings), one K3 launch a forward;
 4. score: seeded ground-truth solids at 128³ beside the per-item
    predictions, ``genre_shapehd_tpu_torch.cli.eval_chamfer`` on the card
    (K4's launch count = items scored) and on the CPU (agreement 1e-5),
    and a ground truth against itself under another sampling seed;
 5. the CUDA forward against the CPU forward on a small input (float32),
    then recon/s of the batch-8 bfloat16 forward and of the float32 one
    (TF32 off, and cuDNN TF32 on), and a torch.profiler
    pass over 3 forwards: device time per stage (the ``genre.*`` spans of
    the model), the hand-written and the top kernels, and the device's
    idle share;
 6. the training path: K5 (``render_stage2_samples``) against its plain
    version at the forward's batch-8 and the training's batch-4 shapes,
    bfloat16, and in float32 at a smaller size; the renderer's gradient
    on the card (K1, K2 forward; K1, K5 and the transpose backward)
    against the CPU's, float32, reduced size; dec6's backward at batch 4
    through a second forward and autograd and by convolution_backward;
    then
    ``genre_shapehd_tpu_torch.cli.train`` at 256² -> 128³, bfloat16,
    batch 4, on the synthetic data, in stage 3 and with --joint_train:
    finite losses, the refine net moved, net1 and net2 only when joint,
    the launch counts per step, a checkpoint that ``cli.test`` reads, the
    step time and peak memory, and a torch.profiler pass over one step of
    each kind;
 7. GenRe's staged training on procedural scenes (48 generated up front
    in 8 processes), ``cli.train`` at 256² -> 128³, bfloat16, batch 4,
    8 steps a stage: MarrNet-1 ``--pred_depth_minmax``, then
    ``depth_pred_with_sph_inpaint --net1_path`` <stage 1>, then
    ``genre_full_model --inpaint_path`` <stage 2> ``--surface_weight
    10``: finite losses, the launches of each stage (K1, K2 in stages 2
    and 3, K3 in stage 3), which nets moved (stage 1 all of MarrNet-1,
    stage 2 net2 with net1 bit for bit stage 1's checkpoint, statistics
    included, stage 3 the refine net only), step time and peak memory;
    then ``tools/qualrun_torch.py``'s ``eval_quality`` of stage 3's
    checkpoint on 16 held-out scenes (IoU, Chamfer; K4 once an item).

 8. the MarrNet-2 / ShapeHD family: K3 at MarrNet-2's decoder (8, 32,
    64³, a bias) and the WGAN-GP generator's (4, 64, 64³, no bias) shapes
    against its plain version (bf16 under ``k3_bf16_within``, float32 at
    1e-5), timed beside its bound and ``F.conv_transpose3d``; then
    ``cli.train`` on phase 7's scenes at 256² -> 128³, bfloat16, batch 4,
    8 steps each: marrnet2 --canon_sup, wgangp --canon_voxel (and with
    --gan_d_iter 2), shapehd --canon_sup --marrnet2 --gan --w_gan_loss
    1e-3, marrnet --canon_sup --marrnet1 <phase 7's stage 1> --marrnet2:
    finite losses, K3's, K6's and K7's launches (K6 twice ShapeHD's eval
    batch, once each way a ShapeHD step, its backward on the mask kernel
    and K3; K7 four
    times each; neither in a WGAN-GP step), which nets moved (the frozen
    ones bit for bit), step time, peak memory; ``cli.test --net marrnet``
    and ``--net shapehd --marrnet1_file`` on phase 3's photos at batch 8
    (K3 once / twice a batch, K6 twice and K7 eight times a ShapeHD
    batch: the kernels line's K6 and K7 launches, the .npz keys, the
    meshes at 0.9); the ShapeHD checkpoint's
    held-out score (K4 once an item, K6 twice a batch); a torch.profiler
    pass over one WGAN-GP and one ShapeHD step.
 9. GenRe's ShapeNet training path: a ShapeNet-layout tree written from
    phase 7's scenes (two synsets, two views a model, 8-bit RGB, normal
    and silhouette PNGs, 16-bit depth PNGs, rows filtered as libpng
    chooses, .npy, .npz, .mat, a view without voxels, canonical ones
    included), then the command lines of scripts/train_marrnet1.sh,
    train_inpaint.sh (again with --exact_render), train_full_genre.sh and
    finetune_genre_joint.sh (--resume -1 of stage 3), recorded from the
    scripts, through ``cli.train --dataset shapenet`` at 256² -> 128³,
    bfloat16, batch 4, with smaller epochs, one synset and the tree's
    --data_root (--tensorboard where tensorboardX imports; elsewhere the
    run with it must stop with an ImportError before its first step):
    each dataset's views, finite losses, the launches of K1, K2, K3 and
    K5 (none of K1, K2 under --exact_render), which nets moved (the
    frozen ones bit for bit), the eval visualizations and batch0000.npz,
    step and data time, peak memory, the loader's and ``read_png``'s
    host times (480², by row filter); then the exact renderer against
    K1 + K2 on four of phase 7's solids at 128³, batch 4, float32 and
    bf16, within a mean of 0.01 and a maximum of 0.1 (the JAX package's
    bounds), with both times and the exact renderer's peak memory.
10. data parallelism: ``cli.train --multihost`` under ``python -m
    torch.distributed.run`` (subprocesses), float32 with TF32 off, full
    width, global batch 4, synthetic data: GenRe's joint step (4 steps)
    in one process, on 1 rank over NCCL and on 2 ranks sharing card 0
    over gloo; WGAN-GP --canon_voxel (2 steps) in one process and on 2
    ranks; the joint step in bf16 on 2 ranks.  ``[dp]`` lines: each
    run's losses, step time, peak memory, each rank's parameter hash
    (equal on both ranks), the launches of K1, K2, K5 and K3 on rank 0's
    profiled step (``--profile_step``) and counted by each rank's
    wrappers over its run, and the gradients' all-reduce;
    the relative loss difference from the one-process run by step (step
    1 within 1e-4, WGAN-GP's 2e-3 for its gradient penalty; steps 2 and
    3 within 1e-3).  Two ranks on one card show the cost of the gloo
    transport, not a scaling.
11. spatial parallelism: ``cli.train --multihost --sp 2`` on 2 gloo
    ranks sharing card 0 (dp 1 x sp 2), GenRe's joint step with phase
    10's flags and seed (4 steps): each rank runs the 2D nets on the
    whole batch and the 3D U-Net on its half of the Z axis (halo
    exchanges, the 4³ gather, dec6 on K3 at the slab shape).  ``[sp]``
    line: losses and their relative difference from phase 10's one
    process (step 1 within 1e-4, steps 2 and 3 within 1e-3), step time,
    peak memory per rank, the ranks' parameter hashes (equal), rank 0's
    profiled step's kernels, K3's slab launches by shape and the ``sp.halo``
    and ``sp.gather`` spans.

12. the reference release's checkpoints: GenRe's (phase 3's seeded
    weights with seeded Adam moments at step 2), ShapeHD's three nets and
    a MarrNet-1, written in the reference's layout and PyTorch's legacy
    format (``reference_layout``, the inverse of the port's tables) and
    converted by ``tools/convert_reference_checkpoint_torch.py`` in
    parallel processes, with no key left unread; ``cli.test --net
    genre_full_model`` and ``--net shapehd --marrnet1_file`` on 8 of
    phase 3's photos, bf16, from the converted files and from the port's
    own checkpoints of the same weights: the ``.npz`` bit for bit under
    deterministic algorithms, K1, K2, K3 once a GenRe forward, K3 and K6
    twice a ShapeHD one; ``cli.train --joint_train --resume -1`` from the
    converted GenRe file for one step: a finite loss, Adam's count 2 -> 3,
    K1, K2, K3 and K5 launched, and the weights at least 0.1 lr (mean
    |difference|) from the step resumed from the same file with its
    moments zeroed.  ``[refckpt]`` lines, with the phase's wall time.

13. the ShapeHD workflow as its launch scripts run it: ``bash
    scripts_torch/<script> <synset>`` in subprocesses, on phase 9's tree
    at 256² -> 128³, bfloat16, batch 4, 4 steps and an eval batch each,
    with --epoch, --epoch_batches, --eval_batches, --vis_batches_vali,
    --vis_param_f (meshes at 0.9), --logdir, --data_root, --dtype and
    --log_batch appended: train_marrnet2.sh beside train_wgangp.sh, then
    finetune_shapehd.sh (MARRNET2 and GAN those runs' checkpoints,
    W_GAN_LOSS its default) beside finetune_marrnet.sh (MARRNET1 phase
    9's MarrNet-1, MARRNET2): each run's views (the view without canonical
    voxels left out), finite losses, the run directory its suffix names,
    K3's launches by shape, K6's and K7's (``[launches]``, the last line
    of a run; K6 once each way a ShapeHD step, its backward on the mask
    kernel and K3 at the generator's shape, twice ShapeHD's eval batch and twice a ShapeHD test
    photo; K7 four times each of those),
    step and data time, peak memory, which nets moved and the frozen
    ones bit for bit; then test_shapehd.sh, test_marrnet.sh and
    test_genre.sh at once on 8 of phase 3's photos (K3, and K1, K2 for
    GenRe, at batch 1; the .npz and meshes), and ``tools/trainrun_artifact_torch.py
    --steps 12`` (GenRe at full scale, a finite loss series).
    ``[scripts]`` lines, with the phase's wall time.

Prints a ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.  Scratch files go to build/chip_smoke/ under the repository.
"""

from __future__ import annotations

import contextlib
import glob
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
MAIN = dict(b=8, v=128, r=128, z=256, m=192)
H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12           # float32 outside the tensor cores
H100_BF16_FLOPS = 989e12         # bfloat16 tensor cores, dense
DEC6 = dict(b=8, cin=40, s=64)   # dec6 of the 3D U-Net at 128³, nf 20
#: dec6 on rank 0's Z slab under ``cli.train --sp 2`` at batch 4: 32 own
#: planes with a halo plane at each end, zero planes up to 40 (the halo
#: exchange pads to a multiple of 8 for TMA's 16-byte rows)
DEC6_SLAB = dict(b=4, cin=40, s=64, zs=32, z=40)
TRAIN = dict(batch=4, steps=8)   # cli.train: batch, steps of each kind
#: K7 launches a call of the res-128 critic: Conv3D_1 .. Conv3D_4
K7_PER_CRITIC = 4
#: K7's shapes at the ShapeHD cell's batch 128: (Cin, input R, Cout)
CRITIC_CONV_SHAPES = ((64, 64, 64), (64, 32, 128), (128, 16, 256),
                      (256, 8, 512))
SOURCES = {
    "render_stage1": "genre_shapehd_tpu_torch/csrc/render_kernel.cu",
    "render_stage2_scan": "genre_shapehd_tpu_torch/csrc/render_kernel.cu",
    "deconv_final": "genre_shapehd_tpu_torch/csrc/deconv_final_kernel.cu",
    "nn_min_dist": "genre_shapehd_tpu_torch/csrc/chamfer_kernel.cu",
    "render_stage2_samples": "genre_shapehd_tpu_torch/csrc/render_kernel.cu",
    "critic_stem": "genre_shapehd_tpu_torch/csrc/critic_stem_kernel.cu",
    "critic_stem_mask": "genre_shapehd_tpu_torch/csrc/critic_stem_kernel.cu",
    "critic_conv": "genre_shapehd_tpu_torch/csrc/critic_conv_kernel.cu",
}
#: the one PyTorch call that computes each kernel's function (library_ms)
LIBRARY = {
    "render_stage1": "F.grid_sample, float32",
    "render_stage2_scan": None,
    "deconv_final": "F.conv_transpose3d",
    "nn_min_dist": "torch.cdist, then min",
    "render_stage2_samples": "F.grid_sample, float32 c",
    "critic_stem": "F.conv3d, then F.leaky_relu, bf16",
    "critic_stem_mask": "aten.leaky_relu_backward on channels-first g "
                        "and y (no layout pass)",
    "critic_conv": "F.conv3d, then F.leaky_relu, bf16, NCDHW (the parent's "
                   "path; channels_last_3d beside it)",
}
REPLACES = {
    "render_stage1": "genre_shapehd_tpu/ops/pallas/render_kernel.py:170 "
                     "(_s1_sparse_kernel; dense twin _s1_kernel :292)",
    "render_stage2_scan": "genre_shapehd_tpu/ops/pallas/render_kernel.py:392 "
                          "(_s2scan_kernel)",
    "deconv_final": "genre_shapehd_tpu/ops/pallas/subpixel_kernel.py:92 "
                    "(_final_tail_kernel, with the phase conv of _final_fwd "
                    ":113)",
    "nn_min_dist": "genre_shapehd_tpu/ops/pallas/chamfer_kernel.py:36 "
                   "(_min_dist_kernel)",
    "render_stage2_samples": "genre_shapehd_tpu/ops/pallas/render_kernel.py"
                             ":312 (_s2_kernel via _s2_call :366, "
                             "pallas_call :373)",
    "critic_stem": "none: the JAX package leaves the critic's first layer "
                   "(genre_shapehd_tpu/nn/voxel_nets.py:466, "
                   "VoxelDiscriminator) to XLA",
    "critic_stem_mask": "none: the JAX package leaves the critic's input "
                        "gradient to XLA's autodiff",
    "critic_conv": "none: the JAX package leaves the critic's middle layers "
                   "(genre_shapehd_tpu/nn/voxel_nets.py:466, "
                   "VoxelDiscriminator) to XLA",
}


def log(*a):
    print(*a, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


# ------------------------------------------------------------ measurement
def time_ms(fn, flush, reps=25, warmup=3):
    """Median milliseconds of ``fn()`` by CUDA events, L2 flushed before
    each run."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float, peak: float = H100_F32_FLOPS):
    """Least milliseconds for the work, what sets it (bytes over the
    memory rate or operations over ``peak`` for their type), and the
    bytes."""
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def k3_bf16_within(d_max, d_mean, e, e_plain, scale, exact_max):
    """The bounds on a bf16 K3 result: within 1e-2 of ``scale`` (the
    plain version's largest magnitude) at most and 1e-3 on average of the
    plain version (``d_max``, ``d_mean``), and within half a bf16 step at
    the largest magnitude, u = 2^-8 of ``exact_max``, of the float32
    result (``e``).  The 1e-2 bound (~2.5 u) presumes the plain version
    within 1.5 u of the float32 result; it is waived only where the plain
    version (``e_plain`` from the float32 result) lies further.  Returns
    (ok, waived)."""
    u = 2.0 ** -8 * exact_max
    waived = d_max > 1e-2 * scale and e_plain > 1.5 * u
    ok = (d_max <= 1e-2 * scale or waived) and d_mean <= 1e-3 * scale \
        and e <= u
    return ok, waived


def kernels_launched(*calls) -> dict:
    """Device kernels by name that ``calls`` launch, in one torch.profiler
    session.  It has to be the process's first: after one, a session's
    kernels can arrive in the next one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith(("Memcpy", "Memset"))}


def sass_count(source: str, opcode: str):
    """Instructions ``opcode`` per kernel in the built library of
    ``source``, from ``cuobjdump -sass``."""
    from genre_shapehd_tpu_torch.ops.cuda import build
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(build.library_path(source))],
                         capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = 0
            continue
        # "/*0230*/  [@P0] HMMA.16816.F32.BF16 R4, ... ;  /* 0x... */"
        words = line.split("*/", 1)[-1].split()
        words = words[1:] if words[:1] and words[0].startswith("@") else words
        if name and words and words[0].split(".")[0] == opcode:
            counts[name] += 1
    return counts


def volume(b, v, seed, device):
    """Clipped occupancy: a ball plus noise (saturated and boundary
    probabilities along every ray)."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    vox = torch.rand((b, v, v, v), generator=g, device=device) * 0.2
    c = (torch.arange(v, device=device) + 0.5) / v - 0.5
    r2 = c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None] ** 2
    vox = vox + (r2 < 0.09).float() * 0.9
    return vox.clamp(1e-5, 1 - 1e-5)


def _grid(a, b, device, batch):
    import torch
    g = torch.as_tensor(np.stack([a, b], -1), dtype=torch.float32)
    return g.to(device).expand(batch, -1, -1, -1).contiguous()


def library_grids(b, v, r, z, m, device):
    """The renderer's two stages as ``F.grid_sample`` grids: each hat-weight
    pair is a bilinear tap with align_corners=True, and each out-of-range
    corner gets zero weight, as padding_mode='zeros' gives.  Stage 1 samples
    the volume's (x, y) plane at (rho cos th, rho sin th), z as channels;
    stage 2 samples c's (m, z) plane of each theta at (sin ph t, cos ph t),
    theta as channels."""
    from genre_shapehd_tpu_torch.ops.render_sph_fast import _rho_max
    phis = np.deg2rad(np.linspace(0, 180, r * 2 + 1)[1::2])[:, None]
    thetas = np.deg2rad(np.linspace(0, 360, r + 1)[:-1])[:, None]
    t = 2.0 * (1.0 - np.linspace(0.0, 1.0, z))[None]
    rho_max = _rho_max(v)
    rho = np.linspace(0.0, rho_max, m)[None]
    # grid[..., 0] indexes the last (W) axis, grid[..., 1] the H axis
    return (_grid(rho * np.sin(thetas), rho * np.cos(thetas), device, b),
            _grid(np.cos(phis) * t, 2.0 * np.sin(phis) * t / rho_max - 1.0,
                  device, b))


def library_stage1(vox, grid):
    """(B, V, V, V) volume -> (B, Z, Th, M): K1's function in one call."""
    import torch.nn.functional as F
    return F.grid_sample(vox.permute(0, 3, 1, 2), grid, mode="bilinear",
                         padding_mode="zeros", align_corners=True)


def library_stage2_samples(c, grid):
    """c (B, Th, M, V) -> (B, Th, Ph, S): K5's function in one call."""
    import torch.nn.functional as F
    return F.grid_sample(c, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=True)


# ---------------------------------------------------------------- phases
def phase_kernels(device):
    import torch
    from genre_shapehd_tpu_torch.ops.cuda import render_kernel as rk
    b, v, r, z, m = (MAIN[k] for k in "bvrzm")
    bf = torch.bfloat16
    vox = volume(b, v, 0, device)
    rk.reset_launches()
    c = rk.stage1(vox, v, r, z, m, bf)
    out = rk.stage2(c, v, r, z, m, bf)
    torch.cuda.synchronize()
    check(rk.launches == {"render_stage1": 1, "render_stage2_scan": 1,
                          "render_stage2_samples": 0},
          f"kernel launches {rk.launches}")
    c_ref = rk.stage1_plain(vox, v, r, z, m, bf)
    out_ref = rk.stage2_plain(c, v, r, z, m, bf)
    full_ref = rk.stage2_plain(c_ref, v, r, z, m, bf)
    errs = {}
    # K1: the plain version rounds t1 = sum_x wx*vox to bf16, the kernel
    # does not; both round c to bf16 (c <= 1): bound 1.6e-2 max, 1e-3 mean
    d = (c.float() - c_ref.float()).abs()
    errs["render_stage1"] = (float(d.max()), float(d.mean()))
    check(d.max() < 1.6e-2 and d.mean() < 1e-3, f"K1 vs plain {errs}")
    # K2 on the same c: the plain version rounds t2 to bf16 and uses the
    # product form of the stop probability; tests/test_pallas_render.py's
    # bounds (max 3e-2, mean 2e-3)
    d = (out - out_ref).abs()
    errs["render_stage2_scan"] = (float(d.max()), float(d.mean()))
    check(d.max() < 3e-2 and d.mean() < 2e-3, f"K2 vs plain {errs}")
    d = (out - full_ref).abs()
    errs["renderer"] = (float(d.max()), float(d.mean()))
    check(d.max() < 3e-2 and d.mean() < 2e-3, f"K1+K2 vs plain {errs}")
    # the library call, float32, against K1: K1's bounds (it rounds the
    # volume, its weights and c to bf16)
    g1 = library_grids(b, v, r, z, m, device)[0]
    d = (library_stage1(vox, g1).permute(0, 2, 3, 1) - c.float()).abs()
    errs["library_stage1"] = (float(d.max()), float(d.mean()))
    check(d.max() < 1.6e-2 and d.mean() < 1e-3, f"grid_sample vs K1 {errs}")
    log("[kernels] bf16 main-path shapes, max/mean abs err:",
        json.dumps(errs))
    # K1 reads the float32 volume itself and rounds each element as a
    # cast to bf16 would: the same c as from the cast volume, bit for bit
    check(torch.equal(c, rk.stage1(vox.to(bf), v, r, z, m, bf)),
          "K1 on the float32 volume differs from K1 on the cast volume")
    log("[kernels] K1 on the float32 volume: bit for bit the cast volume's c")

    # float32 at a smaller size, TF32 off: summation order only (1e-5)
    s = dict(b=2, v=64, r=64, z=128, m=96)
    vox32 = volume(s["b"], s["v"], 1, device)
    args = (s["v"], s["r"], s["z"], s["m"], torch.float32)
    c32 = rk.stage1(vox32, *args)
    o32 = rk.stage2(c32, *args)
    dc = float((c32 - rk.stage1_plain(vox32, *args)).abs().max())
    do = float((o32 - rk.stage2_plain(c32, *args)).abs().max())
    dl = float((library_stage1(vox32, library_grids(**s, device=device)[0])
                .permute(0, 2, 3, 1) - c32).abs().max())
    # grid_sample places its taps from float32 grid coordinates, off by up
    # to ~1e-5 of a voxel at 128 voxels: 1e-4 for it
    check(dc < 1e-5 and do < 1e-5 and dl < 1e-4,
          f"f32 K1 {dc} K2 {do} grid_sample vs K1 {dl}")
    log(f"[kernels] f32 {s}: K1 max err {dc:.3g}, K2 max err {do:.3g}, "
        f"grid_sample vs K1 {dl:.3g}")

    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=device)
    ms = {
        "render_stage1": time_ms(lambda: rk.stage1(vox, v, r, z, m, bf),
                                 flush),
        "render_stage2_scan": time_ms(lambda: rk.stage2(c, v, r, z, m, bf),
                                      flush),
    }
    plain_ms = {
        "render_stage1": time_ms(
            lambda: rk.stage1_plain(vox, v, r, z, m, bf), flush),
        "render_stage2_scan": time_ms(
            lambda: rk.stage2_plain(c, v, r, z, m, bf), flush),
    }
    # K1 is one grid_sample (float32, the volume's dtype); K2's scan has
    # no library call
    library_ms = {"render_stage1": time_ms(lambda: library_stage1(vox, g1),
                                           flush),
                  "render_stage2_scan": None}
    # bytes: every input read once, every output written once
    tap_bytes_1 = r * m * (4 + 8) * 2           # x, y tables
    c_bytes = b * r * m * v * 2
    bounds = {
        # the volume in its own dtype (float32 on the main path), c in
        # bf16; 4 weight products + 4 fma per element of c
        "render_stage1": bound(vox.numel() * vox.element_size() + c_bytes
                               + tap_bytes_1,
                               12.0 * b * r * m * v),
        # c, the tap records, the depth map; per sample 4 multiply-adds
        # (8), the clip (2), 1 - p, the running product and the sum (3)
        "render_stage2_scan": bound(
            c_bytes + record_bytes(v, r, z, m, bf) + b * r * r * 4,
            13.0 * b * r * r * z),
    }
    log_plan("K2 render_stage2_scan", v, m, bf, ms["render_stage2_scan"],
             bounds["render_stage2_scan"])
    return errs, ms, plain_ms, library_ms, bounds


def record_bytes(v, r, z, m, dtype):
    """Bytes of K2's and K5's tap-record table (read once per call)."""
    from genre_shapehd_tpu_torch.ops.cuda import render_kernel as rk
    rec = rk.tap_records(v, r, z, m, dtype)
    return rec.numel() * rec.element_size()


def log_plan(what, v, m, dtype, ms, bnd):
    """The shared-memory plan of a K2 / K5 call and its share of the
    bound."""
    from genre_shapehd_tpu_torch.ops.cuda import render_kernel as rk
    pl = rk.plan(v, m, dtype)
    log(f"[kernels] {what}: G {pl['group']}, "
        f"row stride {pl['row_stride']} elements, shared memory "
        f"{pl['smem_bytes']} bytes; {ms:.4f} ms, bound {bnd[0] * 1e3:.1f} "
        f"us ({bnd[1]}), {100 * bnd[0] / ms:.1f} % of the bound, "
        f"{bnd[2] / ms / 1e6:.0f} GB/s")


def k3_check(x, w, bias, z_lo=0, z_out=None):
    """K3 on ``x`` against its plain version, synchronized: float32 within
    1e-5 of the output's scale; bfloat16 by :func:`k3_bf16_within` against
    the float32 result of the rounded inputs.  Returns (max, mean) abs
    error over the scale, the kernel's and the plain version's distance
    from the float32 result in u (bf16; else None), and whether the plain
    version's bound was waived."""
    import torch
    import torch.nn.functional as F
    from genre_shapehd_tpu_torch.ops.cuda import subpixel_kernel as sk
    b, _, nx, ny, nz = x.shape
    z_out = nz - 2 * z_lo if z_out is None else z_out
    out = sk.deconv_final(x, w, bias, z_lo, z_out)
    torch.cuda.synchronize()
    shape = (b, 1, 2 * nx, 2 * ny, 2 * z_out)
    check(out.shape == shape and out.dtype == x.dtype,
          f"K3 output {tuple(out.shape)} {out.dtype} for x "
          f"{tuple(x.shape)} z{z_lo}+{z_out}")
    ref = sk.deconv_final_plain(x, w, bias, z_lo, z_out).float()
    scale = float(ref.abs().max())
    d = (out.float() - ref).abs()
    err = (float(d.max()) / scale, float(d.mean()) / scale)
    what = f"K3 at {tuple(x.shape)} z{z_lo}+{z_out} {str(x.dtype)[6:]}"
    if x.dtype == torch.float32:
        check(err[0] <= 1e-5, f"{what}: {err[0]} of the scale {scale}")
        return err, None, False
    exact = F.conv_transpose3d(x.float(), w.to(torch.bfloat16).float(),
                               bias, stride=2, padding=1)[
        ..., 2 * z_lo:2 * (z_lo + z_out)]
    e = float((out.float() - exact).abs().max())
    e_plain = float((ref - exact).abs().max())
    u = 2.0 ** -8 * float(exact.abs().max())
    ok, waived = k3_bf16_within(float(d.max()), float(d.mean()), e,
                                e_plain, scale, float(exact.abs().max()))
    check(ok, f"{what}: {float(d.max())} {float(d.mean())} vs plain, {e} "
              f"vs float32, the plain version {e_plain} vs float32, scale "
              f"{scale}")
    if waived:
        log(f"[kernels] {what}: the plain version lies {e_plain / u:.2f} u "
            f"(2^-8 of the largest magnitude) from the float32 result, "
            f"beyond the 1.5 u its 1e-2 bound presumes; the kernel, "
            f"{e / u:.2f} u from it, is held to 1 u alone")
    return err, [e / u, e_plain / u], waived


def k3_slab_row(device, g, dtype):
    """K3 at dec6's Z slab (``DEC6_SLAB``) in ``dtype``, against its plain
    version (:func:`k3_check`): the x a rank of ``cli.train --sp 2``
    hands it (a neighbour's plane at each end, zero planes after), its
    call, the plain version's, the one library call of the same function
    (``F.conv_transpose3d`` of the 34 planes with the Z padding that
    crops to the slab's output), and its bound."""
    import torch
    import torch.nn.functional as F
    from genre_shapehd_tpu_torch.ops.cuda import subpixel_kernel as sk
    b, cin, s, zs, z = (DEC6_SLAB[k] for k in ("b", "cin", "s", "zs", "z"))
    dt = getattr(torch, dtype)
    x = torch.zeros((b, cin, s, s, z), device=device, dtype=dt)
    x[..., :zs + 2] = torch.randn((b, cin, s, s, zs + 2), generator=g,
                                  device=device).to(dt)
    w = torch.randn((cin, 1, 4, 4, 4), generator=g, device=device) * 0.05
    bias = torch.full((1,), 0.1, device=device)
    err, us, _ = k3_check(x, w, bias, 1, zs)
    wl, bl = w.to(dt), bias.to(dt)
    lib = lambda: F.conv_transpose3d(                       # noqa: E731
        x[..., :zs + 2], wl, bl, stride=2, padding=(1, 1, 3))
    ref = sk.deconv_final_plain(x, w, bias, 1, zs).float()
    d = float((lib().float() - ref).abs().max()) / float(ref.abs().max())
    # float32: summation order; bf16: two roundings of the library's
    check(d <= (1e-5 if dt == torch.float32 else 2.0 ** -6),
          f"the slab's library call vs plain: {d} of the scale")
    del ref
    # the bytes the function needs: its own zs planes and a halo plane at
    # each end (not the zero planes after them, which only TMA's 16-byte
    # rows ask for), the weight, the bias and the 2 zs output planes
    e = x.element_size()
    n_in = b * cin * s * s * (zs + 2)
    n_out = b * (2 * s) ** 2 * 2 * zs
    return dict(
        shape=[b, cin, s, s, z], z_lo=1, z_out=zs, dtype=dtype,
        max_abs_err=err[0], mean_abs_err=err[1], u_vs_float32=us,
        call=lambda: sk.deconv_final(x, w, bias, 1, zs),
        plain=lambda: sk.deconv_final_plain(x, w, bias, 1, zs),
        library=lib,
        bound=bound(n_in * e + cin * 64 * 4 + 4 + n_out * e,
                    2.0 * 8 * cin * n_out,
                    H100_BF16_FLOPS if dt == torch.bfloat16
                    else H100_F32_FLOPS))


def phase_deconv_final_slab(device, flush):
    """K3 at dec6's Z slab under ``cli.train --sp 2`` (``DEC6_SLAB``), in
    bfloat16 and float32 (TF32 off), against its plain version and timed
    beside it, the library call and the bound."""
    import torch
    g = torch.Generator(device=device).manual_seed(21)
    rows = {}
    for dtype in ("bfloat16", "float32"):
        row = k3_slab_row(device, g, dtype)
        bms, by, nbytes = row.pop("bound")
        for fn, key in (("call", "ms"), ("plain", "plain_ms"),
                        ("library", "library_ms")):
            row[key] = time_ms(row.pop(fn), flush)
        row.update(bound_ms=bms, bound_by=by, bound_share=bms / row["ms"],
                   achieved_gb_per_s=nbytes / row["ms"] / 1e6)
        rows[dtype] = row
        log(f"[kernels] K3 at dec6's --sp 2 slab {row['shape']} z1+"
            f"{row['z_out']} {dtype}: {row['ms']:.4f} ms, bound "
            f"{bms * 1e3:.1f} us ({by}), {100 * bms / row['ms']:.1f} % of "
            f"it; plain {row['plain_ms']:.4f} ms; library "
            f"{row['library_ms']:.4f} ms; max/mean abs err of the scale "
            f"{row['max_abs_err']:.3g}/{row['mean_abs_err']:.3g}")
    return rows


def phase_deconv_final(device, flush):
    """K3 against ``F.conv_transpose3d`` (its plain version and the
    library call) at dec6's shape, and in float32 at a smaller size."""
    import torch
    import torch.nn.functional as F
    from genre_shapehd_tpu_torch.ops.cuda import subpixel_kernel as sk
    b, cin, s = (DEC6[k] for k in ("b", "cin", "s"))
    g = torch.Generator(device=device).manual_seed(3)
    bf = torch.bfloat16
    x = torch.randn((b, cin, s, s, s), generator=g, device=device).to(bf)
    w = torch.randn((cin, 1, 4, 4, 4), generator=g, device=device) * 0.05
    bias = torch.full((1,), 0.1, device=device)
    # float32 reference on the inputs as the kernel reads them (x and the
    # weight rounded to bf16, the bias not).  The weight is rescaled so
    # that the output's scale is 7, in the upper half of the bf16 binade
    # [4, 8) whose step is 2^-5: the bounds below are fractions of the
    # scale, a bf16 step is a fraction of the binade
    w_r = w.to(bf).float()
    exact = F.conv_transpose3d(x.float(), w_r, bias, stride=2, padding=1)
    w = w * (7.0 / float(exact.abs().max()))
    w_r = w.to(bf).float()
    exact = F.conv_transpose3d(x.float(), w_r, bias, stride=2, padding=1)
    scale = float(exact.abs().max())
    sk.reset_launches()
    out = sk.deconv_final(x, w, bias)
    torch.cuda.synchronize()
    check(sk.launches == {"deconv_final": 1}, f"K3 launches {sk.launches}")
    check(out.shape == (b, 1, 2 * s, 2 * s, 2 * s) and out.dtype == bf,
          f"K3 output {tuple(out.shape)} {out.dtype}")
    # the kernel rounds the float32 sum once: half a bf16 step, 2^-9 of
    # the value, from the float32 result (2^-8 of the scale bounds it)
    e_exact = float((out.float() - exact).abs().max())
    check(e_exact <= 2.0 ** -8 * scale, f"K3 vs float32 {e_exact}")
    ref = sk.deconv_final_plain(x, w, bias).float()
    e_plain = float((ref - exact).abs().max())
    del exact
    d = (out.float() - ref).abs()
    err = (float(d.max()), float(d.mean()))
    # the plain version (bf16 through the library) rounds more than once
    # (the sum, the bias, their sum) and lies up to 1.5 bf16 steps from
    # the float32 result, so the two differ by up to 2 steps of 2^-5:
    # max 1e-2, mean 1e-3 of the output's scale
    check(err[0] <= 1e-2 * scale and err[1] <= 1e-3 * scale,
          f"K3 vs plain {err}, scale {scale}, plain vs float32 {e_plain}")
    del ref, d
    # float32, TF32 off (main() switches it off for cuDNN): summation
    # order only, 1e-5 of the scale
    x32 = torch.randn((2, 12, 16, 16, 16), generator=g, device=device)
    w32 = torch.randn((12, 1, 4, 4, 4), generator=g, device=device) * 0.1
    r32 = sk.deconv_final_plain(x32, w32, bias)
    e32 = float((sk.deconv_final(x32, w32, bias) - r32).abs().max())
    check(e32 <= 1e-5 * float(r32.abs().max()), f"f32 K3 {e32}")
    log(f"[kernels] K3 deconv_final bf16 {DEC6}: max/mean abs err "
        f"{err[0]:.3g}/{err[1]:.3g} vs plain, max {e_exact:.3g} vs the "
        f"float32 result (the plain version: {e_plain:.3g}), at scale "
        f"{scale:.3g}; f32 (2,12,16^3) max err {e32:.3g}")

    wb, bb = w.to(bf), bias.to(bf)
    ms = time_ms(lambda: sk.deconv_final(x, w, bias), flush)
    plain_ms = time_ms(lambda: sk.deconv_final_plain(x, w, bias), flush)
    library_ms = time_ms(lambda: F.conv_transpose3d(
        x, wb, bb, stride=2, padding=1), flush)
    # bytes: x, the float32 weight and bias as the kernel reads them, the
    # output; 8 taps x Cin multiply-adds per output, on bf16 inputs
    n_out = b * (2 * s) ** 3
    bnd = bound(x.numel() * 2 + cin * 64 * 4 + 4 + n_out * 2,
                2.0 * 8 * cin * n_out, H100_BF16_FLOPS)
    return err, ms, plain_ms, library_ms, bnd


def critic_stem_row(device, b, seed):
    """K6 at the critic's (b, 1, 128³) on float32 probabilities in (0,
    1), as autocast hands them to it, against ``critic_stem_plain`` under
    bf16 autocast (the cast, cuDNN's convolution, ``F.leaky_relu``) and
    against the float64 result on the bf16-rounded inputs, item groups of
    8 at a time, at ``tests/test_torch_port_cuda.py``'s bounds: within one
    bf16 rounding (2^-8 relative) of the float64 result and two steps
    (2^-6) of the plain version, with room for the order of 64 float32
    terms.  Returns the max and mean abs error against the plain version,
    the kernel's call, the plain version's, the one library call of the
    function (``F.conv3d`` and ``F.leaky_relu`` on bf16 v and weight) and
    the bound: v read once in float32, the weight, the bf16 output."""
    import torch
    import torch.nn.functional as F
    from genre_shapehd_tpu_torch.ops.cuda import critic_stem_kernel as cst
    r, bf = 128, torch.bfloat16
    g = torch.Generator(device=device).manual_seed(seed)
    v = torch.rand((b, 1, r, r, r), generator=g, device=device)
    w = torch.randn((64, 1, 4, 4, 4), generator=g, device=device) * 0.1
    vb, wb = v.to(bf), w.to(bf)

    def plain():
        with torch.autocast("cuda", dtype=bf):
            return cst.critic_stem_plain(v, w)

    with torch.inference_mode():
        cst.reset_launches()
        out = cst.critic_stem(v, w)
        torch.cuda.synchronize()
        check(cst.launches == {"critic_stem": 1, "critic_stem_backward": 0,
                               "critic_stem_mask": 0}
              and out.dtype == bf
              and out.shape == (b, 64, r // 2, r // 2, r // 2)
              and out.is_contiguous(memory_format=torch.channels_last_3d),
              f"K6: launches {cst.launches}, {out.dtype} {out.shape}")
        ref = plain()
        d = (out.float() - ref.float()).abs()
        err = (float(d.max()), float(d.mean()))
        del d
        worst = [-1.0, -1.0]
        for i in range(0, b, 8):
            v64, w64 = vb[i:i + 8].double(), wb.double()
            exact = F.leaky_relu(F.conv3d(v64, w64, None, 2, 1), 0.2)
            slack = 64 * 2.0 ** -24 * F.conv3d(v64.abs(), w64.abs(), None,
                                               2, 1)
            got, pl = out[i:i + 8].double(), ref[i:i + 8].double()
            e = (got - exact).abs() - (2.0 ** -8 * exact.abs() + slack)
            worst[0] = max(worst[0], float(e.max()))
            e = (got - pl).abs() - (2.0 ** -6 * torch.maximum(
                got.abs(), pl.abs()) + 2 * slack)
            worst[1] = max(worst[1], float(e.max()))
            del exact, slack, got, pl, e
        check(worst[0] <= 0 and worst[1] <= 0,
              f"K6 at {(b, 1, r, r, r)}: beyond its bound by {worst[0]} vs "
              f"float64, {worst[1]} vs plain")
        del out, ref
    n_out = b * 64 * (r // 2) ** 3
    return dict(
        shape=[b, 1, r, r, r], max_abs_err=err[0], mean_abs_err=err[1],
        call=lambda: cst.critic_stem(v, w), plain=plain,
        library=lambda: F.leaky_relu(F.conv3d(vb, wb, None, 2, 1), 0.2),
        bound=bound(v.numel() * 4 + 64 * 64 * 4 + n_out * 2,
                    2.0 * 64 * n_out, H100_BF16_FLOPS))


def phase_critic_stem(device, flush):
    """K6 at the ShapeHD cell's (128, 1, 128³) (:func:`critic_stem_row`),
    timed beside its plain version, the library call and its bound, with
    no gradient recorded."""
    import torch
    row = critic_stem_row(device, 128, 17)
    with torch.inference_mode():
        ms = {key: time_ms(row.pop(fn), flush) for fn, key in (
            ("call", "ms"), ("plain", "plain_ms"), ("library", "library_ms"))}
    bnd = row.pop("bound")
    log(f"[kernels] K6 critic_stem {row['shape']} float32 -> bf16: "
        f"{ms['ms']:.4f} ms, bound {bnd[0] * 1e3:.1f} us ({bnd[1]}), "
        f"{100 * bnd[0] / ms['ms']:.1f} % of it; plain (autocast's cast, "
        f"cuDNN, F.leaky_relu) {ms['plain_ms']:.4f} ms; library (bf16 "
        f"F.conv3d, F.leaky_relu) {ms['library_ms']:.4f} ms; max/mean abs "
        f"err vs plain {row['max_abs_err']:.3g}/{row['mean_abs_err']:.3g}")
    return ((row["max_abs_err"], row["mean_abs_err"]), ms["ms"],
            ms["plain_ms"], ms["library_ms"], bnd)


def critic_stem_mask_row(device, b, s, seed):
    """K6's backward mask (``critic_stem_kernel._mask_launch``) at (b, 64,
    s³) on bf16 g and y channels-last, as K7's backward and K6 leave
    them, against ``mask_plain`` on the same tensors bit for bit: both
    keep g where y > 0 and round 0.2 g once to bf16 elsewhere (y holds
    exact zeros too).  Returns the kernel's call, the plain version's
    (``leaky_relu_backward`` on the channels-last tensors, then
    ``.contiguous()``), the library call (``leaky_relu_backward`` on
    channels-first g and y, which needs no layout pass) and the bound:
    g and y read and the channels-first result written, once each."""
    import torch
    from genre_shapehd_tpu_torch.ops.cuda import critic_stem_kernel as cst
    bf = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(seed)
    # drawn NDHWC, so that the permuted views are channels-last
    g, y = (torch.randn((b, s, s, s, 64), generator=gen, device=device)
            .to(bf).permute(0, 4, 1, 2, 3) for _ in range(2))
    y.masked_fill_(y.abs() < 0.05, 0.0)
    with torch.inference_mode():
        cst.reset_launches()
        out = cst._mask_launch(g, y)
        torch.cuda.synchronize()
        check(cst.launches == {"critic_stem": 0, "critic_stem_backward": 0,
                               "critic_stem_mask": 1}
              and out.dtype == bf and out.shape == (b, 64, s, s, s)
              and out.is_contiguous(),
              f"mask: launches {cst.launches}, {out.dtype} {out.shape}")
        ref = cst.mask_plain(g, y)
        check(torch.equal(out, ref), f"mask at {(b, 64, s, s, s)}: "
              f"{int((out != ref).sum())} elements differ from mask_plain")
        del out, ref
        gc, yc = g.contiguous(), y.contiguous()
    return dict(
        shape=[b, 64, s, s, s], max_abs_err=0.0, mean_abs_err=0.0,
        call=lambda: cst._mask_launch(g, y),
        plain=lambda: cst.mask_plain(g, y),
        library=lambda: torch.ops.aten.leaky_relu_backward(gc, yc, 0.2,
                                                           True),
        bound=bound(3 * g.numel() * 2, 0.0))


def phase_critic_stem_mask(device, flush):
    """K6's backward mask at the fine-tuning step's (64, 64, 64³)
    (:func:`critic_stem_mask_row`), timed beside its plain version, the
    library call and its bound."""
    import torch
    row = critic_stem_mask_row(device, 64, 64, 23)
    with torch.inference_mode():
        ms = {key: time_ms(row.pop(fn), flush) for fn, key in (
            ("call", "ms"), ("plain", "plain_ms"), ("library", "library_ms"))}
    bnd = row.pop("bound")
    log(f"[kernels] K6 backward mask {row['shape']} bf16 channels-last -> "
        f"channels-first: {ms['ms']:.4f} ms, bound {bnd[0] * 1e3:.1f} us "
        f"({bnd[1]}), {100 * bnd[0] / ms['ms']:.1f} % of it; plain "
        f"(leaky_relu_backward, .contiguous()) {ms['plain_ms']:.4f} ms; "
        f"library (leaky_relu_backward, channels-first) "
        f"{ms['library_ms']:.4f} ms; equal to the plain mask bit for bit")
    return ((row["max_abs_err"], row["mean_abs_err"]), ms["ms"],
            ms["plain_ms"], ms["library_ms"], bnd)


def critic_conv_row(device, b, cin, r, cout, seed):
    """K7 at (b, cin, r³) -> cout, channels-last bf16 input, against
    ``critic_conv_plain`` under bf16 autocast (cuDNN, NCDHW, then
    ``F.leaky_relu``) and against the float64 result on the bf16-rounded
    inputs, items 8 at a time, at ``tests/test_torch_port_critic_conv_cuda.py``'s
    bounds: within one bf16 rounding (2^-8 relative) of the float64 result
    and two steps (2^-6) of the plain version, with room for the order of
    64 Cin float32 terms.  Returns the max and mean abs error against the
    plain version, the kernel's call, the plain version's, the two library
    calls (``F.conv3d`` and ``F.leaky_relu`` on bf16 NCDHW, and on
    channels_last_3d input and weight) and the bound (operations at the
    bf16 peak; x, the weight and the output once)."""
    import torch
    import torch.nn.functional as F
    from genre_shapehd_tpu_torch.ops.cuda import critic_conv_kernel as ccv
    bf, cl = torch.bfloat16, torch.channels_last_3d
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand((b, cin, r, r, r), generator=g, device=device).to(bf)
    xcl = x.contiguous(memory_format=cl)
    w = torch.randn((cout, cin, 4, 4, 4), generator=g, device=device) * 0.05
    wb = w.to(bf)
    wcl = wb.contiguous(memory_format=cl)

    def plain():
        with torch.autocast("cuda", dtype=bf):
            return ccv.critic_conv_plain(x, w)

    o = r // 2
    with torch.inference_mode():
        ccv.reset_launches()
        out = ccv.critic_conv(xcl, w)
        torch.cuda.synchronize()
        check(ccv.launches == {"critic_conv": 1, "critic_conv_backward": 0}
              and out.dtype == bf and out.shape == (b, cout, o, o, o)
              and out.is_contiguous(memory_format=cl),
              f"K7: launches {ccv.launches}, {out.dtype} {out.shape}")
        ref = plain()
        d = (out.float() - ref.float()).abs()
        err = (float(d.max()), float(d.mean()))
        del d
        worst = [-1.0, -1.0]
        for i in range(0, b, 8):
            x64, w64 = x[i:i + 8].double(), wb.double()
            exact = F.leaky_relu(F.conv3d(x64, w64, None, 2, 1), 0.2)
            slack = 64 * cin * 2.0 ** -24 * F.conv3d(
                x64.abs(), w64.abs(), None, 2, 1)
            got, pl = out[i:i + 8].double(), ref[i:i + 8].double()
            e = (got - exact).abs() - (2.0 ** -8 * exact.abs() + slack)
            worst[0] = max(worst[0], float(e.max()))
            e = (got - pl).abs() - (2.0 ** -6 * torch.maximum(
                got.abs(), pl.abs()) + 2 * slack)
            worst[1] = max(worst[1], float(e.max()))
            del x64, exact, slack, got, pl, e
        check(worst[0] <= 0 and worst[1] <= 0,
              f"K7 at {(b, cin, r, cout)}: beyond its bound by {worst[0]} "
              f"vs float64, {worst[1]} vs plain")
        del out, ref
    n_out = b * cout * o ** 3
    return dict(
        shape=[b, cin, r, r, r], cout=cout, max_abs_err=err[0],
        mean_abs_err=err[1],
        call=lambda: ccv.critic_conv(xcl, w), plain=plain,
        library=lambda: F.leaky_relu(F.conv3d(x, wb, None, 2, 1), 0.2),
        library_cl=lambda: F.leaky_relu(F.conv3d(xcl, wcl, None, 2, 1), 0.2),
        bound=bound(x.numel() * 2 + wb.numel() * 2 + n_out * 2,
                    2.0 * 64 * cin * n_out, H100_BF16_FLOPS))


def phase_critic_conv(device, flush):
    """K7 at the ShapeHD cell's four shapes, batch 128
    (:func:`critic_conv_row`), each timed beside its plain version, the
    two library calls and its bound, with no gradient recorded.  Returns
    the kernels table's entry for one critic's four calls (errors the
    worst, times and bounds summed) and the rows."""
    import torch
    rows, total = [], dict(ms=0.0, plain_ms=0.0, library_ms=0.0,
                           library_cl_ms=0.0, bound=0.0, nbytes=0.0)
    errs = [0.0, 0.0]
    for cin, r, cout in CRITIC_CONV_SHAPES:
        row = critic_conv_row(device, 128, cin, r, cout, 19 + r)
        with torch.inference_mode():
            ms = {key: time_ms(row.pop(fn), flush) for fn, key in (
                ("call", "ms"), ("plain", "plain_ms"),
                ("library", "library_ms"), ("library_cl", "library_cl_ms"))}
        bnd = row.pop("bound")
        row.update(ms, bound_ms=bnd[0], bound_by=bnd[1],
                   bound_share=bnd[0] / ms["ms"])
        for k in ms:
            total[k] += ms[k]
        total["bound"] += bnd[0]
        total["nbytes"] += bnd[2]
        errs = [max(errs[0], row["max_abs_err"]),
                max(errs[1], row["mean_abs_err"])]
        log(f"[kernels] K7 critic_conv {row['shape']} -> {cout} bf16, "
            f"channels-last: {ms['ms']:.4f} ms, bound {bnd[0] * 1e3:.1f} us "
            f"({bnd[1]}), {100 * bnd[0] / ms['ms']:.1f} % of it; plain "
            f"(autocast, cuDNN NCDHW, F.leaky_relu) {ms['plain_ms']:.4f} ms; "
            f"library bf16 F.conv3d + F.leaky_relu NCDHW "
            f"{ms['library_ms']:.4f} ms, channels_last_3d "
            f"{ms['library_cl_ms']:.4f} ms; max/mean "
            f"abs err vs plain {row['max_abs_err']:.3g}/"
            f"{row['mean_abs_err']:.3g}")
        rows.append(row)
    log(f"[kernels] K7 critic_conv, one critic's four calls at batch 128: "
        f"{total['ms']:.4f} ms, bound {total['bound']:.4f} ms, "
        f"{100 * total['bound'] / total['ms']:.1f} % of it; plain "
        f"{total['plain_ms']:.4f}, library NCDHW {total['library_ms']:.4f}, "
        f"channels_last_3d {total['library_cl_ms']:.4f} ms")
    return (tuple(errs), total["ms"], total["plain_ms"], total["library_ms"],
            (total["bound"], "operations", total["nbytes"]), rows)


def _cdist_min(x1, x2):
    """One library call for the same function: all squared distances
    without the matmul form, then both minima with their indices."""
    import torch
    d = torch.cdist(x1, x2,
                    compute_mode="donot_use_mm_for_euclid_dist").square_()
    return d.min(dim=2), d.min(dim=1)


def phase_nn_min_dist(device, flush):
    """K4 against its plain version: 8 x 8192 points (timed), a ragged
    pair, and the eval protocol's 1 x 1024 (timed too)."""
    import torch
    from genre_shapehd_tpu_torch.ops.cuda import chamfer_kernel as ck
    g = torch.Generator(device=device).manual_seed(4)
    worst = (0.0, 0.0)
    clouds = {}
    for b, n, m in ((8, 8192, 8192), (2, 700, 1200), (1, 1024, 1024)):
        x1 = torch.randn((b, n, 3), generator=g, device=device)
        x2 = torch.randn((b, m, 3), generator=g, device=device)
        clouds[(b, n, m)] = (x1, x2)
        ck.reset_launches()
        d1, d2, i1, i2 = ck.nn_min_dist(x1, x2)
        torch.cuda.synchronize()
        check(ck.launches == {"nn_min_dist": 1}, f"K4 launches {ck.launches}")
        r1, r2, _, _ = ck.nn_min_dist_plain(x1, x2)
        # tests/test_pallas_chamfer.py's bounds: rtol 1e-4, atol 1e-5
        for got, ref in ((d1, r1), (d2, r2)):
            d = (got - ref).abs()
            check(bool((d <= 1e-5 + 1e-4 * ref.abs()).all()),
                  f"K4 vs plain at {(b, n, m)}: max err {float(d.max())}")
            worst = (max(worst[0], float(d.max())),
                     max(worst[1], float(d.mean())))
        # ties may pick another index: hold it to the distance it gives
        nn1 = torch.gather(x2, 1, i1.long()[..., None].expand(-1, -1, 3))
        nn2 = torch.gather(x1, 1, i2.long()[..., None].expand(-1, -1, 3))
        e1 = float((((x1 - nn1) ** 2).sum(-1) - d1).abs().max())
        e2 = float((((x2 - nn2) ** 2).sum(-1) - d2).abs().max())
        check(max(e1, e2) <= 1e-5, f"K4 indices at {(b, n, m)}: {e1} {e2}")
    # exact copies (every fifth point of y repeats an earlier one, half of
    # x are copies of y's points): equal distances bit for bit, so the
    # index is the first copy of the point it names
    b, n, m = 1, 1024, 1024
    x1 = torch.randn((b, n, 3), generator=g, device=device)
    x2 = torch.randn((b, m, 3), generator=g, device=device)
    x2[:, 1::5] = x2[:, torch.arange(0, m - 1, 5, device=device)]
    x1[:, ::2] = x2[:, torch.randint(0, m, (n // 2,), generator=g,
                                     device=device)]
    d1, d2, i1, i2 = ck.nn_min_dist(x1, x2)
    r1, r2, _, _ = ck.nn_min_dist_plain(x1, x2)
    for got, ref in ((d1, r1), (d2, r2)):
        check(bool(((got - ref).abs() <= 1e-5 + 1e-4 * ref.abs()).all()),
              "K4 vs plain on clouds with copies")
    check(int((d1 == 0).sum()) >= n // 2, "K4: copies not at distance 0")
    for pts, idx in ((x2, i1), (x1, i2)):
        # the lowest index holding each point
        _, inv = torch.unique(pts[0], dim=0, return_inverse=True)
        first = torch.full((pts.shape[1],), pts.shape[1], device=device,
                           dtype=torch.long).scatter_reduce_(
            0, inv, torch.arange(pts.shape[1], device=device), "amin")
        got = idx[0].long()
        check(bool((first[inv[got]] == got).all()),
              "K4: a tie did not go to the lowest index")
    # the scoring path's clouds fill 128 blocks (PR 2's kernel: 16)
    check(ck.plan(1, 1024, 1024) == {"group": 32, "blocks": 128},
          f"K4 plan at (1, 1024, 1024): {ck.plan(1, 1024, 1024)}")
    log(f"[kernels] K4 nn_min_dist f32 at {list(clouds)}: max/mean abs err "
        f"vs plain {worst[0]:.3g}/{worst[1]:.3g}; on (1, 1024, 1024) clouds "
        f"with copies every tie went to the lowest index; plans "
        f"{json.dumps({str(k): ck.plan(*k) for k in clouds})}")
    times = {}
    for shape in ((8, 8192, 8192), (1, 1024, 1024)):
        x1, x2 = clouds[shape]
        b, n, m = shape
        times[shape] = dict(
            ms=time_ms(lambda: ck.nn_min_dist(x1, x2), flush),
            plain_ms=time_ms(lambda: ck.nn_min_dist_plain(x1, x2), flush),
            library_ms=time_ms(lambda: _cdist_min(x1, x2), flush),
            # both directions: 8 float32 operations per pair each way;
            # bytes: both clouds in, distances and indices out
            bound=bound((n + m) * b * (12 + 8), 2 * 8.0 * b * n * m))
    return worst, times


def make_photos(d, n, seed):
    """Seeded photos of shaded solids (ellipsoids and boxes) on white,
    with masks whose object pixels are 255."""
    from genre_shapehd_tpu_torch.data.png import write_png
    rng = np.random.default_rng(seed)
    os.makedirs(d)
    for i in range(n):
        h, w = (int(x) for x in rng.integers(320, 480, 2))
        yy, xx = np.mgrid[:h, :w].astype(np.float64)
        cy, cx = rng.uniform(0.4, 0.6) * h, rng.uniform(0.4, 0.6) * w
        ry, rx = rng.uniform(0.15, 0.35) * h, rng.uniform(0.15, 0.35) * w
        u, v = (xx - cx) / rx, (yy - cy) / ry
        if i % 2:
            inside = (np.abs(u) < 1) & (np.abs(v) < 1)
            nz = np.where(inside, 0.8, 0.0)
        else:
            inside = u * u + v * v < 1
            nz = np.sqrt(np.clip(1 - u * u - v * v, 0, 1))
        light = rng.normal(size=3)
        light[2] = abs(light[2]) + 1.0
        light /= np.linalg.norm(light)
        shade = np.clip(-u * light[0] - v * light[1] + nz * light[2], 0, 1)
        color = rng.uniform(0.2, 0.9, 3)
        rgb = np.where(inside[..., None],
                       (0.15 + 0.85 * shade)[..., None] * color, 1.0)
        write_png(os.path.join(d, f"{i:02d}_rgb.png"),
                  (rgb * 255).round().astype(np.uint8))
        write_png(os.path.join(d, f"{i:02d}_silhouette.png"),
                  (inside * 255).astype(np.uint8))


def calibrate(net, rgb, sil):
    """Random weights throw net1's depth and net2's spherical map far
    outside the unit cube, leaving both backprojections empty: fix the
    min/max head to (1.2, 2.2) and scale the depth / spherical output
    layers to std 30 / 1 so the geometry sees the cube."""
    import torch
    d1 = net.depth_and_inpaint.net1
    with torch.no_grad():
        d1.MinmaxHead_0.Dense_2.weight.zero_()
        d1.MinmaxHead_0.Dense_2.bias.copy_(torch.tensor([1.2, 2.2]))
        for layer, key, target in (
                (d1.decoder_depth.Deconv_1.ConvTranspose_0, "depth", 30.0),
                (net.depth_and_inpaint.net2.decoder_spherical.Deconv_1
                 .ConvTranspose_0, "pred_sph_full", 1.0)):
            out = net(rgb, sil)[key].float()
            layer.weight.mul_(target / float(out.std()))


def scene_batch(b, size, device, seed):
    import torch
    g = torch.Generator().manual_seed(seed)
    rgb = torch.randn((b, size, size, 3), generator=g)
    yy, xx = torch.meshgrid(torch.arange(size), torch.arange(size),
                            indexing="ij")
    r2 = (yy - size / 2) ** 2 + (xx - size / 2) ** 2
    sil = (r2 < (0.3 * size) ** 2).float()[None, ..., None] * 100.0
    return rgb.to(device), sil.expand(b, -1, -1, -1).contiguous().to(device)


def phase_main_path(device, work):
    import torch
    from genre_shapehd_tpu_torch.cli import test as cli_test
    from genre_shapehd_tpu_torch.core.checkpoint import (net_payload,
                                                         save_checkpoint)
    from genre_shapehd_tpu_torch.core.convert import torch_to_jax
    from genre_shapehd_tpu_torch.models.genre_full import GenreNet
    from genre_shapehd_tpu_torch.nn import init_weights
    from genre_shapehd_tpu_torch.ops.cuda import render_kernel as rk
    from genre_shapehd_tpu_torch.ops.cuda import subpixel_kernel as sk

    photos = os.path.join(work, "photos")
    make_photos(photos, 16, seed=0)
    net = GenreNet(dtype=torch.bfloat16).eval()
    init_weights(net, torch.Generator().manual_seed(0))
    net.to(device)
    calibrate(net, *scene_batch(2, 256, device, 1))
    ckpt = os.path.join(work, "genre_full.pt")
    save_checkpoint(ckpt, net_payload(*torch_to_jax(net.state_dict())))
    # scripts/test_genre.sh's --suffix '{net}': the output goes to
    # <--output_dir>_genre_full_model
    out_dir = os.path.join(work, "out_genre_full_model")
    argv = ["--net", "genre_full_model", "--net_file", ckpt,
            "--input_rgb", os.path.join(photos, "*_rgb.png"),
            "--input_mask", os.path.join(photos, "*_silhouette.png"),
            "--output_dir", os.path.join(work, "out"), "--suffix", "{net}",
            "--overwrite", "--dtype", "bfloat16",
            "--batch_size", "8", "--workers", "4", "--vis_workers", "6",
            "--device", "cuda"]
    rk.reset_launches()
    sk.reset_launches()
    t0 = time.perf_counter()
    rc = cli_test.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {**rk.launches, **sk.launches}
    check(rc == 0, f"cli.test returned {rc}")
    check(not os.path.exists(os.path.join(work, "out")),
          "cli.test --suffix '{net}' wrote to the unsuffixed directory")
    npz = sorted(glob.glob(os.path.join(out_dir, "*.npz")))
    check(len(npz) == 2, f"expected 2 batch files, got {npz}")
    for path in npz:
        out = np.load(path)
        pv = out["pred_voxel"]
        check(pv.shape == (8, 128, 128, 128), f"{path}: {pv.shape}")
        check(bool(np.isfinite(pv).all()), f"{path}: non-finite voxels")
        hits = int((out["pred_proj_depth"] > 2e-4).sum())
        log(f"[main] {os.path.basename(path)}: pred_voxel {pv.shape} "
            f"finite, mean {pv.mean():.4f} std {pv.std():.4f}, camera-bp "
            f"voxels hit {hits}, sph-bp voxels hit "
            f"{int((out['pred_proj_sph_full'] != 0).sum())}")
    check(launches == {"render_stage1": 2, "render_stage2_scan": 2,
                       "render_stage2_samples": 0, "deconv_final": 2},
          f"launches in the main path {launches} != one per forward")
    tris = check_visualizer_output(out_dir, photos, n_batches=2, batch=8)
    log(f"[main] visualizer: 16 photo copies, 48 .obj meshes parsed; "
        f"triangles per mesh min {min(tris)} median "
        f"{int(statistics.median(tris))} max {max(tris)}")
    log(f"[main] cli.test: 16 photos, 2 forwards, {seconds:.1f} s wall "
        f"(load, preprocess, first-call setup, meshes included); launches "
        f"{launches}")

    # the users' default command: no --dtype (float32), under PyTorch's
    # default TF32 settings (cuDNN on, matmul off), not main()'s
    out32 = os.path.join(work, "out_f32_genre_full_model")
    i = argv.index("--dtype")
    argv32 = argv[:i] + argv[i + 2:]
    argv32[argv32.index("--output_dir") + 1] = os.path.join(work, "out_f32")
    rk.reset_launches()
    sk.reset_launches()
    was = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        rc = cli_test.main(argv32)
        torch.cuda.synchronize()
        seconds32 = time.perf_counter() - t0
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = was
    launches32 = {**rk.launches, **sk.launches}
    check(rc == 0, f"cli.test (float32) returned {rc}")
    check(launches32 == launches,
          f"float32 cli.test launches {launches32} != one per forward")
    for path in sorted(glob.glob(os.path.join(out32, "*.npz"))):
        pv = np.load(path)["pred_voxel"]
        check(pv.shape == (8, 128, 128, 128) and pv.dtype == np.float32
              and bool(np.isfinite(pv).all()),
              f"{path}: {pv.shape} {pv.dtype}")
    check(len(glob.glob(os.path.join(out32, "*.npz"))) == 2,
          "float32 cli.test: expected 2 batch files")
    log(f"[main] cli.test with no --dtype (float32; cuDNN TF32 on, matmul "
        f"off, PyTorch's defaults): 16 photos, 2 forwards, "
        f"{seconds32:.1f} s wall = {16 / seconds32:.2f} photos/s "
        f"(set-up and meshes included); launches {launches32}")
    return launches, ckpt, out_dir

def parse_obj(path):
    """Check a .obj the visualizer wrote: only ``v x y z`` and ``f a b c``
    lines, three unshared vertices per face, finite coordinates inside
    the shifted unit cube, 1-based indices in range.  Counts every line;
    converts the first and last 2000 of each kind.  Returns the number of
    faces."""
    with open(path, "rb") as f:
        data = f.read()
    check(data.endswith(b"\n"), f"{path}: no final newline")
    n_lines = data.count(b"\n")
    nv = data.count(b"\nv ") + data.startswith(b"v ")
    nf = data.count(b"\nf ") + data.startswith(b"f ")
    check(nf > 0 and nv == 3 * nf and nv + nf == n_lines,
          f"{path}: {nv} vertices, {nf} faces, {n_lines} lines")
    first_f = data.index(b"\nf ") + 1
    v_lines = data[:first_f].splitlines()
    f_lines = data[first_f:].splitlines()
    for lines, conv in ((v_lines, float), (f_lines, int)):
        sample = lines[:2000] + lines[-2000:]
        vals = np.array([[conv(t) for t in ln.split()[1:]] for ln in sample])
        check(vals.shape == (len(sample), 3), f"{path}: malformed line")
        if conv is float:
            check(bool(np.isfinite(vals).all())
                  and float(np.abs(vals).max()) <= 0.5 + 1e-6,
                  f"{path}: vertex outside the cube")
        else:
            check(int(vals.min()) >= 1 and int(vals.max()) <= nv,
                  f"{path}: face index out of range")
    return nf


def check_visualizer_output(out_dir, photos, n_batches, batch):
    """Every batch directory holds, per item, the copied photo and the
    three meshes under the JAX package's names; returns triangles per
    mesh."""
    tris = []
    for bi in range(n_batches):
        d = os.path.join(out_dir, f"batch{bi:04d}")
        want = []
        for i in range(bi * batch, (bi + 1) * batch):
            want += [f"{i:04d}_00_rgb.png", f"{i:04d}_08_pred_proj_depth.obj",
                     f"{i:04d}_10_pred_proj_sph_full.obj",
                     f"{i:04d}_12_pred_voxel.obj"]
        check(sorted(os.listdir(d)) == sorted(want),
              f"{d}: {sorted(os.listdir(d))}")
        for name in want:
            path = os.path.join(d, name)
            if name.endswith(".obj"):
                tris.append(parse_obj(path))
            else:
                i = int(name[:4])
                with open(path, "rb") as a, open(os.path.join(
                        photos, f"{i:02d}_rgb.png"), "rb") as b:
                    check(a.read() == b.read(), f"{path}: not the photo")
    return tris


def make_solid(i, res, seed):
    """Seeded ground-truth occupancy in {0, 1}: an ellipsoid (even items)
    or a box (odd items), as the photos show."""
    rng = np.random.default_rng([seed, i])
    c = ((np.arange(res) + 0.5) / res - 0.5).astype(np.float32)
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    r = rng.uniform(0.15, 0.35, 3)
    if i % 2:
        inside = (np.abs(x) < r[0]) & (np.abs(y) < r[1]) & (np.abs(z) < r[2])
    else:
        inside = (x / r[0]) ** 2 + (y / r[1]) ** 2 + (z / r[2]) ** 2 < 1
    return inside.astype(np.float32)


def run_eval(argv):
    """``cli.eval_chamfer.main(argv)``'s JSON from its standard output."""
    from genre_shapehd_tpu_torch.cli import eval_chamfer
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = eval_chamfer.main(argv)
    check(rc == 0, f"cli.eval_chamfer returned {rc}")
    lines = buf.getvalue().strip().splitlines()
    check(len(lines) == 1, f"cli.eval_chamfer printed {lines}")
    return json.loads(lines[0])


def phase_score(device, work, out_dir):
    """Score the reconstructions: per-item prediction files split from
    cli.test's batches, seeded ground truths beside them under the same
    names, then cli.eval_chamfer on the card and on the CPU."""
    import torch
    from genre_shapehd_tpu_torch.cli.eval_chamfer import chamfer_between_voxels
    from genre_shapehd_tpu_torch.ops.cuda import chamfer_kernel as ck
    pred_dir, gt_dir = (os.path.join(work, d) for d in ("pred", "gt"))
    os.makedirs(pred_dir)
    os.makedirs(gt_dir)
    n = 0
    for path in sorted(glob.glob(os.path.join(out_dir, "*.npz"))):
        for vox in np.load(path)["pred_voxel"]:
            np.savez(os.path.join(pred_dir, f"item{n:02d}.npz"),
                     pred_voxel=vox)
            np.savez(os.path.join(gt_dir, f"item{n:02d}.npz"),
                     voxel=make_solid(n, vox.shape[0], seed=5))
            n += 1
    argv = ["--pred_dir", pred_dir, "--gt_dir", gt_dir]
    ck.reset_launches()
    t0 = time.perf_counter()
    on_card = run_eval(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(ck.launches)
    check(on_card["n_items"] == n == 16, f"n_items {on_card['n_items']}")
    check(launches == {"nn_min_dist": n},
          f"K4 launches {launches} != items scored {n}")
    scores = list(on_card["per_item"].values())
    check(len(scores) == n and bool(np.isfinite(scores).all())
          and np.isfinite(on_card["mean_chamfer_distance"])
          and 0.0 < on_card["mean_chamfer_distance"] < 2.0,
          f"scores {on_card}")
    on_cpu = run_eval(argv + ["--device", "cpu"])
    check(ck.launches == launches, "the CPU run launched K4")
    worst = max(abs(on_card["per_item"][k] - on_cpu["per_item"][k])
                for k in on_cpu["per_item"])
    check(list(on_cpu["per_item"]) == list(on_card["per_item"])
          and worst <= 1e-5
          and abs(on_card["mean_chamfer_distance"]
                  - on_cpu["mean_chamfer_distance"]) <= 1e-5,
          f"card vs CPU scores differ by {worst}")
    # a ground truth against itself, sampled with other random numbers
    # (the two clouds of one call never share samples): 1024 points on a
    # surface of area ~1 lie ~0.015 apart, each way
    gt = make_solid(0, 128, seed=5)
    self_cd = chamfer_between_voxels(gt, gt, th=0.5, use_sigmoid=False,
                                     seed=1, device=device)
    check(0.0 < self_cd < 0.06, f"self Chamfer distance {self_cd}")
    log(f"[score] cli.eval_chamfer: {n} items, mean Chamfer distance "
        f"{on_card['mean_chamfer_distance']:.5f} (random weights), min "
        f"{min(scores):.5f} max {max(scores):.5f}, {seconds:.1f} s wall on "
        f"the card; card vs CPU max difference {worst:.3g}; ground truth "
        f"vs itself {self_cd:.5f}; launches {launches}")
    return launches


def phase_reference(device):
    """CUDA forward (kernels, cuDNN, TF32 off) vs the CPU forward (plain
    versions) at the tests' reduced scale, float32."""
    import torch
    from genre_shapehd_tpu_torch.models.genre_full import GenreNet
    from genre_shapehd_tpu_torch.nn import init_weights
    cfg = dict(im_size=64, vox_res=32, sph_res=32, z_res=32,
               padding_margin=16)
    net = GenreNet(**cfg).eval()
    init_weights(net, torch.Generator().manual_seed(1))
    rgb, sil = scene_batch(2, 64, "cpu", 2)
    with torch.no_grad():
        calibrate(net, rgb, sil)
        ref = net(rgb, sil)
        gpu = net.to(device)(rgb.to(device), sil.to(device))
    worst = {}
    for k in ("proj_depth", "pred_sph_partial", "pred_sph_full",
              "pred_proj_sph_full", "pred_voxel"):
        g, r = gpu[k].float().cpu(), ref[k].float()
        d = (g - r).abs()
        scale = max(float(r.abs().max()), 1.0)
        # a point can cross a voxel face under floor(): most voxels, not
        # all, agree to 1e-3 of the output's scale
        frac = float((d <= 1e-3 * scale).float().mean())
        worst[k] = (frac, float(d.max()))
        check(bool(torch.isfinite(g).all()) and frac >= 0.999
              and float(d.mean()) <= 1e-3 * scale, f"{k}: {worst[k]}")
    check(int((ref["proj_depth"] > ref["proj_depth"].min()).sum()) > 500,
          "the small reference input leaves the cube empty")
    log("[reference] CUDA vs CPU forward, f32 (fraction within 1e-3, max "
        "err):", json.dumps(worst))


def _device_us(evt, self_only=False):
    return evt.self_device_time_total if self_only else evt.device_time_total


def device_profile(prof, n, wall_ms, own_names, prefixes=("genre.",)):
    """From a profile of ``n`` runs: device ms per span (``prefixes``)
    (kernels launched under its CPU side, and its length on the device's
    timeline), kernel time per run, the hand-written kernels by name and
    the top kernels; logs them with the idle share against
    ``wall_ms``."""
    from torch.autograd import DeviceType
    events = prof.key_averages()
    # kernels: device events that are not user annotations (the spans)
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = sum(_device_us(e, True) for e in kernels) / n / 1e3
    # per stage: kernel time launched under the CPU-side span, and the
    # length of the span on the device's timeline (kernels + gaps)
    stages = {}
    for e in events:
        if e.key.startswith(prefixes):
            on_device = e.device_type == DeviceType.CUDA
            val = _device_us(e, on_device) / n / 1e3
            stages.setdefault(e.key, {})[
                "span" if on_device else "kernels"] = round(val, 3)
    log(f"[profile] per run, ms by stage: {json.dumps(stages)}")
    log(f"[profile] kernel time {busy:.2f} ms per run (profiled) vs "
        f"{wall_ms:.2f} ms unprofiled wall: device idle share "
        f"{max(0.0, 1 - busy / wall_ms):.3f}")
    own = {e.key.split("<")[0].split("::")[-1]:
           round(_device_us(e, True) / n / 1e3, 4) for e in kernels
           if any(k in e.key for k in own_names)}
    log(f"[profile] hand-written kernels per run, ms (launched through "
        f"ctypes, so no span's kernel column holds them): "
        f"{json.dumps(own)}")
    # the backward runs on autograd's device thread, outside the spans:
    # its kernels by the backward function that launched them
    backward = {e.key.split(": ")[-1]: _device_us(e) / n / 1e3
                for e in events if e.device_type == DeviceType.CPU
                and e.key.startswith("autograd::engine::evaluate_function")}
    if backward:
        total = sum(backward.values())
        top = sorted(backward.items(), key=lambda kv: -kv[1])[:10]
        log(f"[profile] backward kernels {total:.2f} ms per run (without "
            f"the ctypes kernels), by function: "
            f"{json.dumps({k: round(v, 3) for k, v in top})}")
    top = sorted(kernels, key=lambda e: -_device_us(e, True))[:12]
    for e in top:
        log(f"[profile] {_device_us(e, True) / n / 1e3:8.3f} ms "
            f"x{e.count // n:<4d} {e.key[:110]}")
    return stages, busy, own


OWN_KERNELS = ("stage1_kernel", "slab_scan_kernel", "slab_samples_kernel",
               "deconv_final_", "critic_stem_kernel")


def phase_throughput(device, ckpt):
    import torch
    from torch.profiler import ProfilerActivity, profile
    from genre_shapehd_tpu_torch.core.checkpoint import load_net
    from genre_shapehd_tpu_torch.core.convert import jax_to_torch
    from genre_shapehd_tpu_torch.models.genre_full import GenreNet
    from genre_shapehd_tpu_torch.ops.cuda import subpixel_kernel as sk
    net = GenreNet(dtype=torch.bfloat16).eval()
    net.load_state_dict(jax_to_torch(*load_net(ckpt)))
    net.to(device)
    rgb, sil = scene_batch(8, 256, device, 3)
    torch.cuda.reset_peak_memory_stats()

    def fwd():
        with torch.inference_mode():
            net(rgb, sil)

    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=device)
    # measurement only: dec6 through the library call (the layer as it
    # was before K3) and through K3, in turns within this one run
    dec6 = [m for m in net.refine_net.modules()
            if getattr(m, "final", False)]
    check(len(dec6) == 1, f"{len(dec6)} layers routed to K3")
    turns = []
    for use_kernel in (False, True, True, False):
        dec6[0].final = use_kernel
        turns.append(time_ms(fwd, flush, reps=10, warmup=3))
    dec6[0].final = True
    log(f"[throughput] forward with dec6 on the library call "
        f"{turns[0]:.2f} / {turns[3]:.2f} ms, on K3 {turns[1]:.2f} / "
        f"{turns[2]:.2f} ms (library, K3, K3, library; median of 10 each)")
    ms = min(turns[1:3])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[throughput] GenreNet forward, batch 8, bf16, 256^2 -> 128^3: "
        f"{ms:.2f} ms (better of the two K3 turns) -> {8e3 / ms:.1f} "
        f"recon/s; peak memory {peak:.2f} GiB")
    # the default command's type: the same weights in float32, dec6 on
    # K3's CUDA-core kernel, under main()'s TF32 off and under PyTorch's
    # defaults (cuDNN TF32 on, matmul off)
    net32 = GenreNet().eval()
    net32.load_state_dict(jax_to_torch(*load_net(ckpt)))
    net32.to(device)

    def fwd32():
        with torch.inference_mode():
            net32(rgb, sil)

    sk.reset_launches()
    fwd32()
    check(sk.launches == {"deconv_final": 1},
          f"float32 forward: K3 launches {sk.launches}")
    ms32 = {}
    was = torch.backends.cudnn.allow_tf32
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        ms32[tf32] = time_ms(fwd32, flush, reps=10, warmup=3)
    torch.backends.cudnn.allow_tf32 = was
    log(f"[throughput] GenreNet forward, batch 8, float32, 256^2 -> 128^3: "
        f"{ms32[False]:.2f} ms -> {8e3 / ms32[False]:.1f} recon/s with TF32 "
        f"off; {ms32[True]:.2f} ms -> {8e3 / ms32[True]:.1f} recon/s with "
        f"cuDNN TF32 on (PyTorch's default); median of 10; one K3 launch a "
        f"forward")
    del net32
    # after the timed turns, before the profiled passes: the first session
    kernel_counts(device)

    n = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fwd()
        torch.cuda.synchronize()
    device_profile(prof, n, ms, OWN_KERNELS)
    return ms, ms32


def phase_stage2_samples(device, flush):
    """K5 against its plain version at the forward's batch-8 and the
    training's batch-4 bf16 shapes, and in float32 at a smaller size;
    timed at batch 4, the shape the training path gives it."""
    import torch
    from genre_shapehd_tpu_torch.ops.cuda import render_kernel as rk
    v, r, z, m = (MAIN[k] for k in "vrzm")
    bf = torch.bfloat16
    worst = (0.0, 0.0)
    for b in (MAIN["b"], TRAIN["batch"]):
        c = rk.stage1(volume(b, v, 5 + b, device), v, r, z, m, bf)
        rk.reset_launches()
        out = rk.stage2_samples(c, v, r, z, m, bf)
        torch.cuda.synchronize()
        check(rk.launches["render_stage2_samples"] == 1,
              f"K5 launches {rk.launches}")
        check(out.shape == (b, r, r, z) and out.dtype == torch.float32,
              f"K5 output {tuple(out.shape)} {out.dtype}")
        d = (out - rk.stage2_samples_plain(c, v, r, z, m, bf)).abs()
        err = (float(d.max()), float(d.mean()))
        # K2's bounds (tests/test_pallas_render.py): the plain version
        # rounds t2 = sum_z c*wz to bf16, the kernel does not
        check(err[0] < 3e-2 and err[1] < 2e-3, f"K5 vs plain at batch {b}: "
              f"{err}")
        worst = (max(worst[0], err[0]), max(worst[1], err[1]))
        del out, d
    # the library call at batch 4 on c in float32 (a bfloat16 grid would
    # misplace the taps), against K5: K2's bounds (K5 rounds its weights)
    b = TRAIN["batch"]
    c_f32 = c.float()
    g2 = library_grids(b, v, r, z, m, device)[1]
    d = (library_stage2_samples(c_f32, g2).permute(0, 2, 1, 3)
         - rk.stage2_samples(c, v, r, z, m, bf)).abs()
    lib_err = (float(d.max()), float(d.mean()))
    check(lib_err[0] < 3e-2 and lib_err[1] < 2e-3,
          f"grid_sample vs K5 {lib_err}")
    del d
    # float32 at a smaller size: summation order only
    a = (64, 64, 128, 96, torch.float32)
    c32 = rk.stage1(volume(2, 64, 6, device), *a)
    k32 = rk.stage2_samples(c32, *a)
    e32 = float((k32 - rk.stage2_samples_plain(c32, *a)).abs().max())
    l32 = float((library_stage2_samples(
        c32, library_grids(2, *a[:4], device)[1]).permute(0, 2, 1, 3)
        - k32).abs().max())
    # grid_sample's float32 grid coordinates: 1e-4, as for K1
    check(e32 < 1e-5 and l32 < 1e-4, f"f32 K5 {e32}, grid_sample {l32}")
    log(f"[kernels] K5 render_stage2_samples bf16 at batch {MAIN['b']} and "
        f"{TRAIN['batch']}: max/mean abs err vs plain {worst[0]:.3g}/"
        f"{worst[1]:.3g}, vs grid_sample (f32) {lib_err[0]:.3g}/"
        f"{lib_err[1]:.3g}; f32 (2, 64^3 -> 64^2 x 128) max err {e32:.3g}, "
        f"grid_sample {l32:.3g}")
    ms = time_ms(lambda: rk.stage2_samples(c, v, r, z, m, bf), flush)
    plain_ms = time_ms(lambda: rk.stage2_samples_plain(c, v, r, z, m, bf),
                       flush)
    library_ms = time_ms(lambda: library_stage2_samples(c_f32, g2), flush)
    # bytes: c read once, the float32 samples written once, the tap
    # records; per sample 4 multiply-adds of the taps
    bnd = bound(c.numel() * 2 + b * r * r * z * 4
                + record_bytes(v, r, z, m, bf), 8.0 * b * r * r * z)
    log_plan(f"K5 render_stage2_samples (batch {b})", v, m, bf, ms, bnd)
    return worst, ms, plain_ms, library_ms, bnd


def phase_float32(device, flush):
    """The default command's type (``--dtype float32``): K1 (batch 8,
    float32 c), K2 (batch 8), K5 (batch 4) and K3 (dec6's shape) in
    float32 at the main path's shapes against their plain versions (1e-5,
    K3 1e-5 of the output's scale; TF32 off) and timed (25 runs) beside
    their bounds and library calls: ``F.grid_sample`` in float32 for K1
    and K5, ``F.conv_transpose3d`` with TF32 off for K3, none for K2."""
    import torch
    import torch.nn.functional as F
    from genre_shapehd_tpu_torch.ops.cuda import render_kernel as rk
    from genre_shapehd_tpu_torch.ops.cuda import subpixel_kernel as sk
    b, v, r, z, m = (MAIN[k] for k in "bvrzm")
    f32, b5 = torch.float32, TRAIN["batch"]
    vox = volume(b, v, 0, device)
    c = rk.stage1(vox, v, r, z, m, f32)
    c5 = c[:b5].contiguous()
    errs = {
        "render_stage1": (c - rk.stage1_plain(vox, v, r, z, m, f32)),
        "render_stage2_scan": (rk.stage2(c, v, r, z, m, f32)
                               - rk.stage2_plain(c, v, r, z, m, f32)),
        "render_stage2_samples": (rk.stage2_samples(c5, v, r, z, m, f32)
                                  - rk.stage2_samples_plain(c5, v, r, z, m,
                                                            f32)),
    }
    errs = {k: float(d.abs().max()) for k, d in errs.items()}
    check(max(errs.values()) < 1e-5, f"float32 K1, K2, K5 vs plain {errs}")
    bk, cin, s = (DEC6[k] for k in ("b", "cin", "s"))
    g = torch.Generator(device=device).manual_seed(14)
    x = torch.randn((bk, cin, s, s, s), generator=g, device=device)
    w = torch.randn((cin, 1, 4, 4, 4), generator=g, device=device) * 0.05
    bias = torch.full((1,), 0.1, device=device)
    sk.reset_launches()
    out = sk.deconv_final(x, w, bias)
    torch.cuda.synchronize()
    check(sk.launches == {"deconv_final": 1} and out.dtype == f32,
          f"float32 K3 launches {sk.launches}, {out.dtype}")
    ref = sk.deconv_final_plain(x, w, bias)
    scale = float(ref.abs().max())
    errs["deconv_final"] = float((out - ref).abs().max())
    # summation order only: 1e-5 of the output's scale
    check(errs["deconv_final"] <= 1e-5 * scale,
          f"float32 K3 vs plain {errs['deconv_final']} at scale {scale}")
    del out, ref
    g1, g2 = library_grids(b, v, r, z, m, device)
    g2 = g2[:b5].contiguous()
    tap_bytes_1 = r * m * (4 + 8) * 2
    n_out = bk * (2 * s) ** 3
    rows = {
        "render_stage1": dict(
            shape=[b, v, r, z, m], call=lambda: rk.stage1(vox, v, r, z, m,
                                                          f32),
            library=lambda: library_stage1(vox, g1),
            bound=bound(vox.numel() * 4 + c.numel() * 4 + tap_bytes_1,
                        12.0 * b * r * m * v)),
        "render_stage2_scan": dict(
            shape=[b, v, r, z, m], call=lambda: rk.stage2(c, v, r, z, m,
                                                          f32),
            library=None,
            bound=bound(c.numel() * 4 + record_bytes(v, r, z, m, f32)
                        + b * r * r * 4, 13.0 * b * r * r * z)),
        "render_stage2_samples": dict(
            shape=[b5, v, r, z, m],
            call=lambda: rk.stage2_samples(c5, v, r, z, m, f32),
            library=lambda: library_stage2_samples(c5, g2),
            bound=bound(c5.numel() * 4 + b5 * r * r * z * 4
                        + record_bytes(v, r, z, m, f32),
                        8.0 * b5 * r * r * z)),
        "deconv_final": dict(
            shape=[bk, cin, s], call=lambda: sk.deconv_final(x, w, bias),
            library=lambda: F.conv_transpose3d(x, w, bias, stride=2,
                                               padding=1),
            bound=bound(x.numel() * 4 + cin * 64 * 4 + 4 + n_out * 4,
                        2.0 * 8 * cin * n_out)),
    }
    out = {}
    for name, row in rows.items():
        ms = time_ms(row["call"], flush)
        lib = time_ms(row["library"], flush) if row["library"] else None
        bms, by, nbytes = row["bound"]
        out[name] = dict(shape=row["shape"], ms=ms, bound_ms=bms,
                         bound_by=by, bound_share=bms / ms,
                         achieved_gb_per_s=nbytes / ms / 1e6,
                         library_ms=lib, max_abs_err=errs[name],
                         tf32="off (cuDNN and matmul)")
        log(f"[kernels] float32 {name} at {row['shape']}: {ms:.4f} ms, "
            f"bound {bms * 1e3:.1f} us ({by}), {100 * bms / ms:.1f} % of the "
            f"bound; library {lib}; max abs err vs plain "
            f"{errs[name]:.3g}; TF32 off")
    return out


def _sig(v):
    """``v``, or each value of the list ``v``, to 3 significant digits."""
    if isinstance(v, list):
        return [_sig(u) for u in v]
    return float(f"{v:.3g}")


def phase_edge_shapes(device):
    """K1, K2, K3 and K5 off the main path's shapes against their plain
    versions, at the bounds above, with a synchronize after each call so
    that a fault shows where it happened: K1 at V = 34 (no multiple of the
    vector width: the scalar path) and batch 1, from float32 and bfloat16
    volumes, in both compute dtypes; K3 at (B, Cin, S) = (1, 7, 9),
    (2, 40, 33), (1, 3, 5), (1, 3, 66), (1, 5, 72), (1, 300, 16) in
    bfloat16 and float32, and (1, 1, 1) in float32, at two seeds (the
    shapes the tensor-core tiling refuses: S not a multiple of 8, S > 64,
    Cin > 288; float32 and those run the CUDA-core kernel, staged by TMA
    or by plain loads; bf16 by :func:`k3_bf16_within`); K2 and K5 at V = 34 and 33, M = 50, R = 32 and 30, z = 98,
    batch 1 and 3, in the plan's groups of 4 slabs; the wrapper's
    ValueError for a slab larger than shared memory."""
    import torch
    import torch.nn.functional as F
    from genre_shapehd_tpu_torch.ops.cuda import render_kernel as rk
    from genre_shapehd_tpu_torch.ops.cuda import subpixel_kernel as sk
    f32, bf = torch.float32, torch.bfloat16
    worst = {}
    for vdt in (f32, bf):
        for cd in (f32, bf):
            vox = volume(1, 34, 11, device).to(vdt)
            args = (34, 32, 64, 48, cd)
            c = rk.stage1(vox, *args)
            torch.cuda.synchronize()
            d = (c.float() - rk.stage1_plain(vox, *args).float()).abs()
            err = (float(d.max()), float(d.mean()))
            ok = err[0] < 1e-5 if cd == f32 else (err[0] < 1.6e-2
                                                   and err[1] < 1e-3)
            check(ok, f"K1 at V=34, {vdt} volume, {cd}: {err}")
            worst[f"K1 V=34 {str(vdt)[6:]} -> {str(cd)[6:]}"] = err[0]
    # (1, 1, 1) in float32 only: its 8 outputs make a mean bound of a
    # bf16 rounding meaningless; two seeds
    for seed in (12, 13):
        g = torch.Generator(device=device).manual_seed(seed)
        for b, cin, s, dts in ((1, 7, 9, (bf, f32)), (2, 40, 33, (bf, f32)),
                               (1, 3, 5, (bf, f32)), (1, 1, 1, (f32,)),
                               (1, 3, 66, (bf, f32)), (1, 5, 72, (bf, f32)),
                               (1, 300, 16, (bf, f32))):
            for dt in dts:
                x = torch.randn((b, cin, s, s, s), generator=g,
                                device=device).to(dt)
                w = torch.randn((cin, 1, 4, 4, 4), generator=g,
                                device=device) * 0.2
                bias = torch.full((1,), 0.3, device=device)
                out = sk.deconv_final(x, w, bias)
                torch.cuda.synchronize()
                check(out.shape == (b, 1, 2 * s, 2 * s, 2 * s)
                      and out.dtype == dt, f"K3 output {tuple(out.shape)}")
                ref = sk.deconv_final_plain(x, w, bias).float()
                scale = float(ref.abs().max())
                d = (out.float() - ref).abs()
                key = f"K3 {(b, cin, s)} {str(dt)[6:]} seed {seed}"
                if dt == f32:
                    check(float(d.max()) <= 1e-5 * scale,
                          f"f32 K3 at {(b, cin, s)}: {float(d.max())}")
                    worst[key] = float(d.max()) / scale
                    continue
                exact = F.conv_transpose3d(x.float(), w.to(bf).float(),
                                           bias, stride=2, padding=1)
                e = float((out.float() - exact).abs().max())
                e_plain = float((ref - exact).abs().max())
                u = 2.0 ** -8 * float(exact.abs().max())
                ok, waived = k3_bf16_within(float(d.max()), float(d.mean()),
                                            e, e_plain, scale,
                                            float(exact.abs().max()))
                check(ok, f"K3 at {(b, cin, s)}, seed {seed}: "
                          f"{float(d.max())} {float(d.mean())} vs plain, {e} "
                          f"vs float32, the plain version {e_plain} vs "
                          f"float32, scale {scale}")
                if waived:
                    log(f"[kernels] K3 bf16 at {(b, cin, s)}, seed {seed}: "
                        f"the plain version lies {e_plain / u:.2f} u "
                        f"(2^-8 of the largest magnitude) from the float32 "
                        f"result, beyond the 1.5 u its 1e-2 bound presumes; "
                        f"the kernel, {e / u:.2f} u from it, is held to 1 u "
                        f"alone")
                worst[key] = float(d.max()) / scale
                # kernel and plain version from the float32 result, in u
                worst[f"{key}: kernel, plain vs float32 (u)"] = [
                    e / u, e_plain / u]
    # K2 and K5: S = 98 (no multiple of 32 or 4), a bf16 slab of 3,400
    # bytes (no multiple of 16), V = 33 bf16 (rows not 4-byte aligned:
    # plain-load staging), batch 1 and 3, the plan's 4 slabs a group:
    # R = 32 fills the groups, R = 30 leaves a ragged last group and, at
    # batch 3, a group across a batch boundary
    z, m = 98, 50
    for r in (32, 30):
        for v, cd, b in ((34, bf, 1), (34, bf, 3), (34, f32, 1),
                         (34, f32, 3), (33, bf, 3)):
            check(rk.plan(v, m, cd)["group"] == 4,
                  f"plan at V={v}, {cd}: {rk.plan(v, m, cd)}")
            c = rk.stage1(volume(b, v, 13, device), v, r, z, m, cd)
            for name, fn, plain in (
                    ("K2", rk.stage2, rk.stage2_plain),
                    ("K5", rk.stage2_samples, rk.stage2_samples_plain)):
                out = fn(c, v, r, z, m, cd)
                torch.cuda.synchronize()
                d = (out - plain(c, v, r, z, m, cd)).abs()
                err = (float(d.max()), float(d.mean()))
                ok = err[0] < 1e-5 if cd == f32 else (err[0] < 3e-2 and
                                                      err[1] < 2e-3)
                check(ok, f"{name} at V={v}, R={r}, batch {b}, {cd}: {err}")
                key = f"{name} V={v} b={b} {str(cd)[6:]}"
                worst[key] = max(worst.get(key, 0.0), err[0])
    # a slab larger than shared memory: the wrapper raises, nothing runs
    rk.reset_launches()
    big = torch.zeros((1, 8, 384, 256), device=device)
    for fn in (rk.stage2, rk.stage2_samples):
        try:
            fn(big, 256, 8, 64, 384, f32)
        except ValueError:
            continue
        raise AssertionError(f"{fn.__name__} took a 395 KB slab")
    check(set(rk.launches.values()) == {0}, f"launched: {rk.launches}")
    # K3 on boxes and Z slabs (the sharded U-Net's dec6): positions from 0
    # or 1, Z not a multiple of 8 (plain-load staging), Z > 64 (two k
    # tiles), Cin > 288
    g = torch.Generator(device=device).manual_seed(15)
    for shape, z_lo, z_out in (((2, 40, 8, 16, 40), 1, 32),
                               ((1, 7, 9, 5, 12), 1, 10),
                               ((1, 5, 6, 10, 34), 1, 32),
                               ((1, 3, 5, 7, 72), 1, 70),
                               ((1, 3, 4, 4, 16), 0, 5),
                               ((1, 300, 8, 8, 24), 1, 22)):
        for dt in (bf, f32):
            x = torch.randn(shape, generator=g, device=device).to(dt)
            w = torch.randn((shape[1], 1, 4, 4, 4), generator=g,
                            device=device) * 0.2
            err, us, _ = k3_check(x, w, torch.full((1,), 0.3, device=device),
                                  z_lo, z_out)
            key = f"K3 {shape} z{z_lo}+{z_out} {str(dt)[6:]}"
            worst[key] = err[0]
            if us:
                worst[f"{key}: kernel, plain vs float32 (u)"] = us
    log(f"[kernels] edge shapes, max abs err (K3: of the scale) vs plain: "
        f"{json.dumps({k: _sig(v) for k, v in worst.items()})}; "
        f"a (384, 256) float32 slab raises ValueError")


def kernel_counts(device):
    """The timed K1, K2, K3 (bf16 and float32), K4 and K5 calls at the main
    path's shapes launch one kernel each, K3 the one its type selects: no
    cast of the volume, the input or the weight, no copy of c or of the
    tap records."""
    import torch
    from genre_shapehd_tpu_torch.ops.cuda import chamfer_kernel as ck
    from genre_shapehd_tpu_torch.ops.cuda import render_kernel as rk
    from genre_shapehd_tpu_torch.ops.cuda import subpixel_kernel as sk
    b, v, r, z, m = (MAIN[k] for k in "bvrzm")
    bf = torch.bfloat16
    vox = volume(b, v, 0, device)
    c = rk.stage1(vox, v, r, z, m, bf)
    c4 = c[:TRAIN["batch"]].contiguous()
    b, cin, s = (DEC6[k] for k in ("b", "cin", "s"))
    x = torch.zeros((b, cin, s, s, s), dtype=bf, device=device)
    w = torch.zeros((cin, 1, 4, 4, 4), device=device)
    bias = torch.zeros(1, device=device)
    x32 = torch.zeros((b, cin, s, s, s), device=device)
    p1 = torch.zeros((8, 8192, 3), device=device)
    calls = (lambda: rk.stage1(vox, v, r, z, m, bf),
             lambda: rk.stage2(c, v, r, z, m, bf),
             lambda: sk.deconv_final(x, w, bias),
             lambda: rk.stage2_samples(c4, v, r, z, m, bf),
             lambda: sk.deconv_final(x32, w, bias),
             lambda: ck.nn_min_dist(p1, p1))
    for fn in calls:                         # tables and attributes set up
        fn()
    names = kernels_launched(*calls)
    kinds = ("stage1_kernel", "slab_scan_kernel", "deconv_final_mma_kernel",
             "slab_samples_kernel", "deconv_final_fma_kernel",
             "nn_min_dist_kernel")
    own = {k: sum(n for name, n in names.items() if k in name)
           for k in kinds}
    check(own == dict.fromkeys(kinds, 1) and sum(names.values()) == 6,
          f"kernels of one K1, K2, K3 (bf16, float32), K4 and K5 call: "
          f"{names}")
    log(f"[kernels] device kernels of one timed K1 call (float32 volume), "
        f"K2 call (batch 8), K3 call (bf16 x, float32 weight), K5 call "
        f"(batch 4), K3 call in float32 and K4 call (8 x 8192^2), "
        f"torch.profiler: {json.dumps(own)}, no other")


def dec6_backward_ms(device):
    """dec6's backward at the training shape (batch 4, Cin 40, S 64,
    bf16), all three gradients: through the forward again and
    autograd.grad, and by ``deconv_final_backward`` (one
    ``aten.convolution_backward``, no forward).  Returns both medians."""
    import torch
    import torch.nn.functional as F
    from genre_shapehd_tpu_torch.ops.cuda import subpixel_kernel as sk
    b, cin, s = TRAIN["batch"], DEC6["cin"], DEC6["s"]
    bf = torch.bfloat16
    g = torch.Generator(device=device).manual_seed(13)
    x = torch.randn((b, cin, s, s, s), generator=g, device=device).to(bf)
    w = torch.randn((cin, 1, 4, 4, 4), generator=g, device=device) * 0.05
    bias = torch.full((1,), 0.1, device=device)
    grad = torch.randn((b, 1, 2 * s, 2 * s, 2 * s), generator=g,
                       device=device).to(bf)

    def before():
        with torch.enable_grad():
            xr, wr, br = (t.detach().requires_grad_(True)
                          for t in (x, w, bias))
            out = F.conv_transpose3d(xr, wr.to(bf), br.to(bf), stride=2,
                                     padding=1)
            return torch.autograd.grad(out, [xr, wr, br], grad)

    def after():
        return sk.deconv_final_backward(grad, x, w)

    for old, new in zip(before(), after()):
        scale = float(old.float().abs().max())
        d = float((old.float() - new.float()).abs().max())
        check(d <= 1e-2 * scale, f"dec6 backward: {d} at scale {scale}")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=device)
    return time_ms(before, flush), time_ms(after, flush)


def phase_render_grad(device):
    """The renderer's gradient on the card (forward K1, K2; backward K1,
    K5 and the transpose) against the CPU's plain path, float32, at a
    reduced size; the bfloat16 gradient at the main shapes is finite."""
    import torch
    from genre_shapehd_tpu_torch import ops
    from genre_shapehd_tpu_torch.ops.cuda import render_kernel as rk
    b, v, r, z, m = 2, 64, 64, 128, 96
    vox = volume(b, v, 7, device)
    w = torch.randn((b, r, r), device=device,
                    generator=torch.Generator(device=device).manual_seed(8))
    grads = []
    for dev in (device, torch.device("cpu")):
        x = vox.to(dev).clone().requires_grad_(True)
        rk.reset_launches()
        out = ops.render_spherical_fast(x, r, z, m, torch.float32)
        check(out.grad_fn is not None, f"renderer output on {dev} has no "
              "grad_fn")
        (out * w.to(dev)).sum().backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            launches = dict(rk.launches)
            check(launches == {"render_stage1": 2, "render_stage2_scan": 1,
                               "render_stage2_samples": 1},
                  f"forward + backward launches {launches}")
        else:
            check(set(rk.launches.values()) == {0}, "the CPU run launched")
        grads.append(x.grad.cpu())
    rel = float((grads[0] - grads[1]).abs().max() / grads[1].abs().max())
    # test_pallas_vjp_matches_xla_grad's bound, relative to the largest
    check(rel < 2e-2, f"card vs CPU renderer gradient {rel}")
    x = volume(MAIN["b"], MAIN["v"], 9, device).requires_grad_(True)
    out = ops.render_spherical_fast(x, MAIN["r"], MAIN["z"], MAIN["m"],
                                    torch.bfloat16)
    out.sum().backward()
    check(bool(torch.isfinite(x.grad).all()), "bf16 gradient not finite")
    with torch.inference_mode():
        check(ops.render_spherical_fast(x, MAIN["r"], MAIN["z"], MAIN["m"],
                                        torch.bfloat16).grad_fn is None,
              "inference_mode recorded a graph")
    log(f"[grad] renderer gradient card vs CPU, f32 (2, 64^3 -> 64^2 x "
        f"128): max err {rel:.3g} of the largest; launches forward + "
        f"backward {launches}; bf16 at batch 8, 128^3: finite")


def _csv_rows(path):
    import csv
    with open(path) as f:
        return list(csv.DictReader(f))


def phase_train(device, work):
    """``cli.train`` at full width, bfloat16, batch 4, in stage 3 and with
    --joint_train; then ``cli.test`` on the joint checkpoint."""
    import torch
    from genre_shapehd_tpu_torch.cli import test as cli_test
    from genre_shapehd_tpu_torch.cli import train as cli_train
    from genre_shapehd_tpu_torch.core.checkpoint import load_checkpoint
    from genre_shapehd_tpu_torch.core.convert import jax_to_torch
    from genre_shapehd_tpu_torch.core.registry import get_model
    from genre_shapehd_tpu_torch.models.base import default_opt
    from genre_shapehd_tpu_torch.ops.cuda import render_kernel as rk
    from genre_shapehd_tpu_torch.ops.cuda import subpixel_kernel as sk
    from genre_shapehd_tpu_torch.train.state import adam_moments
    b, steps = TRAIN["batch"], TRAIN["steps"]
    logdir = os.path.join(work, "train")
    base = ["--net", "genre_full_model", "--dataset", "synthetic",
            "--batch_size", str(b), "--dtype", "bfloat16",
            "--surface_weight", "10", "--lr", "1e-4", "--epoch", "1",
            "--epoch_batches", str(steps), "--eval_batches", "1",
            "--synthetic_length", str(2 * b), "--workers", "4",
            "--logdir", logdir, "--log_time", "--log_batch",
            "--manual_seed", "0", "--save_net", "0", "--vis_batches_vali",
            "0", "--device", "cuda"]
    # the weights cli.train starts from: the seeded init, made on the CPU
    start = get_model("genre_full_model")(default_opt(device="cpu"))
    start.init_state(0)
    start = {k: v for k, v in start.net.state_dict().items()
             if "running_" not in k and "num_batches" not in k}
    runs, main_launches = {}, None
    for name, extra, expr in (("stage3", [], "0"),
                              ("joint", ["--joint_train"], "1")):
        joint = name == "joint"
        rk.reset_launches()
        sk.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rc = cli_train.main(base + extra + ["--expr_id", expr])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {**rk.launches, **sk.launches}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(rc == 0, f"cli.train {name} returned {rc}")
        d = os.path.join(logdir, "genre_full_model_synthetic_0.0001", expr)
        rows = _csv_rows(os.path.join(d, "batch_loss.csv"))
        check(len(rows) == steps, f"{name}: {len(rows)} logged steps")
        metrics = [k for k in rows[0] if k not in ("epoch", "batch", "size",
                                                   "batch_time",
                                                   "data_time")]
        check("voxel_loss" in metrics and ("depth" in metrics) == joint,
              f"{name}: metrics {metrics}")
        check(all(np.isfinite(float(row[k])) for row in rows
                  for k in metrics), f"{name}: a loss is not finite")
        # per step: K1, K2, K3 once, and under --joint_train the renderer's
        # backward K1, K5 once more; the eval batch: K1, K2, K3 once
        want = {"render_stage1": steps * (1 + joint) + 1,
                "render_stage2_scan": steps + 1,
                "render_stage2_samples": steps * joint,
                "deconv_final": steps + 1}
        check(launches == want, f"{name}: launches {launches} != {want}")
        payload = load_checkpoint(os.path.join(d, "checkpoint.pt"))
        count = adam_moments(payload["optimizers"][0])[0]
        check(count == steps, f"{name}: Adam count {count}")
        net = payload["nets"][0]
        after = jax_to_torch(net["params"], net["batch_stats"])
        moved = {}
        for sub in ("depth_and_inpaint.net1.", "depth_and_inpaint.net2.",
                    "refine_net."):
            moved[sub] = max(float((after[k] - v).abs().max())
                             for k, v in start.items() if k.startswith(sub))
        check(moved["refine_net."] > 0 and
              (moved["depth_and_inpaint.net1."] > 0) == joint and
              (moved["depth_and_inpaint.net2."] > 0) == joint,
              f"{name}: parameters moved {moved}")
        times = [float(row["batch_time"]) for row in rows]
        step_ms = statistics.median(times[2:]) * 1e3
        loss = [round(float(row["loss"]), 4) for row in rows]
        runs[name] = dict(step_ms=step_ms, peak_gib=peak, seconds=seconds,
                          launches=launches, loss=loss, moved=moved)
        if joint:
            main_launches = launches
        else:
            # a checkpoint with Adam's moments is 1.2 GB: keep one run's
            shutil.rmtree(d)
        log(f"[train] cli.train {name}: {steps} steps of batch {b}, bf16, "
            f"256^2 -> 128^3; loss {loss}; step {step_ms:.1f} ms (median of "
            f"steps 3..{steps}; first two {times[0] * 1e3:.0f}, "
            f"{times[1] * 1e3:.0f} ms); peak memory {peak:.2f} GiB; "
            f"{seconds:.1f} s wall with set-up; launches {launches}; max "
            f"parameter change {json.dumps(moved)}")
    # the port's cli.test reads the checkpoint the training wrote
    photos = os.path.join(work, "train_photos")
    make_photos(photos, 4, seed=1)
    out_dir = os.path.join(work, "train_test")
    ckpt = os.path.join(logdir, "genre_full_model_synthetic_0.0001", "1",
                        "checkpoint.pt")
    rc = cli_test.main(["--net", "genre_full_model", "--net_file", ckpt,
                        "--input_rgb", os.path.join(photos, "*_rgb.png"),
                        "--input_mask",
                        os.path.join(photos, "*_silhouette.png"),
                        "--output_dir", out_dir, "--dtype", "bfloat16",
                        "--batch_size", "4", "--vis_workers", "4",
                        "--device", "cuda"])
    check(rc == 0, f"cli.test on the trained checkpoint returned {rc}")
    pv = np.load(os.path.join(out_dir, "batch0000.npz"))["pred_voxel"]
    check(pv.shape == (4, 128, 128, 128) and bool(np.isfinite(pv).all()),
          f"cli.test on the trained checkpoint: {pv.shape}")
    log(f"[train] cli.test read the joint checkpoint: pred_voxel "
        f"{pv.shape}, finite")
    return runs, main_launches


def _net_state(path):
    """A checkpoint's first net as {state_dict key: tensor}."""
    from genre_shapehd_tpu_torch.core.checkpoint import load_checkpoint
    return _flat_net(load_checkpoint(path)["nets"][0])


def _max_change(after, before, prefix):
    """The largest weight change under ``prefix`` (statistics excluded)."""
    return max(float((after[k] - v).abs().max()) for k, v in before.items()
               if k.startswith(prefix) and "running_" not in k)


def phase_staged(device, work):
    """GenRe's staged training on procedural scenes through ``cli.train``
    at full width, bfloat16, batch 4: MarrNet-1 --pred_depth_minmax, then
    depth_pred_with_sph_inpaint --net1_path <stage 1>, then
    genre_full_model --inpaint_path <stage 2> --surface_weight 10, each
    for ``TRAIN["steps"]`` steps and one eval batch; then
    ``tools/qualrun_torch.py``'s ``eval_quality`` of stage 3's checkpoint
    on 16 held-out scenes.  Returns each stage's step time, memory and
    launches, and the score's metrics and launches; and the path of stage
    1's checkpoint, kept for phase 8."""
    import torch
    from genre_shapehd_tpu_torch.cli import train as cli_train
    from genre_shapehd_tpu_torch.core.registry import get_dataset, get_model
    from genre_shapehd_tpu_torch.data import procedural
    from genre_shapehd_tpu_torch.data.loader import DataLoader
    from genre_shapehd_tpu_torch.models.base import default_opt
    from genre_shapehd_tpu_torch.ops.cuda import chamfer_kernel as ck
    from genre_shapehd_tpu_torch.ops.cuda import render_kernel as rk
    from genre_shapehd_tpu_torch.ops.cuda import subpixel_kernel as sk
    from genre_shapehd_tpu_torch.train.loop import Trainer
    from tools.qualrun_torch import eval_quality
    b, steps = TRAIN["batch"], TRAIN["steps"]
    n_train = b * steps                  # one pass: each scene once
    # scenes live in this process's memory; generated up front
    procedural.Dataset.disk_cache_dir = ""
    t0 = time.perf_counter()
    opt = default_opt(device="cpu", procedural_length=n_train)
    made = sum(procedural.Dataset(opt, mode).warm(8)
               for mode in ("train", "vali"))
    log(f"[staged] {made} procedural scenes (256^2, 128^3, sph 128) in "
        f"{time.perf_counter() - t0:.1f} s, 8 processes")
    check(made == n_train + 16, f"generated {made} scenes")

    logdir = os.path.join(work, "staged")
    base = ["--dataset", "procedural", "--procedural_length", str(n_train),
            "--batch_size", str(b), "--dtype", "bfloat16", "--epoch", "1",
            "--epoch_batches", str(steps), "--eval_batches", "1",
            "--workers", "4", "--logdir", logdir, "--log_time",
            "--log_batch", "--manual_seed", "0", "--save_net", "0",
            "--vis_batches_vali", "0", "--device", "cuda"]
    run = lambda net, lr: os.path.join(                       # noqa: E731
        logdir, f"{net}_procedural_{lr}", "0")
    d1, d2, d3 = (run("marrnet1", 0.001),
                  run("depth_pred_with_sph_inpaint", 0.0001),
                  run("genre_full_model", 0.0001))
    stages = (
        ("marrnet1", ["--net", "marrnet1", "--pred_depth_minmax", "--lr",
                      "1e-3"], d1, "depth_minmax"),
        ("depth_pred_with_sph_inpaint",
         ["--net", "depth_pred_with_sph_inpaint", "--pred_depth_minmax",
          "--net1_path", os.path.join(d1, "checkpoint.pt"), "--lr", "1e-4"],
         d2, "spherical"),
        ("genre_full_model",
         ["--net", "genre_full_model", "--pred_depth_minmax",
          "--inpaint_path", os.path.join(d2, "checkpoint.pt"),
          "--surface_weight", "10", "--lr", "1e-4"], d3, "voxel_loss"))
    # per step and for the eval batch: stage 2 renders (K1, K2), stage 3
    # also runs dec6 (K3); no stage runs the renderer's backward (K5)
    want = {"marrnet1": (0, 0, 0),
            "depth_pred_with_sph_inpaint": (steps + 1, steps + 1, 0),
            "genre_full_model": (steps + 1, steps + 1, steps + 1)}
    runs, states = {}, {}
    for net, extra, d, metric in stages:
        rk.reset_launches()
        sk.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2 ** 30
        t0 = time.perf_counter()
        rc = cli_train.main(extra + base)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {**rk.launches, **sk.launches}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(rc == 0, f"cli.train {net} returned {rc}")
        k1, k2, k3 = want[net]
        check(launches == {"render_stage1": k1, "render_stage2_scan": k2,
                           "render_stage2_samples": 0, "deconv_final": k3},
              f"{net}: launches {launches}")
        rows = _csv_rows(os.path.join(d, "batch_loss.csv"))
        check(len(rows) == steps, f"{net}: {len(rows)} logged steps")
        terms = [k for k in rows[0] if k not in (
            "epoch", "batch", "size", "batch_time", "data_time")]
        check(metric in terms and all(np.isfinite(float(row[k]))
                                      for row in rows for k in terms),
              f"{net}: loss terms {terms} not all finite")
        times = [float(row["batch_time"]) for row in rows]
        data_ms = statistics.median(float(row["data_time"])
                                    for row in rows[2:]) * 1e3
        states[net] = _net_state(os.path.join(d, "checkpoint.pt"))
        runs[net] = dict(step_ms=statistics.median(times[2:]) * 1e3,
                         data_ms=data_ms, peak_gib=peak, held_gib=held,
                         seconds=seconds, launches=launches,
                         loss=[round(float(row["loss"]), 4) for row in rows])
        log(f"[staged] cli.train {net}: {steps} steps of batch {b}, bf16; "
            f"loss {runs[net]['loss']}; step {runs[net]['step_ms']:.1f} ms "
            f"(median of steps 3..{steps}; first two "
            f"{times[0] * 1e3:.0f}, {times[1] * 1e3:.0f} ms; a batch's "
            f"loading on the prefetch thread {data_ms:.1f} ms); peak memory "
            f"{peak:.2f} GiB ({held:.2f} GiB held before the run); "
            f"{seconds:.1f} s wall with set-up; launches {launches}")

    # which nets moved, against the seeded starts cli.train made (built
    # on the CPU); stage 2's net1 is stage 1's checkpoint bit for bit,
    # BatchNorm statistics included, as loaded and after its steps
    def start(net, **kw):
        model = get_model(net)(default_opt(device="cpu", **kw))
        model.init_state(0)
        return {k: v for k, v in model.net.state_dict().items()
                if not k.endswith("num_batches_tracked")}
    s1, s2, s3 = (states[k] for k in ("marrnet1",
                                      "depth_pred_with_sph_inpaint",
                                      "genre_full_model"))
    init1 = start("marrnet1", pred_depth_minmax=True)
    moved1 = {p: _max_change(s1, init1, p) for p in (
        "ResNet18Features_0.", "decoder_normal.", "decoder_depth.",
        "decoder_silhou.", "MinmaxHead_0.")}
    check(all(v > 0 for v in moved1.values()), f"stage 1 moved {moved1}")
    loaded = start("depth_pred_with_sph_inpaint",
                   net1_path=os.path.join(d1, "checkpoint.pt"))
    for k, v in s1.items():
        check(torch.equal(loaded["net1." + k], v)
              and torch.equal(s2["net1." + k], v),
              f"stage 2's net1 differs from stage 1's checkpoint at {k}")
    moved2 = _max_change(s2, start("depth_pred_with_sph_inpaint"), "net2.")
    check(moved2 > 0, "stage 2 did not move net2")
    init3 = start("genre_full_model")
    for k, v in s2.items():
        # stage 3 runs net2 in train mode (its statistics move), net1 in
        # eval mode, and trains the refine net only
        if "running_" not in k or k.startswith("net1."):
            check(torch.equal(s3["depth_and_inpaint." + k], v),
                  f"stage 3 changed depth_and_inpaint.{k}")
    moved3 = _max_change(s3, init3, "refine_net.")
    check(moved3 > 0, "stage 3 did not move the refine net")
    log(f"[staged] largest weight change: stage 1 {json.dumps(moved1)}; "
        f"stage 2 net2 {moved2:.3g} (net1 equal to stage 1's checkpoint, "
        f"statistics included, before and after its steps); "
        f"stage 3 refine_net {moved3:.3g}, depth_and_inpaint unchanged")

    # held-out quality of stage 3's checkpoint, as the quality run scores
    opt3 = default_opt(device="cuda", dtype="bfloat16",
                       procedural_length=n_train, batch_size=b)
    model = get_model("genre_full_model")(opt3)
    trainer = Trainer(model, opt3)
    trainer.initialize(0)
    trainer.load(os.path.join(d3, "checkpoint.pt"))
    vali = get_dataset("procedural")(opt3, "vali", model=model)
    rk.reset_launches()
    sk.reset_launches()
    ck.reset_launches()
    t0 = time.perf_counter()
    res, _ = eval_quality(model, DataLoader(vali, b, 4), tag="staged")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {**rk.launches, **sk.launches, **ck.launches}
    n = len(vali)
    check(res["n_items"] == n == 16 and res["chamfer_n"] == 16
          and 0.0 <= res["iou_best"] <= 1.0
          and bool(np.isfinite(res["chamfer_mean"])),
          f"held-out quality {res}")
    check(launches == {"render_stage1": n // b, "render_stage2_scan": n // b,
                       "render_stage2_samples": 0, "deconv_final": n // b,
                       "nn_min_dist": n}, f"scoring launches {launches}")
    runs["score"] = dict(seconds=seconds, launches=launches, **res)
    log(f"[staged] eval_quality of stage 3 on {n} held-out scenes: IoU@0.5 "
        f"{res['iou_0.5']:.4f}, IoU@best {res['iou_best']:.4f} (th "
        f"{res['iou_best_th']}), Chamfer {res['chamfer_mean']:.4f} (mean of "
        f"{res['chamfer_n']}; 8-step models); {seconds:.1f} s; launches "
        f"{launches}")
    del model, trainer
    # stage 1's checkpoint is MarrNet-1 for phase 8
    marrnet1_ckpt = os.path.join(work, "marrnet1.pt")
    os.replace(os.path.join(d1, "checkpoint.pt"), marrnet1_ckpt)
    shutil.rmtree(logdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return runs, marrnet1_ckpt


#: K3's shapes on the MarrNet / ShapeHD paths at 128³: MarrNet-2's decoder
#: (32 -> 1, a bias) at batch 8, as dec6 is timed, and the WGAN-GP
#: generator (64 -> 1, no bias) at its training batch of 4
FAMILY_K3 = {"decoder": dict(b=8, cin=32, s=64, bias=True),
             "generator": dict(b=4, cin=64, s=64, bias=False)}


def phase_family_kernels(device, flush):
    """K3 at MarrNet-2's decoder and the WGAN-GP generator's shapes,
    against its plain version in bf16 (``k3_bf16_within``) and float32
    (1e-5 of the scale, TF32 off), timed (CUDA events, L2 flushed) beside
    its bound and ``F.conv_transpose3d``; a layer without a bias hands
    K3 a zero one.  Returns a row per shape and type."""
    import torch
    import torch.nn.functional as F
    from genre_shapehd_tpu_torch.ops.cuda import subpixel_kernel as sk
    rows = {}
    for name, shp in FAMILY_K3.items():
        b, cin, s = shp["b"], shp["cin"], shp["s"]
        g = torch.Generator(device=device).manual_seed(21)
        x32 = torch.randn((b, cin, s, s, s), generator=g, device=device)
        w = torch.randn((cin, 1, 4, 4, 4), generator=g, device=device) \
            * (0.5 / cin ** 0.5)
        bias = torch.full((1,), 0.1 if shp["bias"] else 0.0, device=device)
        n_out = b * (2 * s) ** 3
        for dtype in (torch.bfloat16, torch.float32):
            x = x32.to(dtype)
            sk.reset_launches()
            out = sk.deconv_final(x, w, bias)
            torch.cuda.synchronize()
            check(sk.launches == {"deconv_final": 1} and out.dtype == dtype
                  and out.shape == (b, 1, 2 * s, 2 * s, 2 * s),
                  f"K3 {name} {dtype}: launches {sk.launches}, {out.shape}")
            ref = sk.deconv_final_plain(x, w, bias).float()
            scale = float(ref.abs().max())
            d = (out.float() - ref).abs()
            err = (float(d.max()), float(d.mean()))
            tag = f"{name} {str(dtype)[6:]}"
            if dtype == torch.bfloat16:
                exact = F.conv_transpose3d(x.float(), w.to(dtype).float(),
                                           bias, stride=2, padding=1)
                e = float((out.float() - exact).abs().max())
                e_plain = float((ref - exact).abs().max())
                ok, waived = k3_bf16_within(*err, e, e_plain, scale,
                                            float(exact.abs().max()))
                del exact
                check(ok, f"K3 {tag}: {err} vs plain, {e} (plain "
                          f"{e_plain}) vs float32, scale {scale}")
                log(f"[kernels] K3 {tag} {shp}: max/mean abs err "
                    f"{err[0]:.3g}/{err[1]:.3g} vs plain, max {e:.3g} vs "
                    f"float32 (plain {e_plain:.3g}), scale {scale:.3g}"
                    + (" (1e-2 bound waived)" if waived else ""))
                bnd = bound(x.numel() * 2 + cin * 64 * 4 + 4 + n_out * 2,
                            2.0 * 8 * cin * n_out, H100_BF16_FLOPS)
                lib = (lambda x=x, wb=w.to(dtype), bb=bias.to(dtype):
                       F.conv_transpose3d(x, wb, bb, stride=2, padding=1))
            else:
                check(err[0] <= 1e-5 * scale,
                      f"K3 {tag}: {err[0]} vs plain at scale {scale}")
                log(f"[kernels] K3 {tag} {shp}: max abs err {err[0]:.3g} "
                    f"vs plain at scale {scale:.3g}")
                bnd = bound(x.numel() * 4 + cin * 64 * 4 + 4 + n_out * 4,
                            2.0 * 8 * cin * n_out)
                lib = (lambda x=x: F.conv_transpose3d(x, w, bias, stride=2,
                                                      padding=1))
            del out, ref, d
            ms = time_ms(lambda x=x: sk.deconv_final(x, w, bias), flush)
            plain_ms = time_ms(lambda x=x: sk.deconv_final_plain(x, w, bias),
                               flush)
            library_ms = time_ms(lib, flush)
            bms, by, nbytes = bnd
            rows[tag.replace(" ", "_")] = dict(
                shape=[b, cin, s], bias=shp["bias"], ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bms,
                bound_by=by, bound_share=bms / ms,
                achieved_gb_per_s=nbytes / ms / 1e6, max_abs_err=err[0])
            log(f"[kernels] K3 {tag} {[b, cin, s]}: {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, F.conv_transpose3d {library_ms:.4f} ms, "
                f"bound {bms * 1e3:.1f} us ({by}), {100 * bms / ms:.1f} % "
                f"of the bound")
        del x32, x
    return rows


def phase_family(device, work, marrnet1_ckpt):
    """The MarrNet-2 / ShapeHD family through ``cli.train`` on phase 7's
    procedural scenes at 256² -> 128³, bfloat16, batch 4, 8 steps each:
    marrnet2 --canon_sup; wgangp --canon_voxel, and again with
    --gan_d_iter 2; shapehd --canon_sup --marrnet2 <marrnet2> --gan
    <wgangp> --w_gan_loss 1e-3; marrnet --canon_sup --marrnet1 <phase 7's
    stage 1> --marrnet2 <marrnet2>.  Finite losses, K3's launches, which
    nets moved, step time, peak memory.  Then ``cli.test --net marrnet``
    and ``--net shapehd --marrnet1_file`` on phase 3's 16 photos at batch
    8 (K3 once / twice a batch, the .npz keys, the meshes), and
    ``tools/qualrun_shapehd_torch.py``'s ``eval_quality`` of the ShapeHD
    checkpoint on 16 held-out scenes (K4 once an item)."""
    import torch
    from genre_shapehd_tpu_torch.cli import test as cli_test
    from genre_shapehd_tpu_torch.cli import train as cli_train
    from genre_shapehd_tpu_torch.core.checkpoint import load_checkpoint
    from genre_shapehd_tpu_torch.core.registry import get_dataset, get_model
    from genre_shapehd_tpu_torch.data.loader import DataLoader
    from genre_shapehd_tpu_torch.models.base import default_opt
    from genre_shapehd_tpu_torch.ops.cuda import chamfer_kernel as ck
    from genre_shapehd_tpu_torch.ops.cuda import critic_conv_kernel as ccv
    from genre_shapehd_tpu_torch.ops.cuda import critic_stem_kernel as cst
    from genre_shapehd_tpu_torch.ops.cuda import render_kernel as rk
    from genre_shapehd_tpu_torch.ops.cuda import subpixel_kernel as sk
    from genre_shapehd_tpu_torch.train.loop import Trainer
    from genre_shapehd_tpu_torch.train.state import adam_moments
    from tools.qualrun_shapehd_torch import eval_quality
    b, steps = TRAIN["batch"], TRAIN["steps"]
    n_train = b * steps                  # phase 7's scenes, in memory
    logdir = os.path.join(work, "family")
    base = ["--dataset", "procedural", "--procedural_length", str(n_train),
            "--batch_size", str(b), "--dtype", "bfloat16", "--epoch", "1",
            "--epoch_batches", str(steps), "--eval_batches", "1",
            "--workers", "4", "--logdir", logdir, "--log_time",
            "--log_batch", "--manual_seed", "0", "--save_net", "0",
            "--vis_batches_vali", "0", "--device", "cuda"]
    run = lambda net, lr, expr="0": os.path.join(            # noqa: E731
        logdir, f"{net}_procedural_{lr}", expr)
    dA, dB, dB2, dC, dD = (run("marrnet2", 0.001), run("wgangp", 0.0001),
                           run("wgangp", 0.0001, "1"),
                           run("shapehd", 0.0001), run("marrnet", 0.0001))
    ckA, ckB = (os.path.join(d, "checkpoint.pt") for d in (dA, dB))
    # K3 a train step and an eval batch: MarrNet-2's decoder once; G once
    # in D's phase and once in its own (every step, or every second one),
    # and once an eval batch; ShapeHD's net once a step and, with the
    # frozen copy, twice an eval batch.  K6 (forward, backward): ShapeHD's
    # frozen critic once each way a step, its backward on K3 (a second K3
    # launch a step), and forward twice an eval batch (both grids, no
    # gradient); WGAN-GP's critic trains in a step and reads bf16 G(z) in
    # the eval batch, so it keeps nn.Conv3d.  K7 runs the frozen critic's
    # middle layers wherever K6 runs its first, K7_PER_CRITIC a call
    runs_spec = (
        ("marrnet2", ["--net", "marrnet2", "--canon_sup", "--lr", "1e-3"],
         dA, "loss", steps + 1, (0, 0)),
        ("wgangp", ["--net", "wgangp", "--canon_voxel", "--lr", "1e-4"],
         dB, "err_d_gp", 2 * steps + 1, (0, 0)),
        ("wgangp_d_iter2", ["--net", "wgangp", "--canon_voxel",
                            "--gan_d_iter", "2", "--lr", "1e-4",
                            "--expr_id", "1"], dB2, "err_d_gp",
         steps + steps // 2 + 1, (0, 0)),
        ("shapehd", ["--net", "shapehd", "--canon_sup", "--marrnet2", ckA,
                     "--gan", ckB, "--w_gan_loss", "1e-3", "--lr", "1e-4"],
         dC, "gan", 2 * steps + 2, (steps + 2, steps)),
        ("marrnet", ["--net", "marrnet", "--canon_sup", "--marrnet1",
                     marrnet1_ckpt, "--marrnet2", ckA, "--lr", "1e-4"],
         dD, "loss", steps + 1, (0, 0)))
    runs = {}
    for name, extra, d, metric, k3, (k6, k6b) in runs_spec:
        rk.reset_launches()
        sk.reset_launches()
        ck.reset_launches()
        cst.reset_launches()
        ccv.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2 ** 30
        t0 = time.perf_counter()
        rc = cli_train.main(extra + base)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {**rk.launches, **sk.launches, **ck.launches,
                    **cst.launches, **ccv.launches}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(rc == 0, f"cli.train {name} returned {rc}")
        want = {k: 0 for k in launches}
        want.update(deconv_final=k3, critic_stem=k6,
                    critic_stem_backward=k6b, critic_stem_mask=k6b,
                    critic_conv=K7_PER_CRITIC * k6,
                    critic_conv_backward=K7_PER_CRITIC * k6b)
        check(launches == want, f"{name}: launches {launches} != {want}")
        rows = _csv_rows(os.path.join(d, "batch_loss.csv"))
        check(len(rows) == steps, f"{name}: {len(rows)} logged steps")
        terms = [k for k in rows[0] if k not in (
            "epoch", "batch", "size", "batch_time", "data_time")]
        check(metric in terms and all(np.isfinite(float(row[k]))
                                      for row in rows for k in terms),
              f"{name}: loss terms {terms} not all finite")
        times = [float(row["batch_time"]) for row in rows]
        runs[name] = dict(
            step_ms=statistics.median(times[2:]) * 1e3, peak_gib=peak,
            held_gib=held, seconds=seconds, launches=launches,
            loss=[round(float(row["loss"]), 4) for row in rows])
        log(f"[family] cli.train {name}: {steps} steps of batch {b}, bf16, "
            f"256^2 -> 128^3; loss {runs[name]['loss']}; step "
            f"{runs[name]['step_ms']:.1f} ms (median of steps 3..{steps}; "
            f"first two {times[0] * 1e3:.0f}, {times[1] * 1e3:.0f} ms); "
            f"peak memory {peak:.2f} GiB ({held:.2f} GiB held before the "
            f"run); {seconds:.1f} s wall with set-up; launches {launches}")

    def nets(d):
        payload = load_checkpoint(os.path.join(d, "checkpoint.pt"))
        return payload, {n: _flat_net(net) for n, net in
                         zip(payload["net_names"], payload["nets"])}

    def start(net, **kw):
        model = get_model(net)(default_opt(device="cpu", **kw))
        model.init_state(0)
        return {n: {k: v for k, v in m.state_dict().items()
                    if not k.endswith("num_batches_tracked")}
                for n, m in model.net_modules().items()}

    # which nets moved: MarrNet-2 from its seeded start; both WGAN-GP nets
    # (G's Adam count halved under --gan_d_iter 2); ShapeHD's net from
    # MarrNet-2's checkpoint, its frozen copy and critic bit for bit;
    # MarrNet's MarrNet-2 from the checkpoint, MarrNet-1 bit for bit
    _, a = nets(dA)
    moved = {"marrnet2": _max_change(a["net"], start(
        "marrnet2", canon_sup=True)["net"], "")}
    w_init = start("wgangp", canon_voxel=True)
    for name, d, counts in (("wgangp", dB, [steps, steps]),
                            ("wgangp_d_iter2", dB2, [steps // 2, steps])):
        payload, w = nets(d)
        got = [adam_moments(o)[0] for o in payload["optimizers"]]
        check(payload["opt_names"] == ["net_g", "net_d"] and got == counts,
              f"{name}: Adam counts {got} != {counts}")
        check(bool(np.isfinite(float(payload["extra"]["last_err_g"]))),
              f"{name}: last_err_g {payload['extra']}")
        moved[name] = {n: _max_change(w[n], w_init[n], "")
                       for n in ("net_g", "net_d")}
    _, c = nets(dC)
    _, wB = nets(dB)
    for key, want in (("net_noft", a["net"]), ("net_d", wB["net_d"])):
        for k, v in want.items():
            check(torch.equal(c[key][k], v), f"shapehd changed {key}.{k}")
    moved["shapehd"] = _max_change(c["net"], a["net"], "")
    _, m = nets(dD)
    for k, v in _net_state(marrnet1_ckpt).items():
        check(torch.equal(m["net"]["marrnet1." + k], v),
              f"marrnet changed marrnet1.{k}")
    moved["marrnet"] = _max_change(
        m["net"], {"marrnet2." + k: v for k, v in a["net"].items()},
        "marrnet2.")
    check(moved["marrnet2"] > 0 and moved["shapehd"] > 0
          and moved["marrnet"] > 0
          and all(v > 0 for n in ("wgangp", "wgangp_d_iter2")
                  for v in moved[n].values()), f"moved {moved}")
    log(f"[family] largest weight change: {json.dumps(moved)}; ShapeHD's "
        f"net_noft and net_d, MarrNet's marrnet1 (statistics included) "
        f"equal to the checkpoints they were loaded from")
    runs["moved"] = moved

    # serving: cli.test on phase 3's photos.  The meshes are drawn at the
    # occupancy level 0.9: at the default 0.25 an 8-step net's noisy field
    # gives 2 M triangles a mesh (about 230 MB of .obj each), at 0.5 up to
    # 0.8 M (about 50 s of this phase's wall on an H100 host)
    photos = os.path.join(work, "photos")
    vis_param = os.path.join(work, "vis_param.json")
    with open(vis_param, "w") as f:
        json.dump({"voxel": {"isosurf_thres": 0.9}}, f)
    per_item = {"marrnet": ["00_rgb.png", "04_rgb.png", "05_pred_depth.png",
                            "06_pred_silhou.png", "07_pred_normal.png",
                            "12_pred_voxel.obj"]}
    per_item["shapehd"] = per_item["marrnet"] + ["11_pred_voxel_noft.obj"]
    # (net, checkpoint, flags, K3 and K6 launches a batch)
    for net, ckpt, extra, k3, k6 in (
            ("marrnet", os.path.join(dD, "checkpoint.pt"), [], 1, 0),
            ("shapehd", os.path.join(dC, "checkpoint.pt"),
             ["--marrnet1_file", marrnet1_ckpt], 2, 2)):
        out_dir = os.path.join(work, f"test_{net}")
        sk.reset_launches()
        cst.reset_launches()
        ccv.reset_launches()
        t0 = time.perf_counter()
        rc = cli_test.main(["--net", net, "--net_file", ckpt] + extra + [
            "--input_rgb", os.path.join(photos, "*_rgb.png"),
            "--input_mask", os.path.join(photos, "*_silhouette.png"),
            "--output_dir", out_dir, "--dtype", "bfloat16",
            "--batch_size", "8", "--vis_workers", "8", "--vis_param_f",
            vis_param, "--device", "cuda"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {**sk.launches, **cst.launches, **ccv.launches}
        check(rc == 0 and launches == {"deconv_final": 2 * k3,
                                       "critic_stem": 2 * k6,
                                       "critic_stem_backward": 0,
                                       "critic_stem_mask": 0,
                                       "critic_conv": 2 * K7_PER_CRITIC * k6,
                                       "critic_conv_backward": 0},
              f"cli.test {net}: rc {rc}, launches {launches}")
        keys = {"rgb_path", "rgb", "pred_silhou", "pred_normal",
                "pred_depth", "pred_voxel"} | (
            {"pred_voxel_noft"} if net == "shapehd" else set())
        tris = []
        for bi in range(2):
            z = np.load(os.path.join(out_dir, f"batch{bi:04d}.npz"))
            check(set(z.files) == keys, f"{net}: npz keys {z.files}")
            check(z["pred_voxel"].shape == (8, 128, 128, 128)
                  and bool(np.isfinite(z["pred_voxel"]).all()),
                  f"{net}: pred_voxel {z['pred_voxel'].shape}")
            d = os.path.join(out_dir, f"batch{bi:04d}")
            want = sorted(f"{i:04d}_{f}" for i in range(8 * bi, 8 * bi + 8)
                          for f in per_item[net])
            check(sorted(os.listdir(d)) == want, f"{d}: {os.listdir(d)}")
            tris += [parse_obj(os.path.join(d, f)) for f in want
                     if f.endswith(".obj")]
        runs[f"test_{net}"] = dict(seconds=seconds, launches=launches,
                                   mesh_tris=[min(tris), max(tris)])
        log(f"[family] cli.test --net {net}: 16 photos, 2 batches of 8, "
            f"bf16, {seconds:.1f} s wall (set-up and meshes at iso 0.9 "
            f"included); launches {launches}; npz keys "
            f"{sorted(keys)}; {len(tris)} meshes parsed, {min(tris)} to "
            f"{max(tris)} triangles")

    # the held-out score of the ShapeHD checkpoint, as the quality run's
    opt = default_opt(device="cuda", dtype="bfloat16", canon_sup=True,
                      w_gan_loss=1e-3, procedural_length=n_train,
                      batch_size=b)
    model = get_model("shapehd")(opt)
    trainer = Trainer(model, opt)
    trainer.initialize(0)
    trainer.load(os.path.join(dC, "checkpoint.pt"))
    vali = get_dataset("procedural")(opt, "vali", model=model)
    rk.reset_launches()
    sk.reset_launches()
    ck.reset_launches()
    cst.reset_launches()
    ccv.reset_launches()
    t0 = time.perf_counter()
    res, _ = eval_quality(model, DataLoader(vali, b, 4), model.voxel_key,
                          tag="family")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {**rk.launches, **sk.launches, **ck.launches,
                **cst.launches, **ccv.launches}
    n = len(vali)
    check(res["n_items"] == n == 16 and res["chamfer_n"] == 16
          and 0.0 <= res["iou_best"] <= 1.0
          and bool(np.isfinite(res["chamfer_mean"]))
          and bool(np.isfinite(res["critic_score"])),
          f"held-out quality {res}")
    check(launches == {"render_stage1": 0, "render_stage2_scan": 0,
                       "render_stage2_samples": 0,
                       "deconv_final": 2 * n // b, "nn_min_dist": n,
                       "critic_stem": 2 * n // b,
                       "critic_stem_backward": 0, "critic_stem_mask": 0,
                       "critic_conv": 2 * K7_PER_CRITIC * n // b,
                       "critic_conv_backward": 0},
          f"scoring launches {launches}")
    runs["score"] = dict(seconds=seconds, launches=launches, **res)
    log(f"[family] eval_quality of the ShapeHD checkpoint on {n} held-out "
        f"scenes: IoU@0.5 {res['iou_0.5']:.4f}, IoU@best "
        f"{res['iou_best']:.4f}, Chamfer {res['chamfer_mean']:.4f}, critic "
        f"{res['critic_score']:.3g} (frozen copy "
        f"{res['critic_score_noft']:.3g}; 8-step models); {seconds:.1f} s; "
        f"launches {launches}")
    del model, trainer
    shutil.rmtree(logdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return runs


#: phase 9: the synsets of the ShapeNet-layout tree (the first is trained
#: on), its train and vali scenes of each, the index of the train view
#: without voxels, and the steps of the scripts' stages (the joint
#: fine-tune's fewer)
SHAPENET = dict(classes=("03001627", "02958343"), train=(20, 12),
                vali=(12, 4), no_voxel=5, steps=4, joint_steps=2)


def shapenet_tree_module():
    """``tests/_shapenet_tree.py`` (the tree writer and the scripts'
    command-line recorder that the tests use; no JAX), loaded from its
    file, so that ``tests/`` never joins the import path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "_shapenet_tree", os.path.join(ROOT, "tests", "_shapenet_tree.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def write_tree(root):
    """Phase 7's procedural scenes (still in this process's memory) as a
    ShapeNet-layout tree: each synset's models with two views, one train
    view of the first synset without voxels, in its pose or canonical;
    PNG rows filtered as libpng chooses.  Returns the seconds it took."""
    from genre_shapehd_tpu_torch.data import procedural
    from genre_shapehd_tpu_torch.models.base import default_opt
    t0 = time.perf_counter()
    opt = default_opt(device="cpu",
                      procedural_length=TRAIN["batch"] * TRAIN["steps"])
    items = []
    for mode, counts in (("train", SHAPENET["train"]),
                         ("vali", SHAPENET["vali"])):
        ds, i = procedural.Dataset(opt, mode), 0
        for synset, n in zip(SHAPENET["classes"], counts):
            for k in range(n):
                model = f"{mode[0]}{k // 2:02d}"
                no_voxel = mode == "train" and i == SHAPENET["no_voxel"]
                items.append(dict(
                    item=f"{synset}/{model}/{model}_view{k % 2:03d}",
                    train=mode == "train", sample=ds._raw(i),
                    missing=("voxel", "voxel_canon") if no_voxel
                    else ()))
                i += 1
    shapenet_tree_module().write_shapenet_tree(root, items)
    return time.perf_counter() - t0


def run_captured(fn, *args):
    """``fn(*args)`` with its standard output captured: (its result, or
    the exception it raised, and the output)."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            return fn(*args), buf.getvalue()
    except Exception as e:                     # the caller checks it
        return e, buf.getvalue()


def phase_shapenet(work):
    """GenRe's ShapeNet training path as ``scripts/train_*.sh`` run it: a
    ShapeNet-layout tree from phase 7's scenes, then each script's own
    command line (recorded from the script) through ``cli.train`` at full
    width, bfloat16, batch 4: train_marrnet1.sh, train_inpaint.sh (and
    again with --exact_render), train_full_genre.sh,
    finetune_genre_joint.sh; smaller epochs, --logdir, one synset, the
    tree's --data_root, --dtype bfloat16 and --log_batch added.  Returns
    each stage's step time, data time, memory and launches."""
    import torch
    from genre_shapehd_tpu_torch.cli import train as cli_train
    from genre_shapehd_tpu_torch.core.registry import get_model
    from genre_shapehd_tpu_torch.models.base import default_opt
    from genre_shapehd_tpu_torch.ops.cuda import render_kernel as rk
    from genre_shapehd_tpu_torch.ops.cuda import subpixel_kernel as sk
    script_argv = shapenet_tree_module().script_argv
    cls = SHAPENET["classes"][0]
    b, s, sj = TRAIN["batch"], SHAPENET["steps"], SHAPENET["joint_steps"]
    root = os.path.join(work, "shapenet")
    seconds = write_tree(root)
    log(f"[shapenet] a ShapeNet-layout tree of {sum(SHAPENET['train'])} "
        f"train and {sum(SHAPENET['vali'])} vali views (synsets "
        f"{'+'.join(SHAPENET['classes'])}; 8-bit RGB, normal and "
        f"silhouette PNGs, 16-bit depth PNGs, rows filtered as libpng "
        f"chooses; .npy, .npz, .mat) from phase 7's scenes in "
        f"{seconds:.1f} s")
    logdir = os.path.join(work, "shapenet_logs")
    small = ["--epoch", "1", "--epoch_batches", str(s), "--eval_batches",
             "1", "--vis_batches_vali", "1", "--save_net", "1",
             "--data_root", root, "--dtype", "bfloat16", "--manual_seed",
             "0", "--log_batch", "--logdir", logdir]
    run = lambda net, lr, top=logdir: os.path.join(          # noqa: E731
        top, f"{net}_shapenet_{lr}_{cls}", "0")
    d1, d2, d3 = (run("marrnet1", 0.001),
                  run("depth_pred_with_sph_inpaint", 0.0001),
                  run("genre_full_model", 0.0001))
    d2x = run("depth_pred_with_sph_inpaint", 0.0001, logdir + "_exact")
    ck = lambda d: os.path.join(d, "checkpoint.pt")          # noqa: E731
    n_tr, n_va = SHAPENET["train"][0], SHAPENET["vali"][0]
    # (stage, script, its variables, flags added, run dir, epoch, a loss
    # term, train views, steps, launches of K1, K2, K5, K3): a forward
    # renders (K1, K2) outside --exact_render, stage 3 runs dec6 (K3),
    # the joint step also the renderer's backward (K1, K5); one eval
    # batch each; the views without voxels and the car's are left out
    stages = (
        ("marrnet1", "train_marrnet1.sh", {}, [], d1, 1, "depth_minmax",
         n_tr, s, (0, 0, 0, 0)),
        ("inpaint", "train_inpaint.sh", {"NET1": ck(d1)}, [], d2, 1,
         "spherical", n_tr, s, (s + 1, s + 1, 0, 0)),
        ("inpaint_exact", "train_inpaint.sh", {"NET1": ck(d1)},
         ["--exact_render", "--logdir", logdir + "_exact"], d2x, 1,
         "spherical", n_tr, s, (0, 0, 0, 0)),
        ("full", "train_full_genre.sh", {"INPAINT": ck(d2)}, [], d3, 1,
         "voxel_loss", n_tr - 1, s, (s + 1, s + 1, 0, s + 1)),
        # --resume -1 of stage 3's logdir: a second epoch
        ("joint", "finetune_genre_joint.sh", {},
         ["--epoch", "2", "--epoch_batches", str(sj)], d3, 2, "depth",
         n_tr - 1, sj, (2 * sj + 1, sj + 1, sj, sj + 1)))

    try:
        import tensorboardX                                   # noqa: F401
        tensorboard = True
    except ImportError:
        tensorboard = False
    if not tensorboard:
        # the scripts' --tensorboard stops a run before its first step
        err, _ = run_captured(cli_train.main,
                              script_argv("train_marrnet1.sh", cls) + small)
        check(isinstance(err, ImportError) and "tensorboardX" in str(err)
              and not os.path.exists(os.path.join(d1, "batch_loss.csv")),
              f"--tensorboard without tensorboardX: {err!r}")
        log(f"[shapenet] no tensorboardX on this machine: --tensorboard "
            f"stops cli.train before its first step ({err}); the runs "
            f"below leave the flag out")
        shutil.rmtree(logdir, ignore_errors=True)

    runs = {}
    for name, script, env, extra, d, epoch, metric, n, steps, want in \
            stages:
        argv = script_argv(script, cls, env) + small + extra
        if not tensorboard:
            argv.remove("--tensorboard")
        csv_path = os.path.join(d, "batch_loss.csv")
        if os.path.exists(csv_path):
            # the resumed run logs other loss terms: a file of its own
            # (the logger appends under the first run's header)
            os.replace(csv_path, csv_path + ".before_resume")
        rk.reset_launches()
        sk.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2 ** 30
        t0 = time.perf_counter()
        rc, out = run_captured(cli_train.main, argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {**rk.launches, **sk.launches}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(rc == 0, f"cli.train {script} ({name}) returned {rc!r}; its "
              f"output ends {out[-2000:]}")
        counts = f"[setup] {n} train / {n_va} vali samples"
        check(counts in out, f"{name}: {counts!r} not in its output")
        k1, k2, k5, k3 = want
        check(launches == {"render_stage1": k1, "render_stage2_scan": k2,
                           "render_stage2_samples": k5, "deconv_final": k3},
              f"{name}: launches {launches}")
        rows = _csv_rows(csv_path)
        check(len(rows) == steps, f"{name}: {len(rows)} logged steps")
        terms = [k for k in rows[0] if k not in (
            "epoch", "batch", "size", "batch_time", "data_time")]
        check(metric in terms and all(np.isfinite(float(row[k]))
                                      for row in rows for k in terms),
              f"{name}: loss terms {terms} not all finite")
        vis = os.path.join(d, f"epoch{epoch:04d}_vali")
        with np.load(os.path.join(vis, "batch0000.npz")) as z:
            check(all(np.isfinite(z[k]).all() for k in z.files),
                  f"{name}: batch0000.npz not finite")
            npz_keys = sorted(z.files)
        drawn = sorted(os.listdir(vis))
        check(len(drawn) > 1 and os.path.isfile(
            os.path.join(d, "nets", f"{epoch:04d}.pt")),
              f"{name}: drew {drawn}")
        if tensorboard:
            check(bool(glob.glob(os.path.join(d, "tensorboard",
                                              "events.out.*"))),
                  f"{name}: no TensorBoard event file")
        times = [float(row["batch_time"]) for row in rows]
        data = [float(row["data_time"]) for row in rows]
        warm = 2 if steps > 2 else 1
        runs[name] = dict(step_ms=statistics.median(times[warm:]) * 1e3,
                          data_ms=statistics.median(data[warm:]) * 1e3,
                          peak_gib=peak, held_gib=held, seconds=seconds,
                          launches=launches, views=[n, n_va],
                          loss=[round(float(r["loss"]), 4) for r in rows])
        log(f"[shapenet] {script} ({name}): {n} train / {n_va} vali views; "
            f"{steps} steps of batch {b}, bf16; loss {runs[name]['loss']}; "
            f"step {runs[name]['step_ms']:.1f} ms (median of steps "
            f"{warm + 1}..{steps}; first {times[0] * 1e3:.0f} ms); a "
            f"batch's loading on the prefetch thread "
            f"{runs[name]['data_ms']:.1f} ms; peak memory {peak:.2f} GiB "
            f"({held:.2f} held before); {seconds:.1f} s wall with set-up; "
            f"launches {launches}; epoch{epoch:04d}_vali: {len(drawn)} "
            f"files, batch0000.npz {npz_keys}")

    # which nets moved, against the seeded starts cli.train made (built on
    # the CPU) or the checkpoint a stage started from; the frozen ones bit
    # for bit, statistics included
    def start(net, **kw):
        model = get_model(net)(default_opt(device="cpu", **kw))
        model.init_state(0)
        return {k: v for k, v in model.net.state_dict().items()
                if not k.endswith("num_batches_tracked")}
    s1, s2, s2x, s3, s4 = (_net_state(p) for p in (
        ck(d1), ck(d2), ck(d2x), os.path.join(d3, "nets", "0001.pt"),
        ck(d3)))
    moved = {"marrnet1": _max_change(s1, start(
        "marrnet1", pred_depth_minmax=True), "")}
    init2 = start("depth_pred_with_sph_inpaint")
    for name, st in (("inpaint", s2), ("inpaint_exact", s2x)):
        for k, v in s1.items():
            check(torch.equal(st["net1." + k], v),
                  f"{name}: net1 differs from stage 1's checkpoint at {k}")
        moved[name] = _max_change(st, init2, "net2.")
    for k, v in s2.items():
        # stage 3 runs net2 in train mode (its statistics move)
        if "running_" not in k or k.startswith("net1."):
            check(torch.equal(s3["depth_and_inpaint." + k], v),
                  f"full: changed depth_and_inpaint.{k}")
    moved["full"] = _max_change(s3, start("genre_full_model"), "refine_net.")
    moved["joint"] = {p: _max_change(s4, s3, p) for p in (
        "depth_and_inpaint.net1.", "depth_and_inpaint.net2.",
        "refine_net.")}
    check(all(v > 0 for k, v in moved.items() if k != "joint")
          and all(v > 0 for v in moved["joint"].values()),
          f"moved {moved}")
    log(f"[shapenet] largest weight change: {json.dumps(moved)}; net1 of "
        f"both stage-2 runs equal to stage 1's checkpoint and stage 3's "
        f"depth_and_inpaint to stage 2's, statistics included")
    runs["moved"] = moved
    runs["loader"] = loader_times(root, cls)
    runs["read_png"] = png_read_times(root, work)
    # phase 13 trains on the tree and starts MarrNet from stage 1
    runs["tree"] = root
    runs["marrnet1"] = os.path.join(work, "marrnet1_shapenet.pt")
    os.replace(ck(d1), runs["marrnet1"])
    for top in (logdir, logdir + "_exact"):
        shutil.rmtree(top, ignore_errors=True)
    return runs


def loader_times(root, cls):
    """MarrNet-1's samples from the tree (files) and from phase 7's
    scenes (memory), on this host's CPU: ms a sample on one thread, read
    alone and read plus ``preprocess``; ms a batch of 4 from the
    ``DataLoader`` on 4 threads (median of batches 2..5), the rate a
    training run's loader delivers at most."""
    from genre_shapehd_tpu_torch.core.registry import get_dataset, get_model
    from genre_shapehd_tpu_torch.data.loader import DataLoader
    from genre_shapehd_tpu_torch.models.base import default_opt
    opt = default_opt(device="cpu", data_root=root, classes=cls,
                      pred_depth_minmax=True,
                      procedural_length=TRAIN["batch"] * TRAIN["steps"])
    model = get_model("marrnet1")(opt)
    out = {}
    for name in ("shapenet", "procedural"):
        ds = get_dataset(name)(opt, "train", model=model)
        per = {}
        for step, preprocess in (("read", None), ("read_preprocess",
                                                  model.preprocess)):
            ds.preprocess = preprocess
            t0 = time.perf_counter()
            for i in range(8):
                ds[i]
            per[step] = (time.perf_counter() - t0) / 8 * 1e3
        times, t0 = [], time.perf_counter()
        for batch in DataLoader(ds, TRAIN["batch"], 4):
            times.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            if len(times) == 5:
                break
        out[name] = dict(sample_ms=per,
                         batch_ms=statistics.median(times[1:]) * 1e3)
    log(f"[shapenet] MarrNet-1's loader on this host's CPU: "
        f"{json.dumps(out)} (ms a sample on one thread, read alone and "
        f"with preprocess; ms a batch of 4 on 4 threads)")
    return out


def png_read_times(root, work):
    """``read_png`` on this host's CPU, ms a file (median of 5), for a
    480² 8-bit RGB and a 480² 16-bit depth map (the tree's first view,
    nearest-upsampled) under each row encoding: none (this package's
    default writer), Sub on every row (cv2's), libpng's adaptive choice
    (a renderer's; Average and Paeth rows decode by anti-diagonals) and
    Paeth on every row."""
    from genre_shapehd_tpu_torch.data.png import read_png, write_png
    view = sorted(glob.glob(os.path.join(root, "*", "*", "*_rgb.png")))[0]
    out = {}
    for kind, suffix in (("rgb8", "_rgb.png"), ("depth16", "_depth.png")):
        img = read_png(view[:-len("_rgb.png")] + suffix)
        rows = np.arange(480) * img.shape[0] // 480
        cols = np.arange(480) * img.shape[1] // 480
        img = img[rows][:, cols]
        for filters in (0, 1, "adaptive", 4):
            path = os.path.join(work, f"read_png_{kind}_{filters}.png")
            write_png(path, img, filters)
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                got = read_png(path)
                times.append((time.perf_counter() - t0) * 1e3)
            check(np.array_equal(got, img), f"read_png {kind} {filters}")
            out[f"{kind}_{filters}"] = statistics.median(times)
            os.remove(path)
    log(f"[shapenet] read_png on this host's CPU, ms a 480² file by row "
        f"encoding (0 none, 1 Sub as cv2 writes, adaptive as libpng "
        f"chooses, 4 Paeth): {json.dumps(out)}")
    return out


#: phase 13: the steps of each training script's run, the photos of each
#: test script's, and the steps of the training log
SCRIPTS = dict(steps=4, photos=8, trainrun_steps=12)
#: K3's shapes in phase 13 (``[launches]``' keys): MarrNet-2's decoder
#: and the WGAN-GP generator at batch 4; at cli.test's batch 1, the
#: decoder and GenRe's dec6
K3_DEC, K3_GEN = "4x32x64x64x64", "4x64x64x64x64"
K3_DEC1, K3_DEC6_1 = "1x32x64x64x64", "1x40x64x64x64"


def start_script(script, args, env):
    """``bash scripts_torch/<script> <args>`` as a user runs it, in a
    process of its own with ``python`` this interpreter: (the process,
    its start time)."""
    bindir = os.path.join(ROOT, "build", "chip_smoke_bin")
    os.makedirs(bindir, exist_ok=True)
    shim = os.path.join(bindir, "python")
    with open(shim, "w") as f:
        f.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    os.chmod(shim, 0o755)
    proc = subprocess.Popen(
        ["bash", os.path.join(ROOT, "scripts_torch", script)] + args,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        stdin=subprocess.DEVNULL,
        env=dict(os.environ, **env,
                 PATH=bindir + os.pathsep + os.environ["PATH"]))
    return script, proc, time.perf_counter()


def finish_script(started, timeout=600):
    """Waits for a :func:`start_script` process: (its stdout, its stderr,
    its wall seconds, its ``[launches]`` line as a dict).  Fails unless
    it exits 0."""
    script, proc, t0 = started
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"{script} exited {proc.returncode}; stdout "
          f"ends {out[-2000:]}; stderr ends {err[-3000:]}")
    line = [ln for ln in out.splitlines() if ln.startswith("[launches] ")]
    check(len(line) == 1, f"{script}: no [launches] line")
    return out, err, seconds, json.loads(line[0][11:])


def phase_scripts(work, tree, marrnet1_ckpt, genre_ckpt, photos):
    """The ShapeHD workflow as ``scripts_torch/`` runs it, each script in
    a subprocess: MarrNet-2 and WGAN-GP on phase 9's tree, ShapeHD on
    both their checkpoints, MarrNet on phase 9's MarrNet-1 and MarrNet-2;
    then the three test scripts on phase 3's photos and the training log
    of ``tools/trainrun_artifact_torch.py``.  Returns each run's numbers
    and launches."""
    import torch
    from genre_shapehd_tpu_torch.core.checkpoint import load_checkpoint
    from genre_shapehd_tpu_torch.core.registry import get_model
    from genre_shapehd_tpu_torch.models.base import default_opt
    from genre_shapehd_tpu_torch.train.state import adam_moments
    t_phase = time.perf_counter()
    cls, steps = SHAPENET["classes"][0], SCRIPTS["steps"]
    logdir = os.path.join(work, "scripts")
    vis_param = os.path.join(work, "vis_param_0.9.json")
    with open(vis_param, "w") as f:
        json.dump({"voxel": {"isosurf_thres": 0.9}}, f)
    extra = ["--epoch", "1", "--epoch_batches", str(steps),
             "--eval_batches", "1", "--vis_batches_vali", "1",
             "--vis_param_f", vis_param, "--logdir", logdir, "--data_root",
             tree, "--dtype", "bfloat16", "--log_batch"]
    try:
        import tensorboardX                                   # noqa: F401
        tensorboard = True
    except ImportError:
        tensorboard = False
    run = lambda net, lr, sfx="": os.path.join(              # noqa: E731
        logdir, f"{net}_shapenet_{lr}_{cls}{sfx}", "0")
    ck = lambda d: os.path.join(d, "checkpoint.pt")          # noqa: E731
    dA, dB, dC, dD = (run("marrnet2", 0.001), run("wgangp", 0.0001),
                      run("shapehd", 0.0001, "_w_ganloss0.001"),
                      run("marrnet", 0.0001))
    # every model reads the canonical voxels: the chair's train view
    # without voxels is left out
    n_tr, n_va = SHAPENET["train"][0] - 1, SHAPENET["vali"][0]
    # (run, script, variables, run dir, a loss term, K3 by shape): a
    # train step and the eval batch run MarrNet-2's decoder once, ShapeHD's
    # eval twice (its frozen copy), WGAN-GP's step the generator twice;
    # ShapeHD's step runs its critic's stem backward on K3 too, at the
    # generator's shape (64 channels at 64³)
    stages = (
        ("marrnet2", "train_marrnet2.sh", {}, dA, "loss",
         {K3_DEC: steps + 1}),
        ("wgangp", "train_wgangp.sh", {}, dB, "err_d_gp",
         {K3_GEN: 2 * steps + 1}),
        ("shapehd", "finetune_shapehd.sh",
         {"MARRNET2": ck(dA), "GAN": ck(dB)}, dC, "gan",
         {K3_DEC: steps + 2, K3_GEN: steps}),
        ("marrnet", "finetune_marrnet.sh",
         {"MARRNET1": marrnet1_ckpt, "MARRNET2": ck(dA)}, dD, "loss",
         {K3_DEC: steps + 1}))
    # two runs at a time, each pair independent: marrnet2 beside wgangp,
    # then shapehd beside marrnet (each of these reads marrnet2's
    # checkpoint); their step and data times are taken beside the other
    # run, and phase 8 has the family's alone
    done = {}
    for pair in (stages[:2], stages[2:]):
        started = [start_script(script, [cls] + extra, env)
                   for _, script, env, _, _, _ in pair]
        try:
            for stage, st in zip(pair, started):
                done[stage[0]] = finish_script(st)
        finally:
            for _, proc, _ in started:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    runs = {}
    for name, script, env, d, metric, k3 in stages:
        out, err, seconds, rep = done[name]
        beside = {"marrnet2": "wgangp", "wgangp": "marrnet2",
                  "shapehd": "marrnet", "marrnet": "shapehd"}[name]
        counts = f"[setup] {n_tr} train / {n_va} vali samples"
        check(counts in out, f"{name}: {counts!r} not in its output")
        check(os.path.isfile(ck(d)), f"{name}: no {ck(d)}")
        if tensorboard:
            check(bool(glob.glob(os.path.join(d, "tensorboard",
                                              "events.out.*"))),
                  f"{name}: no TensorBoard event file")
        else:
            check(f"{script}: tensorboardX is not installed; leaving out "
                  "--tensorboard" in err.splitlines(),
                  f"{name}: the script did not say it left out "
                  f"--tensorboard: {err[-1000:]}")
        launches = rep["launches"]
        want = {k: 0 for k in launches}
        want["deconv_final"] = sum(k3.values())
        # K6 runs ShapeHD's frozen critic once each way a step and scores
        # its eval batch's two grids; WGAN-GP's critic trains in a step
        # and reads bf16 G(z) in the eval batch, so it keeps nn.Conv3d (as
        # phase 8)
        if name == "shapehd":
            want.update(critic_stem=steps + 2, critic_stem_backward=steps,
                        critic_stem_mask=steps,
                        critic_conv=K7_PER_CRITIC * (steps + 2),
                        critic_conv_backward=K7_PER_CRITIC * steps)
        check(launches == want and rep["deconv_final_shapes"] == k3,
              f"{name}: launches {rep}, want {want} at {k3}")
        rows = _csv_rows(os.path.join(d, "batch_loss.csv"))
        check(len(rows) == steps, f"{name}: {len(rows)} logged steps")
        terms = [k for k in rows[0] if k not in (
            "epoch", "batch", "size", "batch_time", "data_time")]
        check(metric in terms and all(np.isfinite(float(row[k]))
                                      for row in rows for k in terms),
              f"{name}: loss terms {terms} not all finite")
        times = [float(row["batch_time"]) for row in rows]
        data = [float(row["data_time"]) for row in rows]
        runs[name] = dict(
            step_ms=statistics.median(times[2:]) * 1e3,
            data_ms=statistics.median(data[2:]) * 1e3,
            peak_gib=rep["peak_gib"], seconds=seconds,
            launches=launches, k3_shapes=rep["deconv_final_shapes"],
            loss=[round(float(r["loss"]), 4) for r in rows])
        log(f"[scripts] bash scripts_torch/{script} {cls} (+ {len(extra)} "
            f"args): {n_tr} train / {n_va} vali views; {steps} steps of "
            f"batch 4, bf16, beside {beside}'s run; loss "
            f"{runs[name]['loss']}; step {runs[name]['step_ms']:.1f} ms, "
            f"data {runs[name]['data_ms']:.1f} ms (medians of steps "
            f"3..{steps}; first {times[0] * 1e3:.0f} ms); peak memory "
            f"{rep['peak_gib']} GiB; {seconds:.1f} s wall (process "
            f"start, set-up, checkpoint included); K3 by shape "
            f"{rep['deconv_final_shapes']}; run directory "
            f"{os.path.relpath(d, logdir)}")

    def nets(d):
        payload = load_checkpoint(ck(d))
        return payload, {n: _flat_net(net) for n, net in
                         zip(payload["net_names"], payload["nets"])}

    def start(net, **kw):
        model = get_model(net)(default_opt(device="cpu", **kw))
        model.init_state(0)
        return {n: {k: v for k, v in m.state_dict().items()
                    if not k.endswith("num_batches_tracked")}
                for n, m in model.net_modules().items()}

    # which nets moved, and the hand-offs: ShapeHD's frozen copy and
    # critic, MarrNet's MarrNet-1 bit for bit the checkpoints they came
    # from (statistics included)
    _, a = nets(dA)
    payload, w = nets(dB)
    check([adam_moments(o)[0] for o in payload["optimizers"]]
          == [steps, steps], f"wgangp: Adam counts {payload['optimizers']}")
    w_init = start("wgangp", canon_voxel=True)
    moved = {"marrnet2": _max_change(a["net"], start(
        "marrnet2", canon_sup=True)["net"], ""),
        "wgangp": {n: _max_change(w[n], w_init[n], "")
                   for n in ("net_g", "net_d")}}
    _, c = nets(dC)
    for key, want in (("net_noft", a["net"]), ("net_d", w["net_d"])):
        for k, v in want.items():
            check(torch.equal(c[key][k], v), f"shapehd changed {key}.{k}")
    moved["shapehd"] = _max_change(c["net"], a["net"], "")
    _, m = nets(dD)
    for k, v in _net_state(marrnet1_ckpt).items():
        check(torch.equal(m["net"]["marrnet1." + k], v),
              f"marrnet changed marrnet1.{k}")
    moved["marrnet"] = _max_change(
        m["net"], {"marrnet2." + k: v for k, v in a["net"].items()},
        "marrnet2.")
    check(all(v > 0 for v in (moved["marrnet2"], moved["shapehd"],
                              moved["marrnet"], *moved["wgangp"].values())),
          f"moved {moved}")
    log(f"[scripts] largest weight change: {json.dumps(moved)}; ShapeHD's "
        f"net_noft and net_d equal to MARRNET2's and GAN's checkpoints, "
        f"MarrNet's marrnet1 to MARRNET1's, bit for bit")
    runs["moved"] = moved

    # the test scripts on phase 3's photos, batch 1 (the scripts' own)
    n = SCRIPTS["photos"]
    pick = f"0[0-{n - 1}]"
    env = {"RGB": os.path.join(photos, f"{pick}_rgb.png"),
           "MASK": os.path.join(photos, f"{pick}_silhouette.png")}
    out_dir = os.path.join(work, "test_scripts")
    tests = (
        ("test_shapehd.sh", "shapehd", {"NET_FILE": ck(dC),
                                        "MARRNET1_FILE": marrnet1_ckpt},
         {K3_DEC1: 2 * n}, {"critic_stem": 2 * n,
                            "critic_conv": 2 * K7_PER_CRITIC * n},
         "11_pred_voxel_noft.obj"),
        ("test_marrnet.sh", "marrnet", {"NET_FILE": ck(dD)},
         {K3_DEC1: n}, {}, "12_pred_voxel.obj"),
        ("test_genre.sh", "genre_full_model", {"NET_FILE": genre_ckpt},
         {K3_DEC6_1: n}, {"render_stage1": n, "render_stage2_scan": n},
         "pred_voxel.obj"))
    # the three at once: each is its own process, and none is timed
    t_tests = time.perf_counter()
    started = [start_script(script, [
        "--output_dir", out_dir, "--dtype", "bfloat16", "--vis_param_f",
        vis_param], {**env, **var}) for script, _, var, _, _, _ in tests]
    try:
        done = [finish_script(st) for st in started]
    finally:
        for _, proc, _ in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for (script, net, var, k3, other, mesh), (_, _, seconds, rep) in zip(
            tests, done):
        want = {k: other.get(k, 0) for k in rep["launches"]}
        want["deconv_final"] = sum(k3.values())
        check(rep["launches"] == want and rep["deconv_final_shapes"] == k3,
              f"{script}: launches {rep}, want {want} at {k3}")
        d = f"{out_dir}_{net}"            # --suffix '{net}'
        npz = sorted(glob.glob(os.path.join(d, "batch*.npz")))
        check(len(npz) == n, f"{script}: {len(npz)} .npz files in {d}")
        for f in npz:
            with np.load(f) as z:
                check(z["pred_voxel"].shape == (1, 128, 128, 128)
                      and bool(np.isfinite(z["pred_voxel"]).all()),
                      f"{script}: {f} pred_voxel")
        meshes = glob.glob(os.path.join(d, "batch*", f"*{mesh}"))
        check(len(meshes) == n, f"{script}: {len(meshes)} *{mesh}")
        runs[script] = dict(seconds=seconds, launches=rep["launches"],
                            k3_shapes=rep["deconv_final_shapes"])
        log(f"[scripts] bash scripts_torch/{script}: {n} photos at batch "
            f"1, bf16, {seconds:.1f} s wall beside the other two (process "
            f"start, meshes at 0.9 included); launches {rep['launches']}, "
            f"K3 by shape {rep['deconv_final_shapes']}; {len(npz)} .npz, "
            f"{len(meshes)} "
            f"*{mesh}")
        shutil.rmtree(d, ignore_errors=True)
    log(f"[scripts] the three test scripts together: "
        f"{time.perf_counter() - t_tests:.1f} s wall")

    # the full-scale training log, as its tool writes it
    md = os.path.join(work, "TRAINRUN_torch.md")
    k = SCRIPTS["trainrun_steps"]
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools",
                                      "trainrun_artifact_torch.py"),
         "--steps", str(k), "--out", md], cwd=ROOT, capture_output=True,
        text=True, timeout=600, stdin=subprocess.DEVNULL)
    seconds = time.perf_counter() - t0
    check(res.returncode == 0, f"trainrun_artifact_torch.py exited "
          f"{res.returncode}: {res.stderr[-3000:]}")
    with open(md) as f:
        text = f.read()
    series = json.loads(text.split("```json\n")[1].split("\n```")[0])
    check(len(series["losses"]) == k
          and all(np.isfinite(series["losses"])), f"trainrun {series}")
    check(torch.cuda.get_device_name(0) in text, "trainrun: no device name")
    runs["trainrun"] = dict(seconds=seconds, **series)
    log(f"[scripts] tools/trainrun_artifact_torch.py --steps {k}: GenRe, "
        f"batch 4, 256^2 -> 128^3, bf16, synthetic; losses "
        f"{series['losses']}; median step {series['step_time_median_s']} s "
        f"(steps 3..{k}); {seconds:.1f} s wall")
    for line in text.splitlines():
        if line.startswith("- "):
            log(f"[scripts] trainrun markdown: {line[2:]}")
    shutil.rmtree(logdir, ignore_errors=True)
    runs["seconds"] = time.perf_counter() - t_phase
    log(f"[scripts] phase 13: {runs['seconds']:.1f} s wall")
    return runs


def phase_exact_render(device, flush):
    """The exact renderer (``ops.render_spherical``: F.grid_sample along
    each ray) against K1 + K2 (``ops.render_spherical_fast``) at full
    width, batch 4, on four of phase 7's solids (1 - 1e-4 inside, 1e-4
    outside), in float32 and bf16 (the exact one on the volume cast to
    bf16, K1 + K2 computing in bf16): within the JAX package's bounds
    between the two formulations (tests/test_render_fast.py:47-48), a
    mean difference below 0.01 and a maximum below 0.1; their times (CUDA
    events, median of 25, L2 flushed) and the exact one's peak memory."""
    import torch
    from genre_shapehd_tpu_torch import ops
    from genre_shapehd_tpu_torch.data import procedural
    from genre_shapehd_tpu_torch.models.base import default_opt
    b, r, z = TRAIN["batch"], MAIN["r"], MAIN["z"]
    ds = procedural.Dataset(default_opt(
        device="cpu", procedural_length=TRAIN["batch"] * TRAIN["steps"]),
        "train")
    # the solids in the frame the model renders them (train frame)
    vox = np.stack([np.flip(np.transpose(ds._raw(i)["voxel"], (0, 2, 1)), 2)
                    for i in range(b)])
    vox = torch.from_numpy(np.where(vox > 0.5, 1 - 1e-4, 1e-4).astype(
        np.float32)).to(device)
    rows = {}
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        exact_in = vox.to(dt)
        exact = lambda: ops.render_spherical(exact_in, r, z)  # noqa: E731
        fast = lambda: ops.render_spherical_fast(              # noqa: E731
            vox, r, z, compute_dtype=dt)
        with torch.no_grad():
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            e = exact()
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            f = fast()
            diff = (e.float() - f.float()).abs()
            d_mean, d_max = float(diff.mean()), float(diff.max())
            ms_exact, ms_fast = time_ms(exact, flush), time_ms(fast, flush)
        check(e.shape == f.shape == (b, r, r) and d_mean < 0.01
              and d_max < 0.1, f"exact vs K1 + K2, {name}: mean {d_mean}, "
              f"max {d_max} (bounds 0.01, 0.1)")
        rows[name] = dict(mean_abs_diff=d_mean, max_abs_diff=d_max,
                          exact_ms=ms_exact, k1_k2_ms=ms_fast,
                          exact_peak_gib=peak)
        log(f"[exact] {name}, batch {b}, {vox.shape[1]}^3 -> {r}^2 x {z} "
            f"samples, four of phase 7's solids: exact renderer vs K1 + K2 "
            f"mean {d_mean:.3g}, max {d_max:.3g} "
            f"(bounds 0.01, 0.1); exact {ms_exact:.3f} ms, K1 + K2 "
            f"{ms_fast:.3f} ms (events, median of 25, L2 flushed); the exact "
            f"renderer's peak memory {peak:.2f} GiB above its input")
    return rows


def phase_family_profile(device, runs):
    """torch.profiler over one train step of WGAN-GP and of ShapeHD, after
    two warm ones, on procedural scenes: device time per span
    (``wgangp.*``, ``shapehd.*``, ``marrnet.*``) and the idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from genre_shapehd_tpu_torch.core.registry import get_dataset, get_model
    from genre_shapehd_tpu_torch.data.loader import collate
    from genre_shapehd_tpu_torch.models.base import default_opt
    out = {}
    for name, net, kw in (("wgangp", "wgangp", dict(canon_voxel=True)),
                          ("shapehd", "shapehd", dict(canon_sup=True,
                                                      w_gan_loss=1e-3))):
        opt = default_opt(device="cuda", dtype="bfloat16", lr=1e-4,
                          batch_size=TRAIN["batch"],
                          procedural_length=TRAIN["batch"] * TRAIN["steps"],
                          **kw)
        model = get_model(net)(opt)
        model.init_state(0)
        ds = get_dataset("procedural")(opt, "train", model=model)
        batch = model.device_batch(collate([ds[i] for i in range(4)]))
        for _ in range(2):
            model.train_step(batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.train_step(batch)
            torch.cuda.synchronize()
        log(f"[family profile] {name} step:")
        out[name] = device_profile(prof, 1, runs[name]["step_ms"],
                                   OWN_KERNELS,
                                   prefixes=("wgangp.", "shapehd.",
                                             "marrnet."))
        del model, batch
        torch.cuda.empty_cache()
    return out


def _flat_net(net):
    """A checkpoint's net as {state_dict key: tensor}."""
    from genre_shapehd_tpu_torch.core.convert import jax_to_torch
    return {k: v for k, v in jax_to_torch(
        net["params"], net.get("batch_stats") or {}).items()
        if not k.endswith("num_batches_tracked")}


def phase_train_profile(device, runs):
    """torch.profiler over one training step of each kind, after two warm
    ones, on the synthetic batch: device time per stage (the forward's
    ``genre.*`` spans, then loss, backward and optimizer)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from genre_shapehd_tpu_torch.core.registry import get_dataset, get_model
    from genre_shapehd_tpu_torch.data.loader import collate
    from genre_shapehd_tpu_torch.models.base import default_opt
    out = {}
    for name in ("stage3", "joint"):
        opt = default_opt(device="cuda", dtype="bfloat16", lr=1e-4,
                          surface_weight=10.0, joint_train=name == "joint",
                          batch_size=TRAIN["batch"], synthetic_length=4)
        model = get_model("genre_full_model")(opt)
        model.init_state(0)
        ds = get_dataset("synthetic")(opt, "train", model=model)
        batch = model.device_batch(collate([ds[i] for i in range(4)]))
        for _ in range(2):
            model.train_step(batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.train_step(batch)
            torch.cuda.synchronize()
        log(f"[train profile] {name} step:")
        out[name] = device_profile(prof, 1, runs[name]["step_ms"],
                                   OWN_KERNELS)
        del model, batch
        torch.cuda.empty_cache()
    return out


#: phase 10: the data-parallel runs (global batch, steps); the step
#: profiled on rank 0 (the last: its time is not in the medians)
DP = dict(batch=4, steps=4, gan_steps=3)
#: the hand-written kernels by the names the profiler gives them
KERNEL_NAMES = {"render_stage1": "stage1_kernel",
                "render_stage2_scan": "slab_scan_kernel",
                "render_stage2_samples": "slab_samples_kernel",
                "deconv_final": "deconv_final_"}


def _dp_run(work, name, nproc, argv):
    """One ``cli.train`` run of phase 10 as a subprocess: without
    --multihost (``nproc`` 0) or under ``torch.distributed.run`` with
    ``nproc`` ranks.  Returns its losses, step times, rank 0's profile
    and peak memory, and each rank's parameter hash and peak memory."""
    logdir = os.path.join(work, "dp", name)
    # float32 with TF32 off: the subprocesses do not see main()'s switches
    env = dict(os.environ, NVIDIA_TF32_OVERRIDE="0", OMP_NUM_THREADS="4")
    if nproc:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(nproc), "-m",
               "genre_shapehd_tpu_torch.cli.train", "--multihost"]
    else:
        cmd = [sys.executable, "-m", "genre_shapehd_tpu_torch.cli.train"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd + argv + ["--logdir", logdir], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    seconds = time.perf_counter() - t0
    check(res.returncode == 0, f"[dp] {name} exited {res.returncode}:\n"
          f"{res.stdout[-4000:]}\n{res.stderr[-4000:]}")
    # each rank's last line (the ranks share one stdout, so a line may
    # start behind another rank's progress bar)
    ranks = {int(m[1]): dict(sha1=m[2], peak_gib=float(m[3] or "nan"),
                             launches=json.loads(m[4]))
             for m in re.finditer(
                 r"\[dp\] rank (\d+) of \d+: parameters and buffers sha1 "
                 r"([0-9a-f]+)(?:; peak device memory ([\d.]+) GiB)?; "
                 r"kernel launches (\{[^}]*\})", res.stdout)}
    check(sorted(ranks) == list(range(nproc)), f"[dp] {name}: rank lines "
          f"{sorted(ranks)} of {nproc}")
    d = glob.glob(os.path.join(logdir, "*", "0"))[0]
    rows = _csv_rows(os.path.join(d, "batch_loss.csv"))
    with open(os.path.join(d, "profile_step.json")) as f:
        prof = json.load(f)
    times = [float(r["batch_time"]) for r in rows]
    launches = {k: sum(v["launches"] for n, v in prof["kernels"].items()
                       if sub in n) for k, sub in KERNEL_NAMES.items()}
    shutil.rmtree(logdir, ignore_errors=True)
    terms = [k for k in rows[0] if k not in ("epoch", "batch", "size",
                                             "batch_time", "data_time")]
    return dict(loss=[float(r["loss"]) for r in rows],
                terms=[{k: float(r[k]) for k in terms} for r in rows],
                step_ms=statistics.median(times[1:-1]) * 1e3,
                seconds=seconds, ranks=ranks, launches=launches,
                peak_gib=prof["peak_memory_gib"] or float("nan"),
                all_reduce=prof["all_reduce_grads"],
                spans=prof.get("spans", {}),
                k3_slabs=prof.get("k3_slabs", {}),
                profiled_ms=prof["wall_ms"])


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def phase_dp(work):
    """Data parallelism: ``cli.train --multihost`` under
    ``torch.distributed.run``, float32 (no --dtype; TF32 off by
    NVIDIA_TF32_OVERRIDE=0), full width, global batch 4, synthetic data.
    GenRe's joint step (4 steps) in one process, on 1 rank over NCCL and
    on 2 ranks sharing card 0 over gloo (NCCL refuses two ranks on one
    card); WGAN-GP --canon_voxel (2 steps) in one process and on 2 ranks;
    the joint step in bf16 on 2 ranks for its step time.  Fails when a
    rank exits non-zero, the ranks' parameter hashes differ, a loss is
    off the one-process run's (relative: step 1 by 1e-4, WGAN-GP's,
    which holds the gradient penalty, by 2e-3; steps 2 and 3 by 1e-3;
    the 4th joint step is logged) or a kernel that the one-process run
    launches is missing from rank 0's profiled step or from a rank's
    wrapper counts."""
    import torch
    torch.cuda.empty_cache()
    b, steps = DP["batch"], DP["steps"]
    common = ["--dataset", "synthetic", "--batch_size", str(b),
              "--synthetic_length", str(b), "--epoch", "1",
              "--eval_batches", "0", "--workers", "4", "--log_time",
              "--log_batch", "--manual_seed", "0", "--save_net", "0",
              "--vis_batches_vali", "0", "--lr", "1e-4"]
    joint = common + ["--net", "genre_full_model", "--joint_train",
                      "--pred_depth_minmax", "--surface_weight", "10",
                      "--epoch_batches", str(steps), "--profile_step",
                      str(steps)]
    gan = common + ["--net", "wgangp", "--canon_voxel", "--epoch_batches",
                    str(DP["gan_steps"]), "--profile_step",
                    str(DP["gan_steps"])]
    runs = {
        "joint_1proc": _dp_run(work, "joint_1proc", 0,
                               joint + ["--device", "cuda"]),
        "joint_nccl_1rank": _dp_run(work, "joint_nccl_1rank", 1, joint + [
            "--device", "cuda", "--dist_backend", "nccl"]),
        "joint_gloo_2ranks": _dp_run(work, "joint_gloo_2ranks", 2, joint + [
            "--device", "cuda:0", "--dist_backend", "gloo"]),
        "wgangp_1proc": _dp_run(work, "wgangp_1proc", 0,
                                gan + ["--device", "cuda"]),
        "wgangp_gloo_2ranks": _dp_run(work, "wgangp_gloo_2ranks", 2, gan + [
            "--device", "cuda:0", "--dist_backend", "gloo"]),
        "joint_bf16_gloo_2ranks": _dp_run(
            work, "joint_bf16_gloo_2ranks", 2, joint + [
                "--device", "cuda:0", "--dist_backend", "gloo", "--dtype",
                "bfloat16"]),
    }
    for name, r in runs.items():
        hashes = {v["sha1"] for v in r["ranks"].values()}
        check(len(hashes) <= 1, f"[dp] {name}: the ranks' parameters "
              f"differ: {r['ranks']}")
        log(f"[dp] {name}: losses {r['loss']}; step {r['step_ms']:.1f} ms "
            f"(median of steps 2..{len(r['loss']) - 1}; the last one "
            f"profiled, {r['profiled_ms']:.1f} ms); peak memory "
            f"{r['peak_gib']:.2f} GiB (rank 0, up to its profiled step)"
            + "".join(f"; rank {k} {v['peak_gib']:.2f} GiB at its end"
                      for k, v in sorted(r["ranks"].items()))
            + f"; parameter sha1 {sorted(hashes)}; launches on rank 0 "
            f"(profiled step) {json.dumps(r['launches'])}; launches "
            f"counted by each rank's wrappers over its run "
            f"{json.dumps({k: v['launches'] for k, v in r['ranks'].items()})}"
            f"; gradient "
            f"all-reduce {json.dumps(r['all_reduce'])}; "
            f"{r['seconds']:.1f} s wall")
    for ref_name, names in (("joint_1proc", ("joint_nccl_1rank",
                                             "joint_gloo_2ranks")),
                            ("wgangp_1proc", ("wgangp_gloo_2ranks",))):
        ref = runs[ref_name]
        for name in names:
            got = runs[name]
            check(len(got["loss"]) == len(ref["loss"]),
                  f"[dp] {name}: {len(got['loss'])} steps")
            rel = [{k: _rel(g[k], r[k]) for k in r}
                   for g, r in zip(got["terms"], ref["terms"])]
            # step 1's loss within 1e-4; WGAN-GP's holds the gradient
            # penalty, 2e-3: the critic's LeakyReLU kinks move a sample's
            # input-gradient norm by 2.6e-4 under a 1e-7 change of its
            # input (tests/test_torch_port_dist.py)
            bound1 = 2e-3 if name.startswith("wgangp") else 1e-4
            # steps 2 and 3 within 1e-3; a later step is logged: float32
            # runs part at about 10x a step from there (4 joint steps:
            # 1.3e-5, 1.8e-4, 2.5e-3), while the same steps in float64
            # agree to 1e-8 (tests/test_torch_port_dist.py)
            later = max([r["loss"] for r in rel[1:3]], default=0.0)
            got.update(rel_loss=[r["loss"] for r in rel])
            terms = {k: float(f"{v:.3g}") for k, v in rel[0].items()}
            log(f"[dp] {name} vs {ref_name}: relative loss difference by "
                f"step {[float(f'{r:.3g}') for r in got['rel_loss']]} "
                f"(step 1 bound {bound1}, steps 2-3 1e-3); step 1 by term "
                f"{json.dumps(terms)}")
            check(rel[0]["loss"] <= bound1 and later <= 1e-3,
                  f"[dp] {name}: losses {got['terms']} vs {ref['terms']}")
            missing = [k for k, n in ref["launches"].items()
                       if n and not got["launches"][k]]
            check(not missing, f"[dp] {name}: {missing} not launched on "
                  f"rank 0 (the one-process run launched them)")
            # each rank's wrappers counted the launches of its whole run
            for r, v in got["ranks"].items():
                idle = [k for k, n in ref["launches"].items()
                        if n and not v["launches"].get(k)]
                check(not idle, f"[dp] {name}: rank {r}'s wrappers "
                      f"counted no launch of {idle}: {v['launches']}")
    joint_k = runs["joint_gloo_2ranks"]["launches"]
    check(all(joint_k[k] for k in KERNEL_NAMES),
          f"[dp] the joint step on 2 ranks launched {joint_k}")
    check(runs["wgangp_gloo_2ranks"]["launches"]["deconv_final"] > 0,
          "[dp] WGAN-GP on 2 ranks launched no K3")
    return runs


def phase_sp(work, dp):
    """Spatial parallelism: ``cli.train --multihost --sp 2`` on 2 gloo
    ranks sharing card 0 (dp 1 x sp 2), GenRe's joint step with phase
    10's flags and seed (float32, TF32 off, full width, global batch 4,
    4 steps): each rank runs the 2D nets on the whole batch and the 3D
    U-Net on its half of the Z axis.  Fails when a rank exits non-zero,
    the ranks' parameter hashes differ, a loss is off phase 10's
    one-process run (relative: step 1 by 1e-4, steps 2 and 3 by 1e-3;
    step 4 logged), rank 0's profiled step lacks a kernel of the
    one-process run, K3 at dec6's slab shape (``DEC6_SLAB``: 4 x 40 x
    64 x 64 x 40 planes, positions 1 .. 32) or a halo or gather span."""
    b, steps = DP["batch"], DP["steps"]
    argv = ["--dataset", "synthetic", "--batch_size", str(b),
            "--synthetic_length", str(b), "--epoch", "1",
            "--eval_batches", "0", "--workers", "4", "--log_time",
            "--log_batch", "--manual_seed", "0", "--save_net", "0",
            "--vis_batches_vali", "0", "--lr", "1e-4", "--net",
            "genre_full_model", "--joint_train", "--pred_depth_minmax",
            "--surface_weight", "10", "--epoch_batches", str(steps),
            "--profile_step", str(steps), "--device", "cuda:0",
            "--dist_backend", "gloo", "--sp", "2"]
    run = _dp_run(work, "joint_sp2_gloo_2ranks", 2, argv)
    ref = dp["joint_1proc"]
    hashes = {v["sha1"] for v in run["ranks"].values()}
    check(len(hashes) == 1, f"[sp] the ranks' parameters differ: "
          f"{run['ranks']}")
    check(len(run["loss"]) == len(ref["loss"]), f"[sp] {len(run['loss'])} "
          f"steps")
    rel = [{k: _rel(g[k], r[k]) for k in r}
           for g, r in zip(run["terms"], ref["terms"])]
    run["rel_loss"] = [r["loss"] for r in rel]
    later = max(r["loss"] for r in rel[1:3])
    missing = [k for k, n in ref["launches"].items()
               if n and not run["launches"][k]]
    slab = (f"{DEC6_SLAB['b']}x{DEC6_SLAB['cin']}x{DEC6_SLAB['s']}x"
            f"{DEC6_SLAB['s']}x{DEC6_SLAB['z']} z1+{DEC6_SLAB['zs']}")
    spans, k3_spans = run["spans"], run["k3_slabs"]
    halo = spans.get("sp.halo", {"calls": 0, "cpu_ms": 0.0})
    gather = spans.get("sp.gather", {"calls": 0, "cpu_ms": 0.0})
    log(f"[sp] joint_sp2_gloo_2ranks (dp 1 x sp 2 on card 0): losses "
        f"{run['loss']}; relative difference from joint_1proc by step "
        f"{[float(f'{r:.3g}') for r in run['rel_loss']]} (step 1 bound "
        f"1e-4, steps 2-3 1e-3); step 1 by term "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in rel[0].items()})}"
        f"; step {run['step_ms']:.1f} ms (median of steps 2..{steps - 1}; "
        f"the last one profiled, {run['profiled_ms']:.1f} ms); peak memory "
        f"{run['peak_gib']:.2f} GiB (rank 0, up to its profiled step)"
        + "".join(f"; rank {k} {v['peak_gib']:.2f} GiB at its end"
                  for k, v in sorted(run["ranks"].items()))
        + f"; parameter sha1 {sorted(hashes)}; launches on rank 0 "
        f"(profiled step) {json.dumps(run['launches'])}; K3 on slabs "
        f"{json.dumps(k3_spans)}; sp.halo {halo['calls']} calls "
        f"{halo['cpu_ms']:.1f} ms, sp.gather {gather['calls']} calls "
        f"{gather['cpu_ms']:.1f} ms (host clock, of the profiled step's "
        f"{run['profiled_ms']:.1f} ms: "
        f"{100 * (halo['cpu_ms'] + gather['cpu_ms']) / run['profiled_ms']:.1f}"
        f" %); gradient all-reduce {json.dumps(run['all_reduce'])}; "
        f"{run['seconds']:.1f} s wall")
    check(rel[0]["loss"] <= 1e-4 and later <= 1e-3,
          f"[sp] losses {run['terms']} vs {ref['terms']}")
    check(not missing, f"[sp] {missing} not launched on rank 0 (the "
          f"one-process run launched them)")
    check(any(slab in k for k in k3_spans), f"[sp] K3 not at dec6's slab "
          f"{slab} on rank 0: {k3_spans}")
    check(halo["calls"] > 0 and gather["calls"] > 0,
          f"[sp] no halo or gather span on rank 0: {spans}")
    for r, v in run["ranks"].items():
        idle = [k for k, n in ref["launches"].items()
                if n and not v["launches"].get(k)]
        check(not idle, f"[sp] rank {r}'s wrappers counted no launch of "
              f"{idle}: {v['launches']}")
    run.update(k3_spans=k3_spans, halo=halo, gather=gather)
    return run


# ------------------------------------------------- reference checkpoints
# The reference release's layout of this package's nets, the inverse of
# genre_shapehd_tpu_torch/core/reference.py's tables (the package has no
# exporter: the reference is what writes these files)
_BLOCK = {"ConvBN_0.Conv_0": "conv1", "ConvBN_0.BatchNorm_0": "bn1",
          "Conv_0": "conv2", "BatchNorm_0": "bn2", "Conv_1": "downsample.0",
          "BatchNorm_1": "downsample.1"}
_REV_BLOCK = {"Deconv_0.ConvTranspose_0": "deconv1", "BatchNorm_0": "bn1",
              "Deconv_1.ConvTranspose_0": "deconv2", "BatchNorm_1": "bn2",
              "Deconv_2.ConvTranspose_0": "upsample.0",
              "BatchNorm_2": "upsample.1"}
_DECODER_TAIL = {"Deconv_0.ConvTranspose_0": "4.0", "BatchNorm_0": "4.1",
                 "Deconv_1.ConvTranspose_0": "4.3"}
_MINMAX = {"Conv_0": "0", "Conv_1": "1", "Dense_0": "3", "BatchNorm_0": "4",
           "Dense_1": "6", "BatchNorm_1": "7", "Dense_2": "9"}
#: a voxel net's layers of each kind by their Sequential index in ``main``
_VOXEL_DECODER = {"Deconv3D": (0, 3, 8, 11, 14, 17),
                  "BatchNorm": (1, 4, 9, 12, 15)}
_GENERATOR = {"Deconv3D": (0, 3, 6, 9, 12, 15), "BatchNorm": (1, 4, 7, 10, 13)}
_CRITIC = {"Conv3D": (0, 2, 4, 6, 8, 10)}


def _torchvision(mod):
    """A ``ResNet18Features`` module -> torchvision's name of it."""
    m = re.fullmatch(r"BasicBlock_(\d)\.(.+)", mod)
    if m:
        i = int(m[1])
        return f"layer{i // 2 + 1}.{i % 2}.{_BLOCK[m[2]]}"
    return {"Conv_0": "conv1", "BatchNorm_0": "bn1"}[mod]


def _uresnet(mod):
    """A ``UResNet`` module -> ``uresnet.Net``'s (and MarrNet-1's)."""
    head, _, rest = mod.partition(".")
    if head == "ResNet18Features_0":
        tv = _torchvision(rest)
        return "encoder." + {"conv1": "0.0", "bn1": "0.1"}.get(
            tv, tv[len("layer"):])
    if head == "MinmaxHead_0":
        return "decoder_minmax." + _MINMAX[rest]
    m = re.fullmatch(r"RevLayer_(\d)\.RevBasicBlock_(\d)\.(.+)", rest)
    if m:
        return f"{head}.{m[1]}.{m[2]}.{_REV_BLOCK[m[3]]}"
    return f"{head}.{_DECODER_TAIL[rest]}"


def _seq(mod, layers):
    """``<Kind>_<k>[.<inner>]`` -> its index in a voxel net's ``main``."""
    m = re.fullmatch(r"(\w+?)_(\d+)(\.\w+)?", mod)
    return f"main.{layers[m[1]][int(m[2])]}"


def _marrnet2(mod):
    head, _, rest = mod.partition(".")
    if head == "VoxelDecoder_0":
        return "decoder." + _seq(rest, _VOXEL_DECODER)
    if rest == "Dense_0":
        return "encoder.main.0.fc"
    return "encoder.main.0." + _torchvision(rest.partition(".")[2])


def _unet3d(mod):
    kind, k = re.fullmatch(r"(\w+?)_(\d+)(?:\.\w+)?", mod).groups()[:2]
    k = int(k)
    if kind == "Conv3D":
        return f"enc{k + 1}.net.0"
    if kind == "BatchNorm":
        return f"enc{k + 1}.net.1" if k < 6 else f"dec{k - 5}.net.1"
    if kind == "Dense":
        return "full_conv_block.0"
    return f"dec{k + 1}.net.0" if k < 5 else "dec6.net"


def _under(prefixes):
    """A module of a composite net: its first component picks the
    converter of the rest."""
    def f(mod):
        head, _, rest = mod.partition(".")
        return f"{head}.{prefixes[head](rest)}"
    return f


def _depth_inpaint(mod):
    return _under({"net1": _uresnet, "net2": _uresnet})(mod)


#: model alias -> {the port's net name: (index of the file's net, module
#: name -> the reference's)}
REFERENCE_LAYOUT = {
    "marrnet1": {"net": (0, _uresnet)},
    "marrnet2": {"net": (0, _marrnet2)},
    "marrnet": {"net": (0, _under({"marrnet1": _uresnet,
                                   "marrnet2": _marrnet2}))},
    "wgangp": {"net_g": (0, lambda m: _seq(m, _GENERATOR)),
               "net_d": (1, lambda m: _seq(m, _CRITIC))},
    "shapehd": {"net": (0, lambda m: "marrnet2." + _marrnet2(m)),
                "net_noft": (0, lambda m: "marrnet2_noft." + _marrnet2(m)),
                "net_d": (0, lambda m: "d." + _seq(m, _CRITIC))},
    "depth_pred_with_sph_inpaint": {"net": (0, _depth_inpaint)},
    "genre_full_model": {"net": (0, _under({
        "depth_and_inpaint": _depth_inpaint, "refine_net": _unet3d}))},
    "resnet18": {"net": (0, _torchvision)},
}


def reference_layout(alias, nets, batches_tracked=True):
    """The reference release's ``state_dict``s (its ``nets`` list) of this
    package's nets of model ``alias`` ({net name: state_dict}), in the
    order of each net's keys; ``batches_tracked=False`` leaves out the
    BatchNorms' ``num_batches_tracked``."""
    files = {}
    for name, sd in nets.items():
        i, rename = REFERENCE_LAYOUT[alias][name]
        out = files.setdefault(i, {})
        for key, v in sd.items():
            mod, leaf = key.rsplit(".", 1)
            if batches_tracked or leaf != "num_batches_tracked":
                out[f"{rename(mod)}.{leaf}"] = v
    return [files[i] for i in sorted(files)]


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms (``index_add_``, the
    backprojections' scatter, by sorting instead of atomics; cuDNN's
    deterministic convolutions), so that two runs on equal weights give
    equal bits; ops without such an algorithm only warn."""
    import torch
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        torch.backends.cudnn.deterministic = was[2]


def seeded_adam(sd, seed, step=2):
    """A torch Adam ``state_dict`` over every parameter of the reference
    ``state_dict`` ``sd``, ids in its order: exp_avg ~ 1e-3 N(0, 1),
    exp_avg_sq ~ 1e-6 U(0, 1), ``step``."""
    import torch
    from genre_shapehd_tpu_torch.core.reference import param_names
    g = torch.Generator().manual_seed(seed)
    names = param_names(sd)
    return {"state": {i: {
        "step": step,
        "exp_avg": 1e-3 * torch.randn(sd[k].shape, generator=g),
        "exp_avg_sq": 1e-6 * torch.rand(sd[k].shape, generator=g)}
        for i, k in enumerate(names)}, "param_groups": [{
            "lr": 1e-4, "betas": (0.5, 0.9), "eps": 1e-8, "weight_decay": 0,
            "amsgrad": False, "params": list(range(len(names)))}]}


def convert_reference(jobs):
    """``tools/convert_reference_checkpoint_torch.py`` as a user runs it,
    one process per ``(alias, src, dst)``, all at once; fails on a non-zero
    exit or a key the tool did not read.  Returns the seconds of all."""
    tool = os.path.join(ROOT, "tools", "convert_reference_checkpoint_torch.py")
    t0 = time.perf_counter()
    procs = [(alias, subprocess.Popen(
        [sys.executable, tool, "--src", src, "--net", alias, "--dst", dst],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for alias, src, dst in jobs]
    try:
        for alias, p in procs:
            out, err = p.communicate(timeout=600)
            check(p.returncode == 0, f"[refckpt] converting {alias}: exit "
                  f"{p.returncode}: {out} {err[-2000:]}")
            check("unread" not in err, f"[refckpt] {alias}: {err[-2000:]}")
            log(f"[refckpt] {out.strip()}")
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return time.perf_counter() - t0


def phase_reference_checkpoints(device, work, genre_ckpt, photos):
    """The reference release's checkpoints, converted by the port's tool
    without JAX and read by the users' entry points: GenRe (phase 3's
    seeded checkpoint in the reference's layout, with seeded Adam moments
    at step 2) and ShapeHD's three nets with a MarrNet-1 (seeded), written
    as the reference writes them (``torch.save``, PyTorch's legacy
    format), converted in parallel processes.  ``cli.test`` on 8 of phase
    3's photos, bf16, batch 8, from each converted file and from the
    port's own checkpoint of the same weights: the ``.npz`` bit for bit
    (deterministic algorithms in both), K1, K2, K3 once a GenRe forward,
    K3 twice a ShapeHD one.  Then ``cli.train --net genre_full_model
    --joint_train --resume -1`` from the converted file for one step (and
    its eval batch): a finite loss, Adam's count 2 -> 3, K1, K2, K3, K5;
    and from the file with its moments zeroed, whose weights must end
    elsewhere (mean |difference| over 0.1 lr): the moments were read."""
    import torch
    from genre_shapehd_tpu_torch.cli import test as cli_test
    from genre_shapehd_tpu_torch.cli import train as cli_train
    from genre_shapehd_tpu_torch.core.checkpoint import (
        load_checkpoint, net_payload, save_checkpoint)
    from genre_shapehd_tpu_torch.core.convert import (jax_to_torch,
                                                      torch_to_jax)
    from genre_shapehd_tpu_torch.models.marrnet import marrnet1_net
    from genre_shapehd_tpu_torch.models.marrnet2 import Marrnet2Net
    from genre_shapehd_tpu_torch.nn import VoxelDiscriminator, init_weights
    from genre_shapehd_tpu_torch.ops.cuda import critic_stem_kernel as cst
    from genre_shapehd_tpu_torch.ops.cuda import render_kernel as rk
    from genre_shapehd_tpu_torch.ops.cuda import subpixel_kernel as sk
    from genre_shapehd_tpu_torch.train.state import (
        EmptyState, ScaleByAdamState, adam_moments)
    t_phase = time.perf_counter()
    d = os.path.join(work, "refckpt")
    os.makedirs(d)
    path = lambda name: os.path.join(d, name)                # noqa: E731

    def legacy_save(obj, name):
        torch.save(obj, path(name), _use_new_zipfile_serialization=False)

    # the reference's files: GenRe with its optimizer, ShapeHD's nets and
    # the MarrNet-1 its test path reads
    own = load_checkpoint(genre_ckpt)["nets"][0]
    ref = reference_layout("genre_full_model", {"net": jax_to_torch(
        own["params"], own["batch_stats"])})
    legacy_save({"nets": ref, "optimizers": [seeded_adam(ref[0], 12)],
                 "epoch": 2}, "genre_full_model_ref.pt")
    shd = {}
    for i, (name, net) in enumerate((("net", Marrnet2Net()),
                                     ("net_noft", Marrnet2Net()),
                                     ("net_d", VoxelDiscriminator(64, 128)),
                                     ("marrnet1", marrnet1_net(256)))):
        init_weights(net, torch.Generator().manual_seed(20 + i))
        shd[name] = net.state_dict()
    m1 = {"net": shd.pop("marrnet1")}
    save_checkpoint(path("shapehd_own.pt"), {
        "nets": [dict(zip(("params", "batch_stats"), torch_to_jax(sd)))
                 for sd in shd.values()],
        "optimizers": [], "epoch": 0, "loss_eval": 0.0,
        "net_names": list(shd), "opt_names": []})
    save_checkpoint(path("marrnet1_own.pt"),
                    net_payload(*torch_to_jax(m1["net"])))
    legacy_save({"nets": reference_layout("shapehd", shd), "optimizers": [],
                 "epoch": 0}, "shapehd_ref.pt")
    legacy_save({"nets": reference_layout("marrnet1", m1), "optimizers": [],
                 "epoch": 0}, "marrnet1_ref.pt")
    t_write = time.perf_counter() - t_phase
    t_convert = convert_reference([
        (a, path(f"{a}_ref.pt"), path(f"{a}.pt"))
        for a in ("genre_full_model", "shapehd", "marrnet1")])
    conv = load_checkpoint(path("genre_full_model.pt"))
    for tree in ("params", "batch_stats"):
        check(_same_tree(conv["nets"][0][tree], own[tree]),
              f"[refckpt] the converted GenRe {tree} differ from phase 3's")
    count, mu, _ = adam_moments(conv["optimizers"][0])
    check(count == 2 and conv["epoch"] == 2, f"[refckpt] count {count}, "
          f"epoch {conv['epoch']}")

    # cli.test from the converted files and from the port's own.  The
    # meshes are drawn at the occupancy level 0.9: seeded random nets give
    # sigmoid(logits) of 0.47-0.53 over nearly all voxels, whose mesh at
    # 0.5 is 234 MB of .obj and 8.7 s on an H100
    vis_param = path("vis_param.json")
    with open(vis_param, "w") as f:
        json.dump({"voxel": {"isosurf_thres": 0.9}}, f)
    # (K1 and K2, K3, K6 launches): K6 on ShapeHD's critic, both grids
    tests = {}
    for tag, net, ckpt, extra, want in (
            ("genre_own", "genre_full_model", genre_ckpt, [], (1, 1, 0)),
            ("genre_converted", "genre_full_model",
             path("genre_full_model.pt"), [], (1, 1, 0)),
            ("shapehd_own", "shapehd", path("shapehd_own.pt"),
             ["--marrnet1_file", path("marrnet1_own.pt")], (0, 2, 2)),
            ("shapehd_converted", "shapehd", path("shapehd.pt"),
             ["--marrnet1_file", path("marrnet1.pt")], (0, 2, 2))):
        out_dir = path(f"test_{tag}")
        rk.reset_launches()
        sk.reset_launches()
        cst.reset_launches()
        t0 = time.perf_counter()
        with deterministic():
            rc = cli_test.main(["--net", net, "--net_file", ckpt] + extra + [
                "--input_rgb", os.path.join(photos, "0[0-7]_rgb.png"),
                "--input_mask", os.path.join(photos, "0[0-7]_silhouette.png"),
                "--output_dir", out_dir, "--dtype", "bfloat16",
                "--batch_size", "8", "--vis_workers", "8", "--vis_param_f",
                vis_param, "--device", "cuda"])
            torch.cuda.synchronize()
        launches = {**rk.launches, **sk.launches, **cst.launches}
        k12, k3, k6 = want
        check(rc == 0 and launches == {
            "render_stage1": k12, "render_stage2_scan": k12,
            "render_stage2_samples": 0, "deconv_final": k3,
            "critic_stem": k6, "critic_stem_backward": 0,
            "critic_stem_mask": 0},
            f"[refckpt] cli.test {tag}: rc {rc}, launches {launches}")
        with np.load(os.path.join(out_dir, "batch0000.npz")) as z:
            out = {k: z[k] for k in z.files}
        check(out["pred_voxel"].shape == (8, 128, 128, 128)
              and bool(np.isfinite(out["pred_voxel"]).all()),
              f"[refckpt] {tag}: pred_voxel {out['pred_voxel'].shape}")
        tests[tag] = dict(out=out, launches=launches,
                          seconds=time.perf_counter() - t0)
    for net in ("genre", "shapehd"):
        a, b = tests[f"{net}_own"]["out"], tests[f"{net}_converted"]["out"]
        diff = {k: float(np.abs(a[k].astype(np.float64) - b[k]).max())
                for k in a if a[k].dtype.kind == "f" and k in b}
        check(sorted(a) == sorted(b) and all(
            np.array_equal(a[k], b[k]) for k in a),
            f"[refckpt] cli.test {net}: the converted file's output differs "
            f"from the port's own checkpoint's: max |diff| {diff}")
        log(f"[refckpt] cli.test --net {net} on 8 photos, bf16: the "
            f"converted file's .npz equals the own checkpoint's bit for bit "
            f"({', '.join(sorted(a))}); launches "
            f"{json.dumps(tests[f'{net}_converted']['launches'])}; "
            f"{tests[f'{net}_own']['seconds']:.1f} / "
            f"{tests[f'{net}_converted']['seconds']:.1f} s wall (own / "
            f"converted)")

    # a resumed joint step: from the converted file, and from it with
    # Adam's moments zeroed
    zeroed = dict(conv, optimizers=[(ScaleByAdamState(
        np.asarray(count, np.int32),
        _zeros(mu), _zeros(mu)), EmptyState())])
    save_checkpoint(path("genre_zeroed.pt"), zeroed)
    del conv, zeroed, mu
    logdir = path("train")
    base = ["--net", "genre_full_model", "--joint_train", "--dataset",
            "synthetic", "--batch_size", "4", "--dtype", "bfloat16",
            "--surface_weight", "10", "--lr", "1e-4", "--epoch", "3",
            "--epoch_batches", "1", "--eval_batches", "1",
            "--synthetic_length", "8", "--workers", "4", "--logdir",
            logdir, "--log_batch", "--manual_seed", "0", "--save_net", "0",
            "--vis_batches_vali", "0", "--resume", "-1", "--device", "cuda"]
    trained, train_launches = {}, {}
    for tag, ckpt, expr in (
            ("converted", path("genre_full_model.pt"), "0"),
            ("zeroed", path("genre_zeroed.pt"), "1")):
        run_dir = os.path.join(logdir, "genre_full_model_synthetic_0.0001",
                               expr)
        os.makedirs(run_dir)
        os.link(ckpt, os.path.join(run_dir, "checkpoint.pt"))
        rk.reset_launches()
        sk.reset_launches()
        cst.reset_launches()
        t0 = time.perf_counter()
        rc = cli_train.main(base + ["--expr_id", expr])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {**rk.launches, **sk.launches, **cst.launches}
        want = {"render_stage1": 3, "render_stage2_scan": 2,
                "render_stage2_samples": 1, "deconv_final": 2,
                "critic_stem": 0, "critic_stem_backward": 0,
                "critic_stem_mask": 0}
        check(rc == 0 and launches == want, f"[refckpt] cli.train {tag}: "
              f"rc {rc}, launches {launches} != {want}")
        rows = _csv_rows(os.path.join(run_dir, "batch_loss.csv"))
        loss = [float(r["loss"]) for r in rows]
        payload = load_checkpoint(os.path.join(run_dir, "checkpoint.pt"))
        after = adam_moments(payload["optimizers"][0])[0]
        check(len(loss) == 1 and bool(np.isfinite(loss).all())
              and after == 3 and payload["epoch"] == 3,
              f"[refckpt] cli.train {tag}: loss {loss}, Adam count {after}, "
              f"epoch {payload['epoch']}")
        trained[tag] = _flat_net(payload["nets"][0])
        train_launches[tag] = launches
        log(f"[refckpt] cli.train --resume -1 from the {tag} file "
            f"({'seeded' if tag == 'converted' else 'zero'} moments): 1 joint "
            f"step of batch 4, bf16, loss {loss[0]:.5f}, Adam count 2 -> "
            f"{after}, launches {json.dumps(launches)}, {seconds:.1f} s "
            f"wall")
        del payload
        os.remove(os.path.join(run_dir, "checkpoint.pt"))
    start = jax_to_torch(own["params"], {})
    lr = 1e-4
    moved = float(statistics.fmean(
        float((trained["converted"][k] - v).abs().mean()) for k, v in
        start.items()))
    apart = float(statistics.fmean(
        float((trained["converted"][k] - trained["zeroed"][k]).abs().mean())
        for k in start))
    check(moved > 0.1 * lr and apart > 0.1 * lr,
          f"[refckpt] the resumed step moved the weights by {moved / lr:.3f}"
          f" lr on average, and {apart / lr:.3f} lr from the zeroed "
          f"moments' step: under 0.1 lr")
    seconds = time.perf_counter() - t_phase
    launches = {k: sum(r["launches"][k] for r in tests.values())
                + sum(r[k] for r in train_launches.values())
                for k in ("render_stage1", "render_stage2_scan",
                          "render_stage2_samples", "deconv_final",
                          "critic_stem", "critic_stem_backward",
                          "critic_stem_mask")}
    log(f"[refckpt] negative control: the step from the file's moments "
        f"moved each weight {moved / lr:.3f} lr on average (mean over "
        f"tensors of the mean |change|); from the same file with zeroed "
        f"moments it ends {apart / lr:.3f} lr away")
    log(f"[refckpt] phase 12: {seconds:.1f} s wall (reference files "
        f"written in {t_write:.1f} s, converted in {t_convert:.1f} s); "
        f"launches {json.dumps(launches)}")
    shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    return dict(seconds=seconds, launches=launches, moved_lr=moved / lr,
                apart_lr=apart / lr)


def _zeros(tree):
    return {k: _zeros(v) if isinstance(v, dict) else np.zeros_like(v)
            for k, v in tree.items()}


def _same_tree(a, b):
    if isinstance(b, dict):
        return isinstance(a, dict) and sorted(a) == sorted(b) and all(
            _same_tree(a[k], b[k]) for k in b)
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        np.array_equal(a, b))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from genre_shapehd_tpu_torch.ops.cuda import build
    from genre_shapehd_tpu_torch.viz import mcubes

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi unavailable"
    log(card)
    log("torch", torch.__version__, "cuda", torch.version.cuda, "device",
        torch.cuda.get_device_name(0))
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)
    shutil.rmtree(mcubes.BUILD_DIR, ignore_errors=True)
    seconds = build.build_all()
    check(sorted(seconds) == sorted(build.SOURCES), f"built {seconds}")
    log(f"[build] nvcc sm_90a: {json.dumps(seconds)} s")
    t0 = time.perf_counter()
    log(f"[build] host C++: {os.path.relpath(mcubes.build(), ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for src, text in build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {src}: {line.strip()}")
    # K3's bf16 path runs its products on the tensor cores: HMMA in SASS
    hmma = {k: n for k, n in sass_count("deconv_final_kernel.cu", "HMMA")
            .items() if "deconv_final" in k}
    check(any(n > 0 for k, n in hmma.items() if "mma_kernel" in k),
          f"no HMMA in K3's tensor-core kernel: {hmma}")
    log(f"[build] HMMA instructions in deconv_final_kernel.cu's SASS per "
        f"kernel (cuobjdump -sass): {json.dumps(hmma)}")

    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    # seconds since the start at the end of each phase
    elapsed = {}

    def mark(phase):
        elapsed[phase] = round(time.perf_counter() - t_start, 1)
        log(f"[time] {phase} done at {elapsed[phase]} s")

    mark("build")
    errs, ms, plain_ms, library_ms, bounds = phase_kernels(device)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=device)
    k3 = "deconv_final"
    errs[k3], ms[k3], plain_ms[k3], library_ms[k3], bounds[k3] = \
        phase_deconv_final(device, flush)
    k3_slab = phase_deconv_final_slab(device, flush)
    k4, timed, eval_shape = "nn_min_dist", (8, 8192, 8192), (1, 1024, 1024)
    errs[k4], k4_times = phase_nn_min_dist(device, flush)
    ms[k4], plain_ms[k4], library_ms[k4], bounds[k4] = (
        k4_times[timed][k] for k in ("ms", "plain_ms", "library_ms", "bound"))
    k5 = "render_stage2_samples"
    errs[k5], ms[k5], plain_ms[k5], library_ms[k5], bounds[k5] = \
        phase_stage2_samples(device, flush)
    k6 = "critic_stem"
    errs[k6], ms[k6], plain_ms[k6], library_ms[k6], bounds[k6] = \
        phase_critic_stem(device, flush)
    k6m = "critic_stem_mask"
    errs[k6m], ms[k6m], plain_ms[k6m], library_ms[k6m], bounds[k6m] = \
        phase_critic_stem_mask(device, flush)
    k7 = "critic_conv"
    errs[k7], ms[k7], plain_ms[k7], library_ms[k7], bounds[k7], k7_rows = \
        phase_critic_conv(device, flush)
    f32_rows = phase_float32(device, flush)
    family_k3 = phase_family_kernels(device, flush)
    del flush
    phase_edge_shapes(device)
    phase_render_grad(device)
    mark("2 kernels")
    launches, ckpt, out_dir = phase_main_path(device, work)
    launches.update(phase_score(device, work, out_dir))
    phase_reference(device)
    fwd_ms, fwd32_ms = phase_throughput(device, ckpt)
    bwd_before, bwd_after = dec6_backward_ms(device)
    mark("3-5 serving, scoring, throughput")
    log(f"[train] dec6 backward, batch 4, bf16, all three gradients: "
        f"{bwd_before:.3f} ms through the forward again and autograd.grad, "
        f"{bwd_after:.3f} ms by convolution_backward")
    runs, train_launches = phase_train(device, work)
    # K5 runs on the training path only: its launches are the joint run's
    launches[k5] = train_launches[k5]
    mark("6 training")
    staged, marrnet1_ckpt = phase_staged(device, work)
    phase_train_profile(device, runs)
    mark("7 staged")
    family = phase_family(device, work, marrnet1_ckpt)
    # K6 and K7 run on ShapeHD's serving path: their launches are cli.test's
    launches[k6] = family["test_shapehd"]["launches"][k6]
    launches[k7] = family["test_shapehd"]["launches"][k7]
    # the mask runs in the fine-tuning step's backward: ShapeHD's cli.train
    launches[k6m] = family["shapehd"]["launches"][k6m]
    phase_family_profile(device, family)
    mark("8 family")
    shapenet = phase_shapenet(work)
    mark("9 shapenet")
    tree, marrnet1_shapenet = shapenet.pop("tree"), shapenet.pop("marrnet1")
    scripts = phase_scripts(work, tree, marrnet1_shapenet, ckpt,
                            os.path.join(work, "photos"))
    shutil.rmtree(tree, ignore_errors=True)
    mark("13 scripts")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=device)
    exact = phase_exact_render(device, flush)
    del flush
    mark("9 exact renderer")
    dp = phase_dp(work)
    mark("10 dp")
    sp = phase_sp(work, dp)
    mark("11 sp")
    refckpt = phase_reference_checkpoints(device, work, ckpt,
                                          os.path.join(work, "photos"))
    mark("12 reference checkpoints")

    kernels = []
    for name in ("render_stage1", "render_stage2_scan", k3, k4, k5, k6, k6m,
                 k7):
        bms, by, nbytes = bounds[name]
        check(launches[name] > 0, f"{name} was not launched on its path")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name][0], "mean_abs_err": errs[name][1],
            "ms": ms[name], "plain_ms": plain_ms[name], "bound_ms": bms,
            "bound_us": bms * 1e3, "bound_by": by,
            "bound_share": bms / ms[name],
            "achieved_gb_per_s": nbytes / ms[name] / 1e6,
            "library_ms": library_ms[name], "library_call": LIBRARY[name],
            "launches_staged": sum(r["launches"].get(name, 0)
                                   for r in staged.values()),
            "launches_family": sum(r["launches"].get(name, 0)
                                   for r in family.values()
                                   if "launches" in r),
            "launches_shapenet": sum(r["launches"].get(name, 0)
                                     for r in shapenet.values()
                                     if "launches" in r),
            # phase 13: the launch scripts' subprocesses
            "launches_scripts": sum(r["launches"].get(name, 0)
                                    for r in scripts.values()
                                    if isinstance(r, dict)
                                    and "launches" in r),
            # rank 0's profiled step of each phase-10 run
            "launches_dp": {k: r["launches"].get(name, 0)
                            for k, r in dp.items()},
            # rank 0's profiled step of phase 11 (dp 1 x sp 2)
            "launches_sp": sp["launches"].get(name, 0),
            # phase 12: cli.test and cli.train on converted reference files
            # (and cli.test on the port's own checkpoints of their weights)
            "launches_reference": refckpt["launches"].get(name, 0)})
    # K4 is timed at 8 x 8192 x 8192 points; the scoring path gives it the
    # eval protocol's 1 x 1024 x 1024, where launch latency dominates
    ev = k4_times[eval_shape]
    by_name = {k["name"]: k for k in kernels}
    by_name[k4].update(
        timed_shape=list(timed), eval_shape=list(eval_shape),
        eval_shape_ms=ev["ms"], eval_shape_plain_ms=ev["plain_ms"],
        eval_shape_library_ms=ev["library_ms"],
        eval_shape_bound_ms=ev["bound"][0])
    # K5 is timed at the training batch of 4
    by_name[k5].update(timed_shape=[TRAIN["batch"], MAIN["r"], MAIN["r"],
                                    MAIN["z"]])
    # K7 is timed at each of one critic's four shapes, batch 128
    by_name[k7].update(rows=k7_rows)
    by_name[k3].update(hmma_in_sass=sum(hmma.values()),
                       marrnet_shapehd=family_k3, sp_slab=k3_slab,
                       sp_slab_launches=sp["k3_spans"],
                       scripts_launches_by_shape={
                           k: r["k3_shapes"] for k, r in scripts.items()
                           if isinstance(r, dict) and "k3_shapes" in r})
    # the default command's type at the main path's shapes
    for name, row in f32_rows.items():
        by_name[name]["float32"] = row
    for k in kernels:
        log(f"[kernels] {k['name']}: {k['ms']:.4f} ms, bound "
            f"{k['bound_us']:.1f} us ({k['bound_by']}), "
            f"{100 * k['bound_share']:.1f} % of the bound, "
            f"{k['achieved_gb_per_s']:.0f} GB/s; plain {k['plain_ms']:.4f} "
            f"ms; library {k['library_ms']}")
    for name, row in f32_rows.items():
        log(f"[kernels] {name} float32 {row['shape']}: {row['ms']:.4f} ms, "
            f"bound {row['bound_ms'] * 1e3:.1f} us ({row['bound_by']}), "
            f"{100 * row['bound_share']:.1f} % of the bound, "
            f"{row['achieved_gb_per_s']:.0f} GB/s; library "
            f"{row['library_ms']}")
    log(f"[summary] card: {card}; forward {fwd_ms:.2f} ms = "
        f"{8e3 / fwd_ms:.1f} recon/s (batch 8, bf16), float32 "
        f"{fwd32_ms[False]:.2f} ms = {8e3 / fwd32_ms[False]:.1f} recon/s "
        f"(TF32 off), {fwd32_ms[True]:.2f} ms = "
        f"{8e3 / fwd32_ms[True]:.1f} recon/s (cuDNN TF32 on); training "
        f"step, batch "
        f"4, bf16: stage 3 {runs['stage3']['step_ms']:.1f} ms, joint "
        f"{runs['joint']['step_ms']:.1f} ms; staged (procedural) "
        f"marrnet1 {staged['marrnet1']['step_ms']:.1f} ms, "
        f"depth_pred_with_sph_inpaint "
        f"{staged['depth_pred_with_sph_inpaint']['step_ms']:.1f} ms, "
        f"genre_full_model {staged['genre_full_model']['step_ms']:.1f} ms; "
        f"family (procedural) "
        + ", ".join(f"{k} {family[k]['step_ms']:.1f} ms" for k in (
            "marrnet2", "wgangp", "wgangp_d_iter2", "shapehd", "marrnet"))
        + "; ShapeNet tree (scripts' command lines) "
        + ", ".join(f"{k} {v['step_ms']:.1f} ms (data {v['data_ms']:.1f})"
                    for k, v in shapenet.items() if "step_ms" in v)
        + "; ShapeHD workflow by scripts_torch/ (ShapeNet tree) "
        + ", ".join(f"{k} {scripts[k]['step_ms']:.1f} ms (data "
                    f"{scripts[k]['data_ms']:.1f})" for k in (
                        "marrnet2", "wgangp", "shapehd", "marrnet"))
        + f", phase 13 {scripts['seconds']:.1f} s"
        + "; exact renderer vs K1 + K2, batch 4: "
        + ", ".join(f"{k} {v['exact_ms']:.3f} vs {v['k1_k2_ms']:.3f} ms"
                    for k, v in exact.items())
        + "; data parallel, float32 unless named, batch 4: "
        + ", ".join(f"{k} {v['step_ms']:.1f} ms" for k, v in dp.items())
        + f"; spatial parallel (dp 1 x sp 2, 2 gloo ranks on the card), "
        f"float32, batch 4: {sp['step_ms']:.1f} ms"
        + f"; reference checkpoints (phase 12) {refckpt['seconds']:.1f} s"
        + f"; total {time.perf_counter() - t_start:.0f} s; seconds at "
        f"each phase's end {json.dumps(elapsed)}")
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
