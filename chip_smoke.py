#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (genre_shapehd_tpu_torch).

  python3 chip_smoke.py

Needs one CUDA GPU and nvcc; imports nothing of JAX.  Phases, each
raising on failure:

 1. the card's name and power limit; build every CUDA kernel from
    genre_shapehd_tpu_torch/csrc (one nvcc per source, in parallel);
 2. each renderer kernel against its plain PyTorch version at the main
    path's shapes (batch 8, V=128, R=128, S=256, M=192, bfloat16), the
    whole renderer within tests/test_pallas_render.py's bounds, and a
    float32 check at a smaller size with TF32 off; kernel, plain and
    bound times (CUDA events, median of 25, L2 flushed before each);
 3. the main path through its entry point: 16 generated photo + mask
    PNGs, a seeded GenreNet exported to a checkpoint in the JAX package's
    format, ``genre_shapehd_tpu_torch.cli.test`` at 256² -> 128³ in
    bfloat16, batch 8, on the card; launch counts of both kernels;
 4. the CUDA forward against the CPU forward on a small input (float32),
    then recon/s of the batch-8 bfloat16 forward, and a torch.profiler
    pass over 3 forwards: device time per stage (the ``genre.*`` spans of
    the model), the top kernels, and the device's idle share.

Prints a ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.  Scratch files go to build/chip_smoke/ under the repository.
"""

from __future__ import annotations

import glob
import json
import os
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
REPLACES = {
    "render_stage1": "genre_shapehd_tpu/ops/pallas/render_kernel.py:170 "
                     "(_s1_sparse_kernel; dense twin _s1_kernel :292)",
    "render_stage2_scan": "genre_shapehd_tpu/ops/pallas/render_kernel.py:392 "
                          "(_s2scan_kernel)",
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


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / H100_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


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
    check(rk.launches == {"render_stage1": 1, "render_stage2_scan": 1},
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
    log("[kernels] bf16 main-path shapes, max/mean abs err:",
        json.dumps(errs))

    # float32 at a smaller size, TF32 off: summation order only (1e-5)
    s = dict(b=2, v=64, r=64, z=128, m=96)
    vox32 = volume(s["b"], s["v"], 1, device)
    args = (s["v"], s["r"], s["z"], s["m"], torch.float32)
    c32 = rk.stage1(vox32, *args)
    o32 = rk.stage2(c32, *args)
    dc = float((c32 - rk.stage1_plain(vox32, *args)).abs().max())
    do = float((o32 - rk.stage2_plain(c32, *args)).abs().max())
    check(dc < 1e-5 and do < 1e-5, f"f32 K1 {dc} K2 {do}")
    log(f"[kernels] f32 {s}: K1 max err {dc:.3g}, K2 max err {do:.3g}")

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
    # bytes: every input read once, every output written once
    tap_bytes_1 = r * m * (4 + 8) * 2           # x, y tables
    tap_bytes_2 = r * z * (4 + 8) * 2           # z, m tables
    c_bytes = b * r * m * v * 2
    bounds = {
        # 4 weight products + 4 fma per element of c
        "render_stage1": bound(b * v ** 3 * 2 + c_bytes + tap_bytes_1,
                               12.0 * b * r * m * v),
        # per sample: 6 mul/add per 2 z-taps x 2, 3 for the m-taps,
        # clip 2, log1p and exp 1 each, scan and depth sums 5
        "render_stage2_scan": bound(c_bytes + tap_bytes_2 + b * r * r * 4,
                                    24.0 * b * r * r * z),
    }
    return errs, ms, plain_ms, bounds


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

    photos = os.path.join(work, "photos")
    make_photos(photos, 16, seed=0)
    net = GenreNet(dtype=torch.bfloat16).eval()
    init_weights(net, torch.Generator().manual_seed(0))
    net.to(device)
    calibrate(net, *scene_batch(2, 256, device, 1))
    ckpt = os.path.join(work, "genre_full.pt")
    save_checkpoint(ckpt, net_payload(*torch_to_jax(net.state_dict())))
    out_dir = os.path.join(work, "out")
    argv = ["--net", "genre_full_model", "--net_file", ckpt,
            "--input_rgb", os.path.join(photos, "*_rgb.png"),
            "--input_mask", os.path.join(photos, "*_silhouette.png"),
            "--output_dir", out_dir, "--overwrite", "--dtype", "bfloat16",
            "--batch_size", "8", "--workers", "4", "--device", "cuda"]
    rk.reset_launches()
    t0 = time.perf_counter()
    rc = cli_test.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(rk.launches)
    check(rc == 0, f"cli.test returned {rc}")
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
    check(launches == {"render_stage1": 2, "render_stage2_scan": 2},
          f"launches in the main path {launches} != one per forward")
    log(f"[main] cli.test: 16 photos, 2 forwards, {seconds:.1f} s wall "
        f"(load, preprocess, first-call setup included); launches "
        f"{launches}")
    return launches, ckpt


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


def phase_throughput(device, ckpt):
    import torch
    from torch.profiler import ProfilerActivity, profile
    from genre_shapehd_tpu_torch.core.checkpoint import load_net
    from genre_shapehd_tpu_torch.core.convert import jax_to_torch
    from genre_shapehd_tpu_torch.models.genre_full import GenreNet
    net = GenreNet(dtype=torch.bfloat16).eval()
    net.load_state_dict(jax_to_torch(*load_net(ckpt)))
    net.to(device)
    rgb, sil = scene_batch(8, 256, device, 3)
    torch.cuda.reset_peak_memory_stats()

    def fwd():
        with torch.inference_mode():
            net(rgb, sil)

    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=device)
    ms = time_ms(fwd, flush, reps=10, warmup=3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[throughput] GenreNet forward, batch 8, bf16, 256^2 -> 128^3: "
        f"{ms:.2f} ms median of 10 -> {8e3 / ms:.1f} recon/s; peak memory "
        f"{peak:.2f} GiB")

    n = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fwd()
        torch.cuda.synchronize()
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
        if e.key.startswith("genre."):
            on_device = e.device_type == DeviceType.CUDA
            val = _device_us(e, on_device) / n / 1e3
            stages.setdefault(e.key, {})[
                "span" if on_device else "kernels"] = round(val, 3)
    log(f"[profile] per forward, ms by stage: {json.dumps(stages)}")
    log(f"[profile] kernel time {busy:.2f} ms per forward (profiled) vs "
        f"{ms:.2f} ms unprofiled wall: device idle share "
        f"{max(0.0, 1 - busy / ms):.3f}")
    top = sorted(kernels, key=lambda e: -_device_us(e, True))[:12]
    for e in top:
        log(f"[profile] {_device_us(e, True) / n / 1e3:8.3f} ms "
            f"x{e.count // n:<4d} {e.key[:110]}")
    return ms


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from genre_shapehd_tpu_torch.ops.cuda import build

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
    seconds = build.build_all()
    log(f"[build] nvcc sm_90a: {json.dumps(seconds)} s")
    for src, text in build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {src}: {line.strip()}")

    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    errs, ms, plain_ms, bounds = phase_kernels(device)
    launches, ckpt = phase_main_path(device, work)
    phase_reference(device)
    fwd_ms = phase_throughput(device, ckpt)

    kernels = []
    for name in ("render_stage1", "render_stage2_scan"):
        bms, by = bounds[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "genre_shapehd_tpu_torch/csrc/render_kernel.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name][0], "mean_abs_err": errs[name][1],
            "ms": ms[name], "plain_ms": plain_ms[name], "bound_ms": bms,
            "bound_us": bms * 1e3, "bound_by": by, "library_ms": None})
    log(f"[summary] card: {card}; forward {fwd_ms:.2f} ms = "
        f"{8e3 / fwd_ms:.1f} recon/s (batch 8, bf16); total "
        f"{time.perf_counter() - t_start:.0f} s")
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
