"""Card time of chosen port kernels, for this tree or another checkout.

Times the kernels named on the command line, for the port in this tree
or in another checkout of it (``--root``, e.g. an unpacked ``git
archive`` of an earlier commit), with ``chip_smoke.py``'s helpers: CUDA
events, L2 flushed before each run, median of ``--reps``, and each
kernel's bound.  Each result is held against the plain version first.

  k3_f32      K3 ``deconv_final`` at dec6's shape (8, 40, 64^3), float32,
              TF32 off (within 1e-5 of the output's scale)
  k3_bf16     the same in bfloat16 (``chip_smoke.k3_bf16_within``)
  k3_host     the host's time to return from one call at dec6's cube,
              float32 and bfloat16 (as stage2_host): of K3's wrapper, of
              its ``_launch`` and of its C entry point alone; and of one
              call right after a synchronize, as the events see it
  k3_slab     K3 at dec6's Z slab under ``cli.train --sp 2``: (4, 40,
              64 x 64 x 32) with a halo plane at each end, padded to 40
              planes (output planes of positions 1 .. 32), bfloat16 and
              float32 (a tree whose K3 takes no slab skips it)
  critic_stem K6 ``critic_stem`` at the ShapeHD cell's (128, 1, 128^3),
              checked and built by ``chip_smoke.critic_stem_row``, beside
              ``critic_stem_plain`` under bf16 autocast and bf16
              ``F.conv3d`` with ``F.leaky_relu``
  k4          K4 ``nn_min_dist`` at 8 x 8192 x 8192 and at the scoring
              path's 1 x 1024 x 1024 (rtol 1e-4, atol 1e-5)
  stage2_host the host's time to return from one call of the renderer's
              K2 (batch 8) and K5 (batch 4) wrappers at the main path's
              shapes, bf16 c: ``--calls`` calls queued after a
              synchronize, fewer than the launch queue holds, so the host
              never waits for the card inside them

Events around a call also hold the host's time to reach the launch, which
a small kernel does not hide, so each timed kernel's mean device time over
``--reps`` back-to-back calls is read from torch.profiler last (a profiler
session slows the launches after it).  The card's SM clock and power draw
are printed before and after.

Run from the repository root; compare two trees only inside one call, in
turns (parent, change, change, parent):

    python3 tools/time_kernels.py [--root DIR] [--reps 25] k3_f32 k4

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def device_ms(fn, name, reps):
    """Mean milliseconds on the card of the kernels named ``name`` that
    ``fn()`` launches, over ``reps`` calls in one profiler session."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and name in e.key
               ) / reps / 1e3


def smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def k3_f32(cs, dev, g, flush, args, timed):
    import torch
    from genre_shapehd_tpu_torch.ops.cuda import subpixel_kernel as sk
    b, cin, s = (cs.DEC6[k] for k in ("b", "cin", "s"))
    x = torch.randn((b, cin, s, s, s), generator=g, device=dev)
    w = torch.randn((cin, 1, 4, 4, 4), generator=g, device=dev) * 0.05
    bias = torch.full((1,), 0.1, device=dev)
    ref = sk.deconv_final_plain(x, w, bias)
    err = float((sk.deconv_final(x, w, bias) - ref).abs().max())
    cs.check(err <= 1e-5 * float(ref.abs().max()),
             f"K3 float32 vs plain: {err}")
    del ref
    fn = lambda: sk.deconv_final(x, w, bias)               # noqa: E731
    timed["deconv_final_f32"] = (fn, "deconv_final")
    n_out = b * (2 * s) ** 3
    bnd = cs.bound(4 * (x.numel() + cin * 64 + 1 + n_out),
                   2.0 * 8 * cin * n_out)
    return {"deconv_final_f32": {
        "shape": [b, cin, s], "max_abs_err": err,
        "ms": cs.time_ms(fn, flush, args.reps), "bound_ms": bnd[0],
        "bound_by": bnd[1]}}


def k3_bf16(cs, dev, g, flush, args, timed):
    import torch
    from genre_shapehd_tpu_torch.ops.cuda import subpixel_kernel as sk
    b, cin, s = (cs.DEC6[k] for k in ("b", "cin", "s"))
    bf = torch.bfloat16
    x = torch.randn((b, cin, s, s, s), generator=g, device=dev).to(bf)
    w = torch.randn((cin, 1, 4, 4, 4), generator=g, device=dev) * 0.05
    bias = torch.full((1,), 0.1, device=dev)
    ref = sk.deconv_final_plain(x, w, bias).float()
    err = float((sk.deconv_final(x, w, bias).float() - ref).abs().max())
    cs.check(err <= 1e-2 * float(ref.abs().max()),
             f"K3 bf16 vs plain: {err}")
    del ref
    fn = lambda: sk.deconv_final(x, w, bias)               # noqa: E731
    timed["deconv_final_bf16"] = (fn, "deconv_final")
    n_out = b * (2 * s) ** 3
    bnd = cs.bound(x.numel() * 2 + cin * 64 * 4 + 4 + n_out * 2,
                   2.0 * 8 * cin * n_out, cs.H100_BF16_FLOPS)
    return {"deconv_final_bf16": {
        "shape": [b, cin, s], "max_abs_err": err,
        "ms": cs.time_ms(fn, flush, args.reps), "bound_ms": bnd[0],
        "bound_by": bnd[1]}}


def k3_slab(cs, dev, g, flush, args, timed):
    import inspect
    from genre_shapehd_tpu_torch.ops.cuda import subpixel_kernel as sk
    if "z_lo" not in inspect.signature(sk.deconv_final).parameters:
        return {"deconv_final_slab": "this tree's K3 takes no Z slab"}
    out = {}
    for dtype in ("bfloat16", "float32"):
        row = cs.k3_slab_row(dev, g, dtype)
        fn = row.pop("call")
        del row["plain"], row["library"]
        row["bound_ms"], row["bound_by"], _ = row.pop("bound")
        key = f"deconv_final_slab_{dtype}"
        timed[key] = (fn, "deconv_final")
        row["ms"] = cs.time_ms(fn, flush, args.reps)
        out[key] = row
    return out


def critic_stem(cs, dev, g, flush, args, timed):
    import torch
    row = cs.critic_stem_row(dev, 128, 17)
    fn = row.pop("call")
    row["bound_ms"], row["bound_by"], _ = row.pop("bound")
    timed["critic_stem"] = (fn, "critic_stem")
    with torch.inference_mode():
        for key, f in (("ms", fn), ("plain_ms", row.pop("plain")),
                       ("library_ms", row.pop("library"))):
            row[key] = cs.time_ms(f, flush, args.reps)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    return {"critic_stem": row}


def k4(cs, dev, g, flush, args, timed):
    import torch
    from genre_shapehd_tpu_torch.ops.cuda import chamfer_kernel as ck
    out = {}
    for b, n, m in ((8, 8192, 8192), (1, 1024, 1024)):
        x1 = torch.randn((b, n, 3), generator=g, device=dev)
        x2 = torch.randn((b, m, 3), generator=g, device=dev)
        d1, d2, _, _ = ck.nn_min_dist(x1, x2)
        r1, r2, _, _ = ck.nn_min_dist_plain(x1, x2)
        for got, want in ((d1, r1), (d2, r2)):
            cs.check(bool(((got - want).abs() <= 1e-5 + 1e-4 * want.abs())
                          .all()), f"K4 vs plain at {(b, n, m)}")
        fn = (lambda a, c: lambda: ck.nn_min_dist(a, c))(x1, x2)
        key = f"nn_min_dist_{b}x{n}x{m}"
        timed[key] = (fn, "nn_min_dist")
        bnd = cs.bound((n + m) * b * (12 + 8), 2 * 8.0 * b * n * m)
        out[key] = {"ms": cs.time_ms(fn, flush, args.reps),
                    "bound_ms": bnd[0], "bound_by": bnd[1]}
    return out


def stage2_host(cs, dev, g, flush, args, timed):
    import torch
    from genre_shapehd_tpu_torch.ops.cuda import render_kernel as rk
    v, r, s, m = (cs.MAIN[k] for k in "vrzm")
    bf = torch.bfloat16
    out = {}
    for name, fn, b in (("stage2", rk.stage2, cs.MAIN["b"]),
                        ("stage2_samples", rk.stage2_samples,
                         cs.TRAIN["batch"])):
        c = torch.rand((b, r, m, v), generator=g, device=dev).to(bf)
        for _ in range(5):                    # build, tables, first launch
            fn(c, v, r, s, m, bf)
        torch.cuda.synchronize()
        host, card = [], []
        for _ in range(7):
            t0 = time.perf_counter()
            for _ in range(args.calls):
                fn(c, v, r, s, m, bf)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            host.append((t1 - t0) / args.calls * 1e6)
            card.append((t2 - t0) / args.calls * 1e3)
        out[f"{name}_host"] = {
            "batch": b, "calls": args.calls, "host_us": host,
            "host_us_median": statistics.median(host),
            "wall_ms_per_call_median": statistics.median(card)}
    return out


def k3_host(cs, dev, g, flush, args, timed):
    import ctypes
    import torch
    from genre_shapehd_tpu_torch.ops.cuda import subpixel_kernel as sk
    b, cin, s = (cs.DEC6[k] for k in ("b", "cin", "s"))
    out = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        x = torch.randn((b, cin, s, s, s), generator=g, device=dev).to(dtype)
        w = torch.randn((cin, 1, 4, 4, 4), generator=g, device=dev) * 0.05
        bias = torch.full((1,), 0.1, device=dev)
        sk.deconv_final(x, w, bias)                   # built and loaded
        lib = sk._library()
        o = torch.empty((b, 1, 2 * s, 2 * s, 2 * s), dtype=dtype, device=dev)
        w64 = w.reshape(cin, 64).contiguous()
        entry_args = [ctypes.c_void_p(t.data_ptr()) for t in (x, w64, bias, o)]
        entry_args += [sk._DTYPE_CODE[dtype], b, cin, s, ctypes.c_void_p(
            torch.cuda.current_stream().cuda_stream)]
        fns = {
            "wrapper": lambda: sk.deconv_final(x, w, bias),
            "launch": lambda: sk._launch(x, w, bias),
            "entry": lambda: lib.deconv_final(*entry_args)}
        for fn in fns.values():
            for _ in range(5):
                fn()
        torch.cuda.synchronize()
        host = {k: [] for k in fns}
        for _ in range(7):
            for k, fn in fns.items():
                t0 = time.perf_counter()
                for _ in range(args.calls):
                    fn()
                host[k].append((time.perf_counter() - t0) / args.calls * 1e6)
                torch.cuda.synchronize()
        # one call as chip_smoke.time_ms times it: after the L2 flush is
        # queued behind a synchronize
        after_sync = {k: [] for k in fns}
        for _ in range(args.reps):
            for k, fn in fns.items():
                flush.zero_()
                t0 = time.perf_counter()
                fn()
                after_sync[k].append((time.perf_counter() - t0) * 1e6)
                torch.cuda.synchronize()
        out[f"deconv_final_{name}_host"] = {
            "calls": args.calls, "host_us": host,
            "host_us_median": {k: statistics.median(v)
                               for k, v in host.items()},
            "after_sync_us_median": {k: statistics.median(v)
                                     for k, v in after_sync.items()}}
    return out


KERNELS = {"k3_f32": k3_f32, "k3_bf16": k3_bf16, "k3_slab": k3_slab,
           "k3_host": k3_host, "critic_stem": critic_stem,
           "k4": k4, "stage2_host": stage2_host}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("kernels", nargs="+", choices=sorted(KERNELS))
    ap.add_argument("--root", default=HERE, help="checkout holding the port")
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--calls", type=int, default=100,
                    help="calls a batch for stage2_host and k3_host")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke as cs                   # this tree's helpers
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(smi("name,power.limit").splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    result = {"root": os.path.abspath(args.root), "reps": args.reps,
              "sm_clock_power_before": smi("clocks.sm,power.draw")}
    timed = {}
    for name in args.kernels:
        result.update(KERNELS[name](cs, dev, g, flush, args, timed))
    result["sm_clock_power_after"] = smi("clocks.sm,power.draw")
    for key, (fn, name) in timed.items():
        result[key]["device_ms"] = device_ms(fn, name, args.reps)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
