"""Host cost of one call of the port's renderer stage-2 wrappers on the card.

Times how long ``render_kernel.stage2`` (K2, batch 8) and
``render_kernel.stage2_samples`` (K5, batch 4) take to return on the host
at the main path's shapes (V 128, R 128, S 256, M 192, bf16 c): the
Python wrapper, its plan and table lookups, the ctypes call and the
launch, not the kernel.  Each timed batch enqueues CALLS calls after a
synchronize, fewer than the launch queue holds, so the host never waits
for the card inside it; the card's time per call is printed beside it.

Run from the repository root, for this tree or for another checkout of
the port (e.g. an unpacked ``git archive`` of an earlier commit):

    python3 tools/time_stage2_host.py [--root DIR] [--calls 100] [--reps 7]

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout holding the port")
    ap.add_argument("--calls", type=int, default=100)
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    from genre_shapehd_tpu_torch.ops.cuda import render_kernel as rk
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    v, r, s, m, bf = 128, 128, 256, 192, torch.bfloat16
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    result = {"root": os.path.abspath(args.root), "calls": args.calls}
    for name, fn, b in (("stage2", rk.stage2, 8),
                        ("stage2_samples", rk.stage2_samples, 4)):
        c = torch.rand((b, r, m, v), generator=g, device=dev).to(bf)
        for _ in range(5):                    # build, tables, first launch
            fn(c, v, r, s, m, bf)
        torch.cuda.synchronize()
        host, card = [], []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            for _ in range(args.calls):
                fn(c, v, r, s, m, bf)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            host.append((t1 - t0) / args.calls * 1e6)
            card.append((t2 - t0) / args.calls * 1e3)
        result[name] = {"batch": b, "host_us": host,
                        "host_us_median": statistics.median(host),
                        "wall_ms_per_call_median": statistics.median(card)}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
