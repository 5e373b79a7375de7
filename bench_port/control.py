"""The readings a cell's limits are set from: for each seed, one set-up
and a short window of the cell, then the numbers of the program's check
(the lower readings) and of its control, the reference in fp8 in the
program's place (the upper readings).  One JSON line per seed.

  python3 bench_port/control.py --workload <cell> --seconds <s> \\
      --seeds <n> [<n> ...]

Not part of a benchmark run.  ``tests/test_bench_port_cells.py``
(``test_the_control_is_not_correct``) runs the same at a size the CPU
holds.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import harness  # noqa: E402


def readings(name: str, seed: int, seconds: float, device, wl=None,
             cfg=None) -> dict:
    """The program's numbers and the control's for one seed."""
    import torch
    bench = harness.benchmark()
    cell = harness.cell_entry(bench, name)
    wl = wl or harness.workload(name)
    cfg = cfg or harness.config(cell["config"])
    drv = harness.driver(wl["driver"])
    t0 = time.perf_counter()
    st = drv.setup(dict(torch=torch, cfg=cfg, wl=wl, seed=seed,
                        device=device))
    harness.closed_loop(lambda i: drv.step(st, i), seconds,
                        drv.min_iters(st))
    drv.release(st)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": seed, "program": drv.check(st),
           "control": drv.control(st),
           "seconds": time.perf_counter() - t0}
    del st
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True, type=harness.check_name)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.seconds,
                                  torch.device("cuda", 0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
