"""Run one cell of the port's benchmark once.

  python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \\
      --trace <0|1>

Set-up (timed as ``setup_s``): the cell's model built from its command
line by the port's own option parser, weights and inputs made on the
device from the seed, every shape of the cell warmed up.  Then one
caller drives the cell's step in a closed loop for ``--seconds``.  With
``--trace 0`` the last line of standard output holds the cell's
end-to-end metrics; with ``--trace 1`` a profiled stretch follows the
window and the line holds the per-layer metrics instead.  After the
window the program's outputs (inference) or its first steps (training)
are held against the plain reference in ``reference/``; each number
compared is printed beside its limit, as the last lines of standard
error and under ``checks``, the last key of the line.

Exits non-zero, printing no result, when no CUDA device (or fewer than
the cell asks for) is present, and when the process holds a module of
JAX or of the JAX package after the window.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

import harness  # noqa: E402

# every build and kernel cache inside the checkout, at fixed paths (the
# port builds its kernels into build/kernels/ of the checkout itself)
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True, type=harness.check_name)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def e2e_values(drv, items: int, lat, window_s: float, peak: int) -> dict:
    """The window's rate (under the driver's ``RATE`` name), its 95th
    percentile of batch latency where it serves batches, the peak."""
    vals = {"peak_mem_gib": peak / 2 ** 30,
            drv.RATE: items * len(lat) / window_s}
    if drv.KIND == "infer":
        vals["recon_p95_ms"] = harness.percentile(lat, 95) * 1e3
    return vals


def run_cell(args, bench: dict, device, t0: float = _T0, wl=None,
             cfg=None):
    """Set-up, window, [trace], check: the cell's result line as a dict
    (``checks`` its last key).  ``device`` is the chip, or the CPU in the
    tests, which drive every part of a run but the look for a chip, on
    a workload and a configuration of their own (``wl``, ``cfg``)."""
    import torch
    cell = harness.cell_entry(bench, args.workload)
    wl = wl or harness.workload(args.workload)
    cfg = cfg or harness.config(cell["config"])
    drv = harness.driver(wl["driver"])
    state = drv.setup(dict(torch=torch, cfg=cfg, wl=wl, seed=args.seed,
                           device=device))
    harness.sync(torch, device)
    setup_s = time.perf_counter() - t0

    def step(i):
        drv.step(state, i)

    lat, window_s = harness.closed_loop(step, args.seconds,
                                        drv.min_iters(state))
    items = wl["batch"]
    summary = None
    if args.trace:
        import profiling
        prof, traced_s = profiling.profile(torch, step, len(lat),
                                           wl["trace_iters"])
        summary = profiling.summarize(prof, traced_s, wl["trace_iters"])
        del prof
    device_rec = harness.device_info(torch, device, cell["chips"])
    peak = device_rec["memory_peak_bytes"]
    drv.release(state)
    if device.type == "cuda":
        torch.cuda.empty_cache()

    numbers = drv.check(state)
    ok, checks = harness.judge(numbers, wl["limits"])
    if args.trace:
        summary.update(drv.trace_info(state))
        summary.update(iter_s=window_s / len(lat), items_per_iter=items)
        metrics = {}
        for m in harness.cell_metrics(bench, args.workload, "per_layer"):
            value = harness.metric_reader(m["name"]).read(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_rec.update(busy_s=summary["busy_s"],
                          window_s=summary["window_s"])
        print(f"[trace] {json.dumps(summary['diag'])} power "
              f"{harness.power_limit()}", file=sys.stderr)
    else:
        vals = e2e_values(drv, items, lat, window_s, peak)
        vals["setup_s"] = setup_s
        metrics = {m["name"]: {"value": vals[m["name"]], "unit": m["unit"]}
                   for m in harness.cell_metrics(bench, args.workload,
                                                 "end_to_end")}
    result = {"correct": ok, "attempted": items * len(lat), "failed": 0,
              "metrics": metrics, "device": device_rec}
    if args.trace:
        result["breakdown"] = summary["breakdown"]
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse(argv)
    bench = harness.benchmark()
    chips = harness.cell_entry(bench, args.workload)["chips"]
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"no result: {chips} CUDA device(s) needed, {have} present",
              file=sys.stderr)
        return 2
    result = run_cell(args, bench, torch.device("cuda", 0))
    found = harness.forbidden_modules()
    if found:
        print(f"no result: the process holds {found}", file=sys.stderr)
        return 3
    for line in harness.numbers_line(result["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
