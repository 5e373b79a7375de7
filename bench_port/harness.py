"""The benchmark's machinery: finding a cell's files by name, the closed
loop that times a window, the result line and the checks every run makes.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

  configs/<config>.json      sizes, dtype, source, ``reduced``, ``assumed``
  workloads/<cell>.json      the cell's configuration, driver, traffic and
                             the limits of its correctness check
  drivers/<driver>.py        one per kind of traffic: ``KIND``, ``RATE``,
                             ``setup``, ``step``, ``min_iters``,
                             ``release``, ``check``, ``control`` and
                             ``trace_info`` (see ``run.py``)
  metrics/<metric>.py        ``read(summary)`` -> a number or None

This module imports no GPU library at import time.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional, Tuple

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level module names that no process of the benchmark may hold: the
#: JAX stack and the JAX package (the port's name begins with the latter's,
#: so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "genre_shapehd_tpu")
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def check_name(name: str) -> str:
    """A name from the command line or BENCHMARK.json, refused when it
    could reach outside its folder."""
    if not _NAME.match(name) or ".." in name:
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def cell_entry(bench: Dict, name: str) -> Dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def workload(name: str, bench_dir: Path = BENCH) -> Dict:
    return load_json(bench_dir / "workloads" / f"{check_name(name)}.json")


def config(name: str, bench_dir: Path = BENCH) -> Dict:
    return load_json(bench_dir / "configs" / f"{check_name(name)}.json")


def load_module(path: Path) -> ModuleType:
    """A module from its file, under a name of its own (metric files have
    dots in their names)."""
    name = "bench_port_" + re.sub(r"\W", "_", str(path.relative_to(
        path.parents[1])))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, bench_dir: Path = BENCH) -> ModuleType:
    return load_module(bench_dir / "drivers" / f"{check_name(name)}.py")


def metric_reader(name: str, bench_dir: Path = BENCH) -> ModuleType:
    return load_module(bench_dir / "metrics" / f"{check_name(name)}.py")


def cell_metrics(bench: Dict, cell: str, kind: str) -> List[Dict]:
    """The entries of ``end_to_end`` or ``per_layer`` that the cell
    reports: those without a ``workloads`` key and those that list it."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is a forbidden one, whole."""
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN)


# ------------------------------------------------------------------ timing
def closed_loop(step: Callable[[int], None], seconds: float,
                min_iters: int = 1) -> Tuple[List[float], float]:
    """One caller: ``step(i)`` runs iteration ``i`` to its end (its
    results on the host), the next starts after it.  Runs until
    ``seconds`` have passed at the end of an iteration, and at least
    ``min_iters`` iterations.  Returns every iteration's seconds and the
    window's length, from the first start to the last end."""
    lat = []
    t0 = time.perf_counter()
    i = 0
    while True:
        ts = time.perf_counter()
        step(i)
        te = time.perf_counter()
        lat.append(te - ts)
        i += 1
        if te - t0 >= seconds and i >= min_iters:
            return lat, te - t0


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile (0 < q < 100), interpolated between the two
    nearest ranks (numpy's default)."""
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


# ------------------------------------------------------------------ checks
def numbers_line(checks: Dict[str, Dict[str, float]]) -> List[str]:
    return [f"[check] {k} {v['value']!r} limit {v['limit']!r} "
            f"{'ok' if v['value'] <= v['limit'] else 'FAIL'}"
            for k, v in checks.items()]


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """Every number against its limit (a number is a gap: lower is
    better).  A number that is missing or not finite fails."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name)
        if value is None or value != value or value == float("inf"):
            value = float("inf")
        checks[name] = {"value": value, "limit": float(limit)}
        ok = ok and value <= limit
    return ok, checks


def sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_info(torch, device, count: int) -> Dict:
    """The result's ``device``; on the CPU (the tests' runs) a record
    that names it and reads no memory."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(count))}


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None
