"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` over a
few iterations of the cell's own step, reduced to what the per-layer
metrics read.

Device operations (kernels, copies, sets) are attributed to the host
range that launched them: each one's CUDA runtime call, found by its
correlation id, lies inside the program's
``record_function`` spans and autograd's ``evaluate_function`` ranges.
That also catches the kernels launched through ``ctypes``, which the
profiler's own tree leaves under no operator.
"""

from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, List, Tuple

#: prefixes of the program's spans (``record_function``) that are read
SPAN_PREFIXES = ("genre.", "marrnet.", "shapehd.")
BACKWARD = "autograd::engine::evaluate_function"


def profile(torch, step: Callable[[int], None], first: int, iters: int
            ) -> Tuple[object, float]:
    """``iters`` iterations from ``first`` under the profiler; the
    profile and the stretch's seconds by the host clock."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile
    torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(iters):
            step(first + i)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    return prof, window_s


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class _Ranges:
    """Host ranges of one name, for point queries.  Ranges of one name do
    not overlap: a span is not entered inside itself, and autograd runs
    one ``evaluate_function`` at a time on its thread."""

    def __init__(self):
        self.spans: List[Tuple[int, int]] = []

    def freeze(self):
        self.spans = _merge(self.spans)
        self.starts = [s for s, _ in self.spans]

    def contains(self, t: int) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.spans[i][1]


def summarize(prof, window_s: float, iters: int) -> Dict:
    """The reduction of one profiled stretch (times in seconds)."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    cpu, dev, runtime = [], [], {}
    for e in events:
        if e.device_type() == DeviceType.CPU:
            cpu.append(e)
            name = e.name()
            if name.startswith(("cuda", "cu")) and "Launch" in name \
                    or name.startswith(("cudaMemcpy", "cudaMemset")):
                runtime[e.correlation_id()] = e
        elif e.device_type() == DeviceType.CUDA:
            dev.append(e)
    span_names = {e.name() for e in cpu
                  if e.name().startswith(SPAN_PREFIXES)}
    ops, annotations = [], []
    for e in dev:
        (annotations if e.is_user_annotation() or e.name() in span_names
         else ops).append(e)

    ranges: Dict[str, _Ranges] = {}
    for e in cpu:
        name = e.name()
        key = name if name in span_names else (
            BACKWARD if name.startswith(BACKWARD) else None)
        if key is None:
            continue
        ranges.setdefault(key, _Ranges()).spans.append(
            (e.start_ns(), e.start_ns() + e.duration_ns()))
    for r in ranges.values():
        r.freeze()

    kernels: Dict[str, float] = {}
    launched: Dict[str, float] = {k: 0.0 for k in ranges}
    unlinked = 0
    intervals = []
    for e in ops:
        sec = e.duration_ns() * 1e-9
        name = e.name()
        kernels[name] = kernels.get(name, 0.0) + sec
        intervals.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        rt = runtime.get(e.correlation_id()) or runtime.get(
            e.linked_correlation_id())
        if rt is None:
            unlinked += 1
            continue
        t = rt.start_ns()
        for key, r in ranges.items():
            if r.contains(t):
                launched[key] += sec
    span_device = {}
    for e in annotations:
        span_device[e.name()] = span_device.get(e.name(), 0.0) \
            + e.duration_ns() * 1e-9

    merged = _merge(intervals)
    busy = sum(e - s for s, e in merged) * 1e-9
    gaps = _idle_gaps(merged, cpu)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {
        "iters": iters, "window_s": window_s, "busy_s": busy,
        "kernels": kernels,
        "span_kernel_s": {k: v for k, v in launched.items()
                          if k != BACKWARD},
        "backward_kernel_s": launched.get(BACKWARD, 0.0),
        "span_device_s": span_device,
        "breakdown": {"device_ops": [[k[:160], v] for k, v in top],
                      "idle_gaps": gaps},
        "diag": {"device_ops": len(ops), "unlinked": unlinked,
                 "annotations": len(annotations),
                 "runtime_calls": len(runtime)},
    }


def _idle_gaps(merged: List[Tuple[int, int]], cpu) -> List[List]:
    """The device's idle stretches between its first and its last
    operation, summed by the innermost host operation running at each
    one's start (those under 10 us together); at most 10."""
    if len(merged) < 2:
        return []
    host = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                   for e in cpu if e.duration_ns() > 0),
                  key=lambda x: x[0])
    starts = [h[0] for h in host]
    by_name: Dict[str, float] = {}
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        gap = s1 - e0
        if gap <= 0:
            continue
        label = "gaps under 10 us"
        if gap >= 10_000:
            i = bisect.bisect_right(starts, e0)
            label, best = "none", None
            for j in range(max(0, i - 300), i):
                hs, he, hn = host[j]
                if hs <= e0 <= he and (best is None or he - hs < best):
                    label, best = hn[:160], he - hs
        by_name[label] = by_name.get(label, 0.0) + gap * 1e-9
    return [[k, v] for k, v in sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:10]]
