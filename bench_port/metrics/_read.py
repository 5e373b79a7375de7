"""What the per-layer metrics share: sums of the traced stretch's
device time by span, per iteration, and the rooflines' least times."""

from typing import Optional

from cost import deconv_final, peaks, render


def idle_share(s) -> Optional[float]:
    """Per cent of the traced stretch in which no operation ran on the
    device."""
    if s["window_s"] <= 0 or s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def mfu(s) -> Optional[float]:
    """The step's model operations over its unprofiled time, as a share
    of the card's published dense peak for the configuration's type."""
    flops, dtype = s.get("flops_per_iter"), s.get("dtype", "bfloat16")
    if not flops:
        return None
    return 100.0 * flops / (s["iter_s"] * peaks.FLOPS[dtype])


def span_ms(s, names) -> Optional[float]:
    """Device ms per iteration of the operations launched inside the
    named spans (None where none of them ran)."""
    found = sum(s["span_kernel_s"].get(n, 0.0) for n in names)
    if found <= 0:
        return None
    return 1e3 * found / s["iters"]


def render_roofline(s) -> Optional[float]:
    """The renderer function's least time over the ``genre.render``
    span's length on the device."""
    calls, span = s.get("render_calls"), s["span_device_s"].get(
        "genre.render")
    if not calls or not span:
        return None
    least = sum(render.bound_s(*c) for c in calls) * s["iters"]
    return 100.0 * least / span


def deconv_final_roofline(s) -> Optional[float]:
    """K3's least time at its calls' shapes over its kernels' device
    time (kernels named ``deconv_final_*``)."""
    calls = s.get("deconv_final_calls")
    spent = sum(t for k, t in s["kernels"].items() if "deconv_final_" in k)
    if not calls or spent <= 0:
        return None
    least = sum(deconv_final.bound_s(*c) for c in calls) * s["iters"]
    return 100.0 * least / spent
