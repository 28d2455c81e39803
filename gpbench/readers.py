"""What the metric readers share: means of spans and counters, device time by kernel name, least times.

A reader takes the run's context (``ctx``: the cell, its spans and counters
of the window, the op count, the window's host seconds, the trace summary and
each traced op's bytes and operations) and returns a number, or None when it
finds nothing to read (no trace, no kernel of its names, no cost of its kind).
"""

from __future__ import annotations

import statistics

from .counts import least_s
from .trace import kernel_seconds

__all__ = ["mean_span_ms", "mean_counter", "device_ms", "roofline_pct", "mfu_pct", "idle_pct", "p95"]


def mean_span_ms(ctx: dict, name: str):
    spans = ctx["spans"].get(name)
    return 1e3 * statistics.fmean(spans) if spans else None


def mean_counter(ctx: dict, name: str):
    values = ctx["counters"].get(name)
    return statistics.fmean(values) if values else None


def device_ms(ctx: dict, names) -> float:
    """Device ms per op in the kernels of ``names``, or None without a trace or such a kernel."""
    kernels = ctx["trace"].get("kernels")
    if not kernels:
        return None
    s = kernel_seconds(kernels, names)
    return 1e3 * s / ctx["ops"] if s > 0 else None


def roofline_pct(ctx: dict, kind: str, names):
    """The least time of the ops' ``kind`` work (their bytes and operations) over the device time of the
    kernels of ``names``, in %."""
    kernels = ctx["trace"].get("kernels")
    costs = [c[kind] for c in ctx.get("costs", []) if kind in c]
    if not kernels or not costs:
        return None
    s = kernel_seconds(kernels, names)
    if s <= 0:
        return None
    return 100.0 * sum(least_s(*c) for c in costs) / s


def mfu_pct(ctx: dict):
    """The traced ops' least time on the chip (the larger of all their bytes over the memory rate and all their
    operations over the float32 rate) over the traced window, in %."""
    costs = [c["total"] for c in ctx.get("costs", [])]
    t = ctx["trace"]
    if not costs or not t:
        return None
    return 100.0 * least_s(sum(c[0] for c in costs), sum(c[1] for c in costs)) / t["window_s"]


def idle_pct(ctx: dict):
    t = ctx["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t else None


def p95(values) -> float:
    """The nearest-rank 95th percentile."""
    v = sorted(values)
    return v[max(0, -(-95 * len(v) // 100) - 1)]
