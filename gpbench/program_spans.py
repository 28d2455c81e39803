"""The program's own spans and counters of a ``--trace 1`` window, for the readers.

The program (``simplex_gp_torch/trace.py``) records while torch.profiler
runs, so what it holds after the window is what the window's ops recorded:
the benchmark's Tracer starts and stops the recording.  It is read once per
run, after the Tracer's closing synchronise, and cleared.  A tree without
that module, or a run that recorded nothing, gives None, and every reader
built on it reads nothing.
"""

from __future__ import annotations

__all__ = ["window", "span_ms", "counter_total"]


def window(ctx: dict):
    """``{"spans": [...], "counters": {...}}`` of the window (``simplex_gp_torch.trace.records()`` and
    ``counters()``), or None."""
    if "program_trace" not in ctx:
        try:
            from simplex_gp_torch import trace
        except ImportError:  # a tree before the program's trace module
            ctx["program_trace"] = None
        else:
            spans, counters = trace.records(), trace.counters()
            trace.clear()
            ctx["program_trace"] = {"spans": spans, "counters": counters} if spans or counters else None
    return ctx["program_trace"]


def span_ms(ctx: dict, name: str):
    """The stream ms of the spans named ``name``, summed over the window, per op; None without such a span."""
    w = window(ctx)
    ms = [s["ms"] for s in w["spans"] if s["name"] == name] if w else []
    if not ms or any(m is None for m in ms):
        return None
    return sum(ms) / ctx["ops"]


def counter_total(ctx: dict, prefix: str):
    """The sum of the counters whose names start with ``prefix``, or None without a recording."""
    w = window(ctx)
    return sum(v for k, v in w["counters"].items() if k.startswith(prefix)) if w else None
