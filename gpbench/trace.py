"""The device trace of a ``--trace 1`` window: torch.profiler's events reduced to what the readers need.

Device intervals are the kernels, memory copies and memsets on the card.
``busy_s`` is the length of their union inside the window; ``kernels`` sums
each kernel's device time by name; ``gaps`` are the idle stretches between
device intervals, each labelled by what the host was doing at its start: the
innermost of the benchmark's own spans (``gpbench.*``) and the innermost
other host operation.
"""

from __future__ import annotations

import re

import torch

__all__ = ["Tracer", "kernel_seconds"]


def _short(name: str) -> str:
    """A kernel's name without its return type, template arguments and parameters."""
    name = re.sub(r"^void\s+", "", name)
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip() or name[:64]


def kernel_seconds(kernels: dict, names) -> float:
    """The device seconds of the kernels whose short name is one of ``names``."""
    return sum(s for k, s in kernels.items() if k in names)


class Tracer:
    """torch.profiler over the window (CPU and CUDA activities), which the caller marks with a span named
    ``gpbench.window``; :meth:`summary` after :meth:`stop`."""

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def summary(self) -> dict:
        events = self.prof.profiler.kineto_results.events()
        dev, host = [], []
        for e in events:
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if e.name().startswith("gpbench."):  # a span's mirror on the device timeline, not device work
                    continue
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
            elif e.duration_ns() > 0:
                host.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        if not dev:
            return {}
        # The window: the benchmark's span around it, on the profiler's own clock.
        lo, hi = next(((a, b) for a, b, name in host if name == "gpbench.window"), (0, 0))
        if hi <= lo:
            return {}
        kernels, merged = {}, []
        for a, b, name in sorted(dev):
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            key = _short(name)
            kernels[key] = kernels.get(key, 0.0) + (b - a) * 1e-9
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        if not merged:
            return {}
        busy = sum(b - a for a, b in merged)
        gaps = [(a, b) for a, b in zip([lo] + [m[1] for m in merged], [m[0] for m in merged] + [hi]) if b > a]
        top = sorted(gaps, key=lambda g: g[0] - g[1])[:200]
        labels = {}
        for (a, b), label in zip(sorted(top), self._labels(host, sorted(a for a, _ in top))):
            labels[label] = labels.get(label, 0.0) + (b - a) * 1e-9
        return {"busy_s": busy * 1e-9, "window_s": (hi - lo) * 1e-9, "kernels": kernels,
                "idle_gaps": [[k, v] for k, v in sorted(labels.items(), key=lambda kv: -kv[1])[:10]],
                "device_ops": [[k, v] for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:10]]}

    @staticmethod
    def _labels(host: list, times: list) -> list:
        """For each of the sorted ``times``: the innermost gpbench span and the innermost other host operation
        running then."""
        host.sort()
        out, active, j = [], [], 0
        for t in times:
            while j < len(host) and host[j][0] <= t:
                active.append(host[j])
                j += 1
            active = [h for h in active if h[1] >= t]
            span = max((h for h in active if h[2].startswith("gpbench.")), default=None)
            op = max((h for h in active if not h[2].startswith("gpbench.")), default=None)
            out.append("/".join(h[2] for h in (span, op) if h) or "outside spans")
        return out
