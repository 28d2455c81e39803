"""The program's spans and counters, on the profiler's clock.

A span is a stage of the program: its name, the op it belongs to, its
parent, its host start and end, and the stream time between two CUDA
events.  A counter adds up events of one kind: a CG's stop reason, a read
from the device to the host.  Both record only while a torch profiler runs
(``torch.profiler.profile``) or inside :func:`recording`; otherwise
:func:`span` and :func:`count` cost one test of that state, with no CUDA
event, allocation or host read.  A part of a stage, named with a dot
(``plan.dedup``, ``precond.factor``), takes its stream time only inside
:func:`recording`: under the profiler alone it keeps its host times.  A
span's two events cost ~40 us of host time beside an H100, and a predict
request would pay that for each of K3'a's ten stages on its critical path.

The host times are ``time.time_ns()``, the Unix-epoch nanoseconds on which
torch.profiler stamps its own events, so a span can be placed on a device
trace without being an event in it: no span is a ``record_function``, and
none shows on the device timeline.

    with trace.recording():
        loss = model.nlml(x, y); loss.backward()
    trace.records()   # one dict a span: name, op, parent, start_ns, end_ns, host_ms, ms, self_ms
    trace.counters()  # {"cg.stop.tolerance": 1, "host_read.cg_stop": 23, ...}

The top-level spans (``nlml``, ``backward``, ``posterior_cache``,
``predict``) each start an op; every span opened inside one shares its op
id, and ``backward`` takes the op id of its forward.  A span opened inside a
span of the same name is that span (a plan builder that calls another
records one ``plan``).  Spans are kept in memory until :func:`clear`.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Optional

import torch
from torch.autograd import profiler as _profiler

__all__ = ["span", "count", "recording", "records", "counters", "clear"]

_spans: list = []  # every span opened while recording, in the order opened
_counts: dict = {}
_lock = threading.Lock()  # the autograd engine's threads count too
_ops = itertools.count(1)
_local = threading.local()  # this thread's open spans, innermost last
_recording = 0  # the depth of recording() blocks


def _on() -> bool:
    return _recording > 0 or _profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "op", "parent", "t0", "t1", "ev0", "ev1")

    def __init__(self, name: str, op: int, parent):
        self.name, self.op, self.parent = name, op, parent
        self.t1 = self.ev0 = self.ev1 = None

    def __enter__(self) -> "_Span":
        _spans.append(self)
        _stack().append(self)
        # A part of a stage (a dotted name) takes CUDA events only inside recording() (module docstring).
        self.ev0 = _event() if _recording > 0 or "." not in self.name else None
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.time_ns()
        if self.ev0 is not None:
            self.ev1 = _event()
        _stack().pop()


class _Off:
    """What :func:`span` gives when nothing records, or inside a span of the same name."""

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _event():
    """A timing event recorded on the current stream, when that is a card's and no graph is being captured."""
    if not torch.cuda.is_initialized() or torch.cuda.is_current_stream_capturing():
        return None
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def span(name: str, op: Optional[int] = None):
    """A context manager around one stage; ``as s`` gives the span (its ``op``), or None when nothing records.

    ``op`` names the op the span belongs to (a backward its forward's);
    without it the span joins the op of the span around it, or starts one.
    """
    if not _on():
        return _OFF
    stack = _stack()
    parent = stack[-1] if stack else None
    if parent is not None and parent.name == name:
        return _OFF
    if op is None:
        op = parent.op if parent is not None else next(_ops)
    return _Span(name, op, parent)


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to the counter ``name``, when recording."""
    if _on():
        with _lock:
            _counts[name] = _counts.get(name, 0) + k


@contextlib.contextmanager
def recording():
    """Record spans and counters inside the block, whether or not a profiler runs."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def records() -> list:
    """The closed spans, in the order opened: ``name``, ``op``, ``parent`` (an index into this list, or None),
    ``start_ns`` and ``end_ns`` (host, the profiler's clock), ``host_ms``, ``ms`` (stream time between the span's
    CUDA events; None without them), ``self_ms`` (``ms`` less the ``ms`` of its children that have one).  Each
    span's events are resolved now, waiting for the card where they are not complete."""
    closed = [s for s in _spans if s.t1 is not None]
    index = {id(s): i for i, s in enumerate(closed)}
    out = []
    for s in closed:
        ms = None
        if s.ev1 is not None:
            s.ev1.synchronize()
            ms = s.ev0.elapsed_time(s.ev1)
        out.append({"name": s.name, "op": s.op, "parent": index.get(id(s.parent)), "start_ns": s.t0,
                    "end_ns": s.t1, "host_ms": 1e-6 * (s.t1 - s.t0), "ms": ms, "self_ms": ms})
    for r in out:
        if r["parent"] is not None and r["ms"] is not None and out[r["parent"]]["self_ms"] is not None:
            out[r["parent"]]["self_ms"] -= r["ms"]
    return out


def counters() -> dict:
    """The counters, by name."""
    return dict(_counts)


def clear() -> None:
    """Drop every span and counter recorded so far."""
    _spans.clear()
    _counts.clear()
