"""The readers of the program's spans and counters (gpbench/program_spans.py) on the CPU.

The window is recorded under ``simplex_gp_torch.trace.recording()`` here, and
the stream times that the card gives are stood in for by fixed ones.
"""

import sys

import pytest
import torch

from gpbench import run

NAMES = ["plan_ms.train", "precond_ms.train", "cg_ms.train", "slq_ms.train", "host_reads.train", "sketch_ms.cache",
         "predict_ms.cache", "cg_stalled.cache"]


def _window(ms):
    from simplex_gp_torch import trace
    from simplex_gp_torch.linalg.mll import BBMMConfig
    from simplex_gp_torch.models.exact_gp import SimplexGP

    g = torch.Generator().manual_seed(0)
    x, y = torch.randn(200, 3, generator=g), torch.randn(200, generator=g)
    model = SimplexGP(3, kernel="matern", order=1, bbmm=BBMMConfig(precond_rank=8, num_probes=3,
                                                                   max_lanczos_iterations=8))
    trace.clear()
    with trace.recording():
        for _ in range(2):
            model.nlml(x, y, generator=g).backward()
            model.predict_from_cache(model.posterior_cache(x, y, generator=g), x, x[:20])
    records = trace.records()
    for r in records:
        r["ms"] = ms
    return trace, records


def test_readers_sum_the_window_per_op(monkeypatch):
    trace, records = _window(1.5)
    monkeypatch.setattr(trace, "records", lambda: records)
    ctx = {"ops": 2}
    got = {name: run.reader(name)(ctx) for name in NAMES}
    count = lambda name: sum(r["name"] == name for r in records)
    assert got["plan_ms.train"] == 1.5 * count("plan") / 2 and count("plan") == 8  # nlml, fit, sketch, predict
    for name in ("precond", "cg", "slq", "sketch", "predict"):
        assert got[f"{name}_ms.train" if f"{name}_ms.train" in got else f"{name}_ms.cache"] == 1.5 * count(name) / 2
    counters = ctx["program_trace"]["counters"]
    assert got["host_reads.train"] == sum(v for k, v in counters.items() if k.startswith("host_read.")) / 2
    assert got["cg_stalled.cache"] == 100.0 * counters.get("cg.stop.stall", 0) / 4
    assert trace.counters() == {}  # read once, then cleared


def test_readers_read_nothing_without_stream_times_or_the_module(monkeypatch):
    trace, records = _window(None)
    monkeypatch.setattr(trace, "records", lambda: records)
    ctx = {"ops": 2}
    assert run.reader("plan_ms.train")(ctx) is None and run.reader("host_reads.train")(ctx) > 0
    monkeypatch.setitem(sys.modules, "simplex_gp_torch.trace", None)  # a tree before the module
    monkeypatch.delattr(sys.modules["simplex_gp_torch"], "trace")
    assert all(run.reader(name)({"ops": 2}) is None for name in NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_recorded_reads_nothing(name):
    from simplex_gp_torch import trace

    trace.clear()
    assert run.reader(name)({"ops": 3}) is None
