"""The program's spans and counters (simplex_gp_torch/trace.py) on a small table.

The CPU tests check the span tree and op ids of a training step, a
posterior fit and a predict, that nothing records without a profiler or
``trace.recording()``, that recording changes no result bit, that the spans
share torch.profiler's clock, and that each CG solve counts one stop
reason, the one its result gives.  The card tests (``-m cuda``, no jax
imported) check K3'a's stage spans and the spans' stream times:

    python -m pytest tests/test_torch_trace.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch
from torch_parity import cuda_device  # noqa: F401 (fixture)

from simplex_gp_torch import trace
from simplex_gp_torch.kernels import chain as t_chain
from simplex_gp_torch.linalg.cg import cg_solve
from simplex_gp_torch.linalg.mll import BBMMConfig
from simplex_gp_torch.models.exact_gp import SimplexGP
from simplex_gp_torch.ops.lattice import apply_plan_chain, build_plan_chain

N, D, P = 240, 3, 4
STAGES = ["dedup", "read", "unique sort", "rank", "rank sort", "place", "rows", "axis sort", "finish", "run lists"]


@pytest.fixture(autouse=True)
def fresh_trace():
    trace.clear()
    yield
    trace.clear()


def _table(device="cpu"):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32)).to(device)
    y = torch.sin(x.sum(dim=1)) + 0.1 * torch.from_numpy(rng.normal(size=N).astype(np.float32)).to(device)
    probes = torch.from_numpy(rng.choice([-1.0, 1.0], size=(N, P)).astype(np.float32)).to(device)
    omega = torch.from_numpy(rng.normal(size=(N, 16)).astype(np.float32)).to(device)
    return x, y, probes, omega


def _model(device="cpu"):
    bbmm = BBMMConfig(precond_rank=12, num_probes=P, max_lanczos_iterations=16)
    return SimplexGP(D, kernel="matern", nu=1.5, order=1, min_noise=0.1, bbmm=bbmm, device=device)


def _step_fit_request(device="cpu") -> dict:
    """A training step (loss and gradients), a posterior fit and a predict, as the benchmark's three cells
    drive them."""
    x, y, probes, omega = _table(device)
    model = _model(device)
    stats = {}
    loss = model.nlml(x, y, probes=probes, stats=stats)
    loss.backward()
    grads = {k: v.grad.clone() for k, v in model.raw().items()}
    cache = model.posterior_cache(x, y, omega=omega)
    mean, var = model.predict_from_cache(cache, x, x[:40] + 0.05)
    return {"loss": loss.detach(), **grads, "alpha": cache["alpha"], "root": cache["root_inv"], "mean": mean,
            "var": var}


def _children(recs, i) -> list:
    return [r["name"] for r in recs if r["parent"] == i]


def test_span_tree_and_op_ids_of_a_step_a_fit_and_a_request():
    with trace.recording():
        _step_fit_request()
    recs = trace.records()
    tops = [(i, r["name"]) for i, r in enumerate(recs) if r["parent"] is None]
    assert [name for _, name in tops] == ["nlml", "backward", "posterior_cache", "predict"]
    (nlml, _), (backward, _), (fit, _), (predict, _) = tops
    assert _children(recs, nlml) == ["plan", "precond", "cg", "slq"]
    assert _children(recs, backward) == []
    assert _children(recs, fit) == ["plan", "precond", "cg", "sketch"]
    assert _children(recs, predict) == ["plan"]
    for i, r in enumerate(recs):
        if r["name"] == "precond":
            assert _children(recs, i) == ["precond.factor", "precond.make"]
        if r["name"] == "sketch":
            assert _children(recs, i) == ["plan"]
        if r["parent"] is not None:
            assert r["op"] == recs[r["parent"]]["op"]
            assert recs[r["parent"]]["start_ns"] <= r["start_ns"] <= r["end_ns"] <= recs[r["parent"]]["end_ns"]
        assert r["host_ms"] >= 0 and r["ms"] is None and r["self_ms"] is None  # no CUDA events on the CPU
    ops = [recs[i]["op"] for i, _ in tops]
    assert ops[1] == ops[0] and len(set(ops)) == 3  # the backward carries its forward's op
    counts = trace.counters()
    assert sum(v for k, v in counts.items() if k.startswith("cg.stop.")) == sum(r["name"] == "cg" for r in recs) == 2
    assert counts["host_read.cg_state"] == 2 and counts["host_read.cg_res"] == 1 and counts["host_read.cg_stop"] > 2


def test_nothing_recorded_without_a_profiler_or_recording(monkeypatch):
    events = []
    monkeypatch.setattr(trace, "_event", lambda: events.append(1))
    _step_fit_request()
    assert trace.records() == [] and trace.counters() == {} and events == []
    with trace.recording():
        _step_fit_request()
    assert trace.records() and trace.counters() and len(events) == len(trace.records())
    trace.clear()
    events.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _step_fit_request()
    stages = [r["name"] for r in trace.records() if "." in r["name"]]
    assert stages == ["precond.factor", "precond.make"] * 2 and trace.counters()
    assert len(events) == len(trace.records()) - len(stages)  # the parts of a stage are timed by the host alone


def test_recording_changes_no_result_bit():
    off = _step_fit_request()
    with trace.recording():
        on = _step_fit_request()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiled = _step_fit_request()
    assert trace.records()
    for k in off:
        assert torch.equal(off[k], on[k]) and torch.equal(off[k], profiled[k]), k


def test_spans_share_the_profilers_clock():
    x, y, _, _ = _table()
    model = _model()
    with torch.no_grad():
        params = model.constrained()
        plan = build_plan_chain(x * params["inv_ell"], model.dk.coeffs, model.dk.variance)
    mv = lambda v: params["outputscale"] * apply_plan_chain(plan, v, model.dk.coeffs) + params["noise"] * v
    b = y[:, None]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.ones(8).add_(1)
        with torch.profiler.record_function("test.cg"):
            cg_solve(mv, b, tol=1e-3)
        torch.ones(8).add_(1)
    (cg,) = [r for r in trace.records() if r["name"] == "cg"]
    events = [e for e in prof.profiler.kineto_results.events() if e.device_type() == torch.autograd.DeviceType.CPU]
    (outer,) = [e for e in events if e.name() == "test.cg"]
    lo, hi = outer.start_ns(), outer.start_ns() + outer.duration_ns()
    assert lo <= cg["start_ns"] <= cg["end_ns"] <= hi
    inside = [e for e in events if e.name().startswith("aten::") and lo < e.start_ns() < hi]
    outside = [e for e in events if e.name().startswith("aten::") and not lo <= e.start_ns() <= hi]
    assert len(inside) > 20 and outside
    assert all(cg["start_ns"] <= e.start_ns() <= cg["end_ns"] for e in inside)
    assert not any(cg["start_ns"] <= e.start_ns() <= cg["end_ns"] for e in outside)


def _spd(n=60, t=3, seed=5):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    A = (q * np.geomspace(1.0, 1e3, n)) @ q.T
    return torch.from_numpy(A.astype(np.float32)), torch.from_numpy(rng.normal(size=(n, t)).astype(np.float32))


@pytest.mark.parametrize("reason,kw", [
    ("tolerance", dict(tol=1e-2)),
    ("max_iters", dict(tol=1e-6, max_iters=4)),
    ("stall", dict(tol=1e-12, max_iters=400, stall_window=3)),
])
def test_each_solve_counts_its_stop_reason_once(reason, kw):
    A, b = _spd()
    with trace.recording():
        res = cg_solve(lambda v: A @ v, b, **kw)
    assert res.stop == reason
    assert [r["name"] for r in trace.records()] == ["cg"]
    assert {k: v for k, v in trace.counters().items() if k.startswith("cg.stop.")} == {f"cg.stop.{reason}": 1}
    assert trace.counters()["host_read.cg_stop"] == res.iterations + 1
    if reason == "max_iters":
        assert res.iterations == 4


def test_a_span_inside_one_of_the_same_name_is_that_span():
    with trace.recording():
        with trace.span("plan") as outer:
            with trace.span("plan") as inner:
                with trace.span("plan.read"):
                    trace.count("host_read.x", 2)
        with trace.span("backward", op=outer.op):
            pass
    assert inner is None
    recs = trace.records()
    assert [(r["name"], r["parent"], r["op"]) for r in recs] == [("plan", None, outer.op), ("plan.read", 0, outer.op),
                                                                  ("backward", None, outer.op)]
    assert trace.counters() == {"host_read.x": 2}


@pytest.mark.cuda
def test_chain_build_stage_times_on_the_card(cuda_device):
    x, _, _, _ = _table(cuda_device)
    model = _model(cuda_device)
    build = lambda: build_plan_chain(x, model.dk.coeffs, model.dk.variance)
    build()
    stages = t_chain.chain_build_stage_times(build)
    assert list(stages) == STAGES
    assert all(set(v) == {"device_ms", "host_ms"} and v["device_ms"] >= 0 and v["host_ms"] >= 0
               for v in stages.values())


@pytest.mark.cuda
def test_spans_time_the_stream_on_the_card(cuda_device):
    _step_fit_request(cuda_device)  # builds and warms the kernels
    off = _step_fit_request(cuda_device)
    with trace.recording():
        on = _step_fit_request(cuda_device)
    torch.cuda.synchronize()
    for k in off:
        assert torch.equal(off[k], on[k]), k
    recs = trace.records()
    assert all(r["ms"] is not None and r["ms"] >= 0 for r in recs)
    plans = [i for i, r in enumerate(recs) if r["name"] == "plan" and recs[r["parent"]]["name"] == "nlml"]
    assert [_children(recs, i) for i in plans] == [["plan." + s for s in STAGES]]
    for i, r in enumerate(recs):
        kids = [c["ms"] for c in recs if c["parent"] == i]
        assert r["self_ms"] == pytest.approx(r["ms"] - sum(kids), abs=1e-6)
    assert trace.counters()["host_read.chain_build"] == 2  # the step's and the fit's chain plans (the rest join)
