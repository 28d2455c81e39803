"""The benchmark's harness on the CPU at tiny sizes: lookup by name, inputs, counts, the reference, the checks.

The program runs here on its plain twins; the reference beside it is plain
PyTorch.  The card's run is the last test, skipped without a card.
"""

import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpbench import cell, faults, record, run
from gpbench import counts as C
from gpbench.data import Strata
from gpbench.recipes.synthetic_uci import make_data, split_sizes

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
TINY = {"houseelectric": {"n": 2500, "plan_capacity": None}, "elevators": {"n": 1500}}
# The replays cut to the tiny trajectories' 4 steps: train from their starts, fits and serving at later points.
TINY_REPLAY = {"train": {"first": 0, "last": 3}, "fit": {"first": 1, "last": 4}, "predict": {"first": 4, "last": 4}}
SEED = 2 ** 31 + 977


def config_of(workload: str) -> str:
    return next(w["config"] for w in BENCH["workloads"] if w["name"] == workload)


def tiny(workload: str) -> dict:
    return TINY[config_of(workload)]


def tiny_traffic(workload: str) -> dict:
    t = run.spec(workload)["traffic"]
    return {"replay": {**t["replay"], **TINY_REPLAY[t["op"]]}}


def run_tiny(workload: str, **kw) -> dict:
    return run.run_cell(workload, SEED, 0.5, False, "cpu", tiny(workload), traffic_overrides=tiny_traffic(workload),
                        **kw)


@pytest.fixture(scope="session", autouse=True)
def tiny_trajectories(tmp_path_factory):
    """Each configuration's trajectory recorded by gpbench.record at its tiny size, 4 steps, in place of the
    committed ones."""
    where = tmp_path_factory.mktemp("trajectories")
    for name, over in TINY.items():
        cfg = {**json.loads((cell.HERE / "configs" / f"{name}.json").read_text()), **over}
        (where / f"{name}.json").write_text(json.dumps(record.record(cfg, 4, 0, "cpu")))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cell, "TRAJECTORIES", where)
        yield where


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_found_by_name(workload):
    s = run.spec(workload)
    assert issubclass(cell.load("drivers", s["traffic"]["op"]).Driver, cell.Cell)
    assert callable(cell.load("recipes", s["config"]["data"]).make)
    assert callable(cell.load("models", s["config"]["model"]).build)
    assert {"n", "d", "kernel", "nu", "order", "points"} <= set(s["config"])
    rep = s["traffic"]["replay"]
    traj = json.loads((cell.HERE / "trajectories" / f"{rep['trajectory']}.json").read_text())
    assert traj["config"] == s["config"]["name"] and traj["n"] == s["config"]["n"]
    assert 0 <= rep["first"] <= rep["last"] < len(traj["points"])
    assert all(math.isfinite(v) for v in traj["loss"])
    cap = s["config"]["plan_capacity"]
    assert cap is None or max(traj["n_lattice"]) <= cap
    for m in s["end_to_end"] + s["per_layer"]:
        assert callable(run.reader(m["name"]))
    assert {"setup_s", "peak_gb"} <= {m["name"] for m in s["end_to_end"]} and s["per_layer"]


@pytest.mark.parametrize("kind", ["drivers", "recipes", "models"])
def test_every_module_of_a_kind_loads_by_name(kind):
    names = sorted(p.stem for p in (cell.HERE / kind).glob("*.py") if p.stem != "__init__")
    assert names
    for name in names:
        mod = cell.load(kind, name)
        assert hasattr(mod, {"drivers": "Driver", "recipes": "make", "models": "build"}[kind])
    with pytest.raises(ValueError):
        cell.load(kind, "../run")


def test_every_metric_and_config_is_used():
    names = set(WORKLOADS)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", names)) <= names
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("n", [2049280, 16599, 200, 1001])
def test_split_sizes_match_the_program(n):
    from simplex_gp_torch.utils.data import prepare_dataset

    ds = prepare_dataset(np.random.default_rng(0).normal(size=(n, 3)).astype(np.float32))
    assert split_sizes(n) == (ds.train_x.shape[0], ds.val_x.shape[0], ds.test_x.shape[0])


def test_published_splits():
    assert split_sizes(2049280) == (1311539, 327885, 409856)
    assert split_sizes(16599) == (10623, 2656, 3320)


def test_data_recipe_shapes_and_seed():
    a, b, c = (make_data(1000, 5, "cpu", s) for s in (0, 0, 1))
    assert a["train_x"].shape == (640, 5) and a["val_x"].shape == (160, 5) and a["test_x"].shape == (200, 5)
    assert torch.allclose(a["train_x"].mean(0), torch.zeros(5), atol=1e-5)
    assert torch.allclose(a["train_x"].std(0, unbiased=False), torch.ones(5), atol=1e-4)
    assert all(a[k] == b[k] if k == "median_lengthscale" else torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["train_x"], c["train_x"])


def test_strata_same_values_other_order():
    s1, s2, s3 = (Strata(-0.1, 0.1, 3, s, "x") for s in (SEED, SEED, SEED + 1))
    d1, d2, d3 = ([s.draw() for _ in range(64)] for s in (s1, s2, s3))
    assert all(np.array_equal(u, v) for u, v in zip(d1, d2))
    assert not all(np.array_equal(u, v) for u, v in zip(d1, d3))
    assert np.allclose(np.sort(np.stack(d1)[:, 0]), np.sort(np.stack(d3)[:, 0]))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_traffic_deterministic_for_a_seed(workload):
    s = run.spec(workload)
    cfg = {**s["config"], **tiny(workload)}
    traffic = {**s["traffic"], **tiny_traffic(workload)}

    def ops(seed):
        c = cell.load("drivers", traffic["op"]).Driver(cfg, traffic, seed, "cpu", False)
        c.setup()
        for _ in range(3):
            c.op()
        rows = [r["rows"] if "rows" in r else r["raw"] if "raw" in r else r for r in c.records]
        return [torch.as_tensor(np.concatenate([np.ravel(np.asarray(v)) for v in r.values()]) if isinstance(r, dict)
                                else r).float() for r in rows]

    a, b, c = ops(SEED), ops(SEED), ops(SEED + 1)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not all(u.shape == v.shape and torch.equal(u, v) for u, v in zip(a, c))


def test_counts_match_the_recorded_bounds():
    n, d, c, nl = 1311539, 11, 11, 19919
    assert round(1e3 * C.least_s(*C.factor_cost(n, d, 100)), 2) == 9.94  # K6's factor at houseelectric
    assert round(1e3 * C.least_s(*C.slice_cost(n, d + 1, c, nl)), 4) == 0.0551  # K3'd at c = 11
    assert round(1e3 * C.least_s(*C.k5_cost(n, d, c, nl)), 4) == 0.0882  # K5 at houseelectric
    N = n * (d + 1)
    assert round(1e3 * C.least_s(*C.chain_build_cost(N, nl, d, 1)), 3) == 0.132  # K3'a at capacity 32,768


@pytest.mark.parametrize("workload", WORKLOADS)
def test_reference_agrees_with_the_program(workload):
    r = run_tiny(workload)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert all(c["value"] < 1e-3 for k, c in r["compared"].items() if k.endswith("_gap")), r["compared"]
    assert r["compared"].get("cg_floor", {"value": 0})["value"] == 0
    assert r["compared"].get("cg_stop", {"value": 0})["value"] <= 1.0 + 1e-3
    assert abs(r["compared"].get("cg_excess", {"value": 0})["value"]) < 0.05


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_comes_out_not_correct(workload):
    r = run_tiny(workload, control=True)
    assert not r["correct"], r["compared"]


CELL_FAULTS = [("houseelectric.train", "unchanged_state"), ("houseelectric.train", "half_batch"),
               ("elevators.cache", "half_batch"), ("elevators.cache", "altered_answer"),
               ("houseelectric.serve", "half_batch"), ("houseelectric.serve", "altered_answer"),
               ("houseelectric.train", "early_stop"), ("elevators.cache", "early_stop")]


@pytest.mark.parametrize("workload,fault", CELL_FAULTS)
def test_fault_comes_out_not_correct(workload, fault):
    with faults.FAULTS[fault]():
        r = run_tiny(workload)
    assert not r["correct"], r["compared"]


def test_result_has_the_contract_keys():
    r = run_tiny("elevators.cache")
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(m) == {"value", "unit"} for m in r["metrics"].values())
    assert all(set(c) == {"value", "limit"} for c in r["compared"].values())


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "-m", "gpbench.run", "--workload", WORKLOADS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout == ""


def test_no_jax_and_a_reference_apart_from_the_program():
    code = ("import sys, json; import gpbench.reference.gp; ref = {m.split('.')[0] for m in sys.modules}; "
            "from gpbench import run; "
            "from gpbench import cell, record; import pathlib, tempfile; "
            "cfg = dict(json.loads((cell.HERE / 'configs' / 'elevators.json').read_text()), n=1500); "
            "cell.TRAJECTORIES = pathlib.Path(tempfile.mkdtemp()); "
            "(cell.TRAJECTORIES / 'elevators.json').write_text(json.dumps(record.record(cfg, 2, 0, 'cpu'))); "
            "run.run_cell('elevators.cache', 5, 0.2, False, 'cpu', {'n': 1500}, "
            "traffic_overrides={'replay': {'trajectory': 'elevators', 'first': 1, 'last': 2}}); "
            "print(json.dumps([sorted(ref), sorted({m.split('.')[0] for m in sys.modules})]))")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    env.pop("JAX_PLATFORMS", None)
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, env=env)
    assert p.returncode == 0, p.stderr[-2000:]
    before, after = json.loads(p.stdout.strip().splitlines()[-1])
    assert "simplex_gp_torch" not in before and "simplex_gp_torch" in after
    assert not set(run.BANNED) & set(after)


@pytest.mark.cuda
def test_command_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "-m", "gpbench.run", "--workload", "elevators.cache", "--seed", str(SEED),
                        "--seconds", "2", "--trace", "1"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    assert list(r)[-1] == "compared"
