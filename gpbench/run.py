"""One run of one benchmark cell on one card.

    python -m gpbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything comes from ``BENCHMARK.json`` by name: the workload's entry names
its configuration (``gpbench/configs/<config>.json``) and its traffic
(``gpbench/traffic/<traffic>.json``, whose ``op`` names the driver,
``gpbench/drivers/<op>.py``; see :mod:`gpbench.cell` for what else a cell
finds by name); its limits are ``gpbench/limits/<workload>.json``; each
metric is read by ``gpbench/metrics/<name>.py``, or, for a name with a
suffix, ``gpbench/metrics/<name before the last dot>.py``.  A run sets up and
warms the cell, drives its traffic for ``--seconds`` (with ``--trace 1``, for
at most ``TRACE_SECONDS`` of them, traced by torch.profiler, so that reading
a long trace keeps the run inside its time limit), reads its metrics (end-to-end without a trace,
per-layer with one), frees the program's state, compares what the window
produced with the plain reference under ``gpbench/reference/``, and prints
one JSON line last on standard output.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = ROOT / "gpbench"
BANNED = ("jax", "jaxlib", "flax", "simplex_gp_tpu")
TRACE_SECONDS = 25.0

# Build and kernel caches inside the checkout, at fixed paths, whatever the environment says.
os.environ["TORCH_EXTENSIONS_DIR"] = str(HERE / ".cache" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(HERE / ".cache" / "triton")

import torch  # noqa: E402

from gpbench.cell import load  # noqa: E402
from gpbench.trace import Tracer  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def spec(workload: str) -> dict:
    """The workload's entry, its configuration, traffic and limits, and the metrics it reports."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    mine = lambda m: "workloads" not in m or workload in m["workloads"]
    return {"cell": cell, "chips": cell["chips"],
            "config": json.loads((ROOT / conf["file"]).read_text()),
            "traffic": json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text()),
            "limits": json.loads((HERE / "limits" / f"{workload}.json").read_text()),
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def reader(name: str):
    """``read(ctx)`` of gpbench/metrics/<name>.py, or of the file named by the name before its last dot."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    mod_spec = importlib.util.spec_from_file_location(f"gpbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def banned_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda", overrides=None,
             control: bool = False, traffic_overrides=None) -> dict:
    """Set up, warm, drive and check one cell; returns the result line's object.  ``overrides`` and
    ``traffic_overrides`` replace keys of the configuration and the traffic (the tests' tiny sizes);
    ``control`` puts the reference in TF32 in the program's place for the comparison."""
    s = spec(workload)
    cfg = {**s["config"], **(overrides or {})}
    traffic = {**s["traffic"], **(traffic_overrides or {})}
    cell = load("drivers", traffic["op"]).Driver(cfg, traffic, seed, device, trace)
    cell.setup()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - _T0
    cell.span.spans.clear()
    cell.span.counters.clear()
    tracer = Tracer() if trace else None
    if tracer:
        seconds = min(seconds, TRACE_SECONDS)
        tracer.start()
    attempted = failed = 0
    with torch.profiler.record_function("gpbench.window"):
        t0 = time.perf_counter()
        while True:
            failed += not cell.op()
            attempted += 1
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
    if tracer:
        tracer.stop()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    ctx = {"cell": cell, "spans": cell.span.spans, "counters": cell.span.counters, "ops": attempted,
           "window_s": window_s, "setup_s": setup_s, "peak_bytes": peak, "trace": {}}
    if tracer:
        ctx["trace"] = tracer.summary()
        ctx["costs"] = cell.costs(range(attempted))
    metrics = {}
    for m in s["per_layer"] if trace else s["end_to_end"]:
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    found = banned_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: {', '.join(found)}")
    prog = cell.control_records() if control else cell.program_records()
    cell.release()
    numbers = cell.check(prog)
    compared = {k: {"value": v, "limit": s["limits"][k]} for k, v in numbers.items()}
    result = {"correct": failed == 0 and all(c["value"] <= c["limit"] for c in compared.values()),
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name() if cuda else "cpu", "count": 1 if cuda else 0,
                         "memory_peak_bytes": peak}}
    if tracer and ctx["trace"]:
        t = ctx["trace"]
        result["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    result["compared"] = compared
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m gpbench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    chips = spec(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gpbench: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = banned_modules()
    if found:
        print(f"gpbench: modules of JAX or the JAX package are loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
