"""A grid runner over the sweep configs: ``python -m simplex_gp_torch.sweep CONFIG``.

The port's counterpart of experiments/sweep.py, over the same
``configs/*.yml`` (a program and a grid of flags, as the reference's wandb
sweeps).  Each config's ``program``, a JAX script, maps to the port module
that does its job (``PROGRAMS``); each grid point starts ``python -m
<module>`` with the point as flags, then every flag this runner does not
know, as given (``--device``, ``--epochs 1``, ...).  The last JSON line each
run prints is its summary; one record a point (``point``, ``returncode``,
``summary``, and the tail of standard error on a failure) is appended to
``<--out>/sweep_results.jsonl`` (``runs/torch/sweep_<config stem>`` by
default).  A program without a port (``experiments/backend_diff.py`` of
``configs/backend_diff.yml``) is an error that names it.  ``--dry-run``
prints the commands; ``--limit k`` runs the first k points::

    python -m simplex_gp_torch.sweep configs/simplexgp.yml --limit 1 --epochs 1
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import pathlib
import subprocess
import sys
from typing import Optional, Sequence

__all__ = ["main", "PROGRAMS", "load_config", "grid_points", "module_for"]

_PACKAGE_PARENT = pathlib.Path(__file__).resolve().parents[1]

# The JAX scripts the configs name, and the port module of each.
PROGRAMS = {
    "experiments/train_simplexgp.py": "simplex_gp_torch.train",
    "experiments/train_exact.py": "simplex_gp_torch.train_exact",
    "experiments/train_sgpr.py": "simplex_gp_torch.train_sgpr",
    "experiments/train_skip.py": "simplex_gp_torch.train_skip",
    "experiments/mvm_err.py": "simplex_gp_torch.mvm_err",
}


def module_for(program: str) -> str:
    """The port module of a config's ``program``; a program without a port is an error that names it."""
    if program not in PROGRAMS:
        raise ValueError(f"{program} has no port in simplex_gp_torch (ported programs: {', '.join(PROGRAMS)})")
    return PROGRAMS[program]


def load_config(path) -> dict:
    """The sweep config: pyyaml where installed, else the subset reader of experiments/sweep.py:23-64
    (two-level mappings with ``value:`` / ``values: [..]`` leaves)."""
    try:
        import yaml  # type: ignore

        return yaml.safe_load(pathlib.Path(path).read_text())
    except ModuleNotFoundError:
        pass

    cfg: dict = {"parameters": {}}
    cur_param = None
    in_params = False
    for raw in pathlib.Path(path).read_text().splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip())
        key, _, val = line.strip().partition(":")
        val = val.strip()
        if indent == 0:
            in_params = key == "parameters"
            if not in_params and val:
                cfg[key] = _scalar(val)
        elif in_params and indent == 2:
            cur_param = key
            cfg["parameters"][cur_param] = {}
        elif in_params and indent >= 4 and cur_param is not None:
            if key == "value":
                cfg["parameters"][cur_param]["value"] = _scalar(val)
            elif key == "values":
                items = val.strip("[]")
                cfg["parameters"][cur_param]["values"] = [_scalar(v.strip()) for v in items.split(",") if v.strip()]
    return cfg


def _scalar(s: str):
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    return s


def grid_points(parameters: dict):
    """The cartesian product of the parameters' values, in the config's order, as dicts."""
    names, val_lists = [], []
    for name, spec in parameters.items():
        names.append(name)
        val_lists.append(spec["values"] if "values" in spec else [spec["value"]])
    for combo in itertools.product(*val_lists):
        yield dict(zip(names, combo))


def _summary(stdout: str):
    """The last line of ``stdout`` that parses as JSON."""
    for line in reversed(stdout.strip().splitlines()):
        try:
            return json.loads(line)
        except json.JSONDecodeError:
            continue
    return None


def main(argv: Optional[Sequence[str]] = None) -> list:
    """Run (or with ``--dry-run`` print) the grid; returns the commands."""
    p = argparse.ArgumentParser(prog="python -m simplex_gp_torch.sweep", description=__doc__.split("\n")[0])
    p.add_argument("config")
    p.add_argument("--out", default=None)
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--limit", type=int, default=0, help="run only the first k grid points")
    args, extra = p.parse_known_args(argv)  # unknown flags pass through to every run

    cfg = load_config(args.config)
    module = module_for(cfg["program"])
    out_dir = pathlib.Path(args.out or f"runs/torch/sweep_{pathlib.Path(args.config).stem}")
    results_path = out_dir / "sweep_results.jsonl"
    points = list(grid_points(cfg.get("parameters", {})))
    if args.limit:
        points = points[: args.limit]
    # The package is importable by the runs from any working directory.
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [str(_PACKAGE_PARENT),
                                                                    os.environ.get("PYTHONPATH")])))
    print(f"{len(points)} grid points for {cfg['program']} (python -m {module})", flush=True)
    commands = []
    for i, point in enumerate(points):
        cmd = [sys.executable, "-m", module]
        for k, v in point.items():
            cmd += [f"--{k}", str(v)]
        cmd += extra
        commands.append(cmd)
        print(f"[{i + 1}/{len(points)}]", " ".join(cmd), flush=True)
        if args.dry_run:
            continue
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env)
        rec = {"point": point, "returncode": proc.returncode, "summary": _summary(proc.stdout)}
        if proc.returncode != 0:
            rec["stderr_tail"] = proc.stderr.strip().splitlines()[-5:]
        out_dir.mkdir(parents=True, exist_ok=True)
        with results_path.open("a") as f:
            f.write(json.dumps(rec) + "\n")
    if not args.dry_run:
        print(f"results -> {results_path}", flush=True)
    return commands


if __name__ == "__main__":
    main()
