"""Record the parameter trajectory that the program's trainer takes on a configuration's table, for traffic to
replay.

    python -m gpbench.record --config <name> --steps <k> [--seed <n>] [--out <file>]

The step is the loop of simplex_gp_torch/train.py::run_training without its
evaluations (``--no-eval``): zero_grad, ``SimplexGP.nlml`` with the
trainer's generator for the probes, backward, Adam at the configuration's
``lr``, from the configuration's ``median`` point (``--ls-init median``).
The file (``gpbench/trajectories/<name>.json`` by default) holds the raw
parameters before the first step and after each, each step's loss, CG
iterations and mean residual, and each point's lattice occupancy (counted
by the reference, to hold against the training plan's capacity).  Run on a
card; the benchmark's own runs only read the file.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys

import numpy as np
import torch

from gpbench.cell import HERE, load
from gpbench.data import point_raw
from gpbench.reference.gp import constrain
from gpbench.reference.lattice import matern_taps, vertex_count


def record(cfg: dict, steps: int, seed: int, device) -> dict:
    data = load("recipes", cfg["data"]).make(cfg, device)
    x, y = data["train_x"], data["train_y"]
    model = load("models", cfg["model"]).build(cfg, device)
    model.load_raw(point_raw(cfg["points"]["median"], cfg["d"], data["median_lengthscale"]))
    opt = torch.optim.Adam(model.parameters(), lr=cfg["lr"])
    gen = torch.Generator(device=device).manual_seed(seed)
    _, variance = matern_taps(cfg["nu"], cfg["order"])
    raw = lambda: {k: np.asarray(v.detach().cpu().numpy(), np.float32) for k, v in model.raw().items()}
    points, losses, iters, res = [raw()], [], [], []
    for _ in range(steps):
        stats = {}
        opt.zero_grad(set_to_none=True)
        loss = model.nlml(x, y, generator=gen, stats=stats)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        iters.append(int(stats["cg_iters"]))
        res.append(float(stats["cg_res"]))
        points.append(raw())
        if not math.isfinite(losses[-1]):
            break
    occupancy = []
    for p in points:
        with torch.no_grad():
            c = constrain({k: torch.as_tensor(v, device=device) for k, v in p.items()}, cfg["min_noise"])
            occupancy.append(vertex_count(x * c["inv_ell"], variance))
    tolist = lambda v: v.tolist() if v.ndim else float(v)
    return {"config": cfg["name"], "data_seed": cfg["data_seed"], "n": cfg["n"], "d": cfg["d"], "seed": seed,
            "steps": len(losses), "plan_capacity": cfg["plan_capacity"],
            "made_by": "python -m gpbench.record: simplex_gp_torch's trainer step (train.py::run_training, --no-eval) "
                       "from the configuration's median point",
            "loss": losses, "cg_iters": iters, "cg_res": res, "n_lattice": occupancy,
            "points": [{k: tolist(v) for k, v in p.items()} for p in points]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m gpbench.record", description=__doc__.split("\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--steps", type=int, required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("gpbench.record: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = json.loads((HERE / "configs" / f"{args.config}.json").read_text())
    out = record(cfg, args.steps, args.seed, "cuda")
    path = pathlib.Path(args.out) if args.out else HERE / "trajectories" / f"{args.config}.json"
    path.write_text(json.dumps(out) + "\n")
    print(json.dumps({k: out[k] for k in ("config", "steps", "loss", "cg_iters", "n_lattice")}), flush=True)
    return 0 if out["steps"] == args.steps else 1


if __name__ == "__main__":
    sys.exit(main())
