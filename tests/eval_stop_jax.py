"""The houseelectric eval CG's stop, JAX's and the port's, on the CPU (not collected: no test_ prefix).

    JAX_PLATFORMS=cpu python tests/eval_stop_jax.py PARAMS.json [--rows N] [--ulp K]

Reads raw parameters from a JSON file (chip_smoke.py's phase 6.5 prints
them after its warm houseelectric steps; kernel_times.py --eval-stop takes
the same file) and runs posterior_cache's solve on the first N training rows
of the houseelectric stand-in (default 131,072): the Matern-1.5 chain plan
of capacity 32,768, the rank-100 pivoted-Cholesky preconditioner, tolerance
0.01, at most 500 iterations, the 50-iteration stall guard.  Once through
JAX's SimplexGP and cg_solve, once through the port's (its kernels' plain
twins, as on any CPU tensor).  For each: the iteration count, the best mean
residual and the rule that stopped it (the cap when the count reaches 500,
the tolerance when the residual is under it, else the stall guard).  With
``--ulp K``, K more solves on each side with three seeded entries of y moved
by one ulp: how far float32 rounding alone moves each count.  Prints one
JSON line.
"""

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

import simplex_gp_torch
from simplex_gp_torch.linalg import cg as t_cg
from simplex_gp_torch.linalg import mll as t_mll
from simplex_gp_torch.ops.filter import apply_plan_any, build_plan_any
from simplex_gp_torch.utils import data
from simplex_gp_tpu.linalg import mll as j_mll
from simplex_gp_tpu.linalg.cg import cg_solve as j_cg_solve
from simplex_gp_tpu.linalg.pivoted_cholesky import precond_solve as j_precond_solve
from simplex_gp_tpu.models.exact_gp import SimplexGP as JaxSimplexGP
from simplex_gp_tpu.ops.filter import build_plan_any as j_build_plan_any

TOL, CAP, MAX_ITERS = 0.01, 32768, 500


def _rule(iterations: int, res: float) -> str:
    return "max_iters" if iterations >= MAX_ITERS else "tolerance" if res < TOL else "stall guard"


def _config(bbmm):
    return bbmm(cg_tolerance=1.0, max_cg_iterations=MAX_ITERS, max_lanczos_iterations=100, precond_rank=100,
                num_probes=10, plan_capacity=CAP)


def jax_solve(raw: dict, x: np.ndarray, y: np.ndarray) -> dict:
    model = JaxSimplexGP(num_dims=x.shape[1], kernel="matern", nu=1.5, order=1, min_noise=0.1,
                         bbmm=_config(j_mll.BBMMConfig), eval_cg_tolerance=TOL)
    t0 = time.perf_counter()
    params = model.constrained({k: (jnp.asarray(v, jnp.float32) if k == "raw_lengthscale"
                                    else jnp.float32(np.reshape(v, -1)[0])) for k, v in raw.items()})
    xj = jnp.asarray(x)
    ref = xj * params["inv_ell"]
    plan = j_build_plan_any(ref, model.dk, capacity=CAP)
    P = j_mll.build_precond(model.dk, model.bbmm, params, ref, x.shape[0])
    sol = j_cg_solve(model._khat_mv(params, plan), (jnp.asarray(y) - params["mean"])[:, None], tol=TOL,
                     max_iters=MAX_ITERS, precond=lambda V: j_precond_solve(P, V))
    iterations, res = int(sol.iterations), float(jnp.mean(sol.residual_norm))
    return dict(iterations=iterations, best_residual=res, stop=_rule(iterations, res),
                seconds=time.perf_counter() - t0)


def port_solve(raw: dict, x: np.ndarray, y: np.ndarray) -> dict:
    cfg = _config(t_mll.BBMMConfig)
    model = simplex_gp_torch.SimplexGP(num_dims=x.shape[1], kernel="matern", nu=1.5, order=1, min_noise=0.1,
                                       bbmm=cfg, eval_cg_tolerance=TOL, device=torch.device("cpu"))
    model.load_raw({k: np.asarray(v, dtype=np.float32) for k, v in raw.items()})
    t0 = time.perf_counter()
    with torch.no_grad():
        params = model.constrained()
        xt, yt = torch.from_numpy(x), torch.from_numpy(y)
        ref = xt * params["inv_ell"]
        plan = build_plan_any(ref, model.dk, CAP)
        P = t_mll.build_precond(model.dk, cfg, params, ref, x.shape[0])
        sol = t_cg.cg_solve(lambda V: apply_plan_any(plan, V, model.dk), (yt - params["mean"])[:, None], tol=TOL,
                            max_iters=MAX_ITERS, precond=P, shift=(params["outputscale"], params["noise"]))
    iterations, res = int(sol.iterations), float(sol.residual_norm.mean())
    return dict(iterations=iterations, best_residual=res, stop=_rule(iterations, res),
                seconds=time.perf_counter() - t0)


def main(argv) -> dict:
    path = argv[0]
    rows = int(argv[argv.index("--rows") + 1]) if "--rows" in argv else 131072
    ulps = int(argv[argv.index("--ulp") + 1]) if "--ulp" in argv else 0
    raw = json.load(open(path))
    house = data.load_dataset("houseelectric")
    x = np.ascontiguousarray(house.train_x[:rows], dtype=np.float32)
    y = np.ascontiguousarray(house.train_y[:rows], dtype=np.float32)
    out = dict(params=path, rows=int(x.shape[0]), jax_backend=jax.default_backend(), jax=[], port=[])
    rng = np.random.default_rng(0)
    for i in range(1 + ulps):
        yy = y.copy()
        if i:
            idx = rng.integers(0, yy.shape[0], 3)
            yy[idx] = np.nextafter(yy[idx], np.float32(np.inf))
        out["jax"].append(jax_solve(raw, x, yy))
        out["port"].append(port_solve(raw, x, yy))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
