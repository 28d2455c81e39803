"""Write the JAX-on-CPU golden file for the full-size elevators serving path.

Runs the unchanged JAX package: ``SimplexGP.posterior_cache`` with
``PRNGKey(0)`` on the 10,623 elevators training rows (synthetic fallback, no
``DATADIR``), then ``predict_from_cache`` on the 3,320 test rows, with the
trained parameters of ``runs/r5/simplexgp_elevators_s0/model_best.pkl``.
It also reruns the eval CG on its own (the same JAX functions that
``posterior_cache`` calls) to record the iteration count and residual, and
counts the occupied lattice points of the train and joint [train; test] join
plans.

The PyTorch port's ``chip_smoke.py`` holds the GPU run against this file.
Run from the repository root (about six minutes on a CPU)::

    JAX_PLATFORMS=cpu python tests/fixtures/make_elevators_golden.py
"""

from __future__ import annotations

import pathlib
import pickle
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from simplex_gp_tpu import BBMMConfig, SimplexGP  # noqa: E402
from simplex_gp_tpu.linalg.cg import cg_solve  # noqa: E402
from simplex_gp_tpu.linalg.mll import build_precond  # noqa: E402
from simplex_gp_tpu.linalg.pivoted_cholesky import precond_solve  # noqa: E402
from simplex_gp_tpu.ops.filter import apply_plan_any, build_plan_any  # noqa: E402
from simplex_gp_tpu.ops.lattice import build_plan_join  # noqa: E402
from simplex_gp_tpu.utils.data import load_uci, prepare_dataset  # noqa: E402

PARAMS = ROOT / "runs" / "r5" / "simplexgp_elevators_s0" / "model_best.pkl"
OUT = ROOT / "tests" / "fixtures" / "elevators_golden.npz"

# The trained run's configuration (first line of its metrics.jsonl).
MODEL = SimplexGP(
    num_dims=18, kernel="matern", nu=1.5, order=1, min_noise=0.1,
    bbmm=BBMMConfig(cg_tolerance=1.0, max_cg_iterations=500,
                    max_lanczos_iterations=100, precond_rank=100, num_probes=10),
    eval_cg_tolerance=0.01,
)


def main():
    ds = prepare_dataset(load_uci("elevators"), "elevators")
    with open(PARAMS, "rb") as f:
        raw = {k: jnp.asarray(v) for k, v in pickle.load(f).items()}
    x, y = jnp.asarray(ds.train_x), jnp.asarray(ds.train_y)
    xt = jnp.asarray(ds.test_x)

    t0 = time.perf_counter()
    cache = MODEL.posterior_cache(raw, x, y, jax.random.PRNGKey(0))
    jax.block_until_ready(cache)
    t_cache = time.perf_counter() - t0
    t0 = time.perf_counter()
    mean, var = MODEL.predict_from_cache(cache, x, xt)
    mean, var = np.asarray(mean), np.asarray(var)
    t_pred = time.perf_counter() - t0

    @jax.jit
    def eval_cg(raw, x, y):
        params = MODEL.constrained(raw)
        ref = x * params["inv_ell"]
        plan = build_plan_any(ref, MODEL.dk)
        mv = MODEL._khat_mv(params, plan)
        P = build_precond(MODEL.dk, MODEL.bbmm, params, ref, x.shape[0])
        r = cg_solve(mv, (y - params["mean"])[:, None], tol=MODEL.eval_cg_tolerance,
                     max_iters=MODEL.bbmm.max_cg_iterations,
                     precond=lambda V: precond_solve(P, V))
        return r.iterations, r.residual_norm[0]

    cg_iters, cg_res = eval_cg(raw, x, y)
    params = MODEL.constrained(raw)
    ref, ref_t = x * params["inv_ell"], xt * params["inv_ell"]
    dk = MODEL.dk
    nl_train = int(build_plan_join(ref, dk.coeffs, dk.variance).n_lattice)
    joint = jnp.concatenate([ref, ref_t], axis=0)
    nl_joint = int(build_plan_join(joint, dk.coeffs, dk.variance).n_lattice)

    err = mean - ds.test_y
    rmse = float(np.sqrt((err**2).mean()))
    nll = float(0.5 * (np.log(2 * np.pi * var) + err**2 / var).mean())
    np.savez_compressed(
        OUT,
        mean=mean.astype(np.float32), var=var.astype(np.float32),
        alpha=np.asarray(cache["alpha"], np.float32),
        cg_iters=np.int32(cg_iters), cg_res=np.float32(cg_res),
        n_lattice_train=np.int32(nl_train), n_lattice_joint=np.int32(nl_joint),
        rmse=np.float32(rmse), nll=np.float32(nll),
    )
    print(f"posterior_cache {t_cache:.1f} s, predict {t_pred:.1f} s (CPU, incl. compile)")
    print(f"rmse {rmse:.4f} nll {nll:.4f} cg_iters {int(cg_iters)} cg_res {float(cg_res):.3e} "
          f"n_lattice train {nl_train} joint {nl_joint} -> {OUT}")


if __name__ == "__main__":
    main()
