"""Write the JAX-on-CPU golden file for the screened elevators_sparse serving path.

Runs the unchanged JAX package on the seeded ``elevators_sparse`` stand-in
(no ``DATADIR``; 10,623 training rows, d = 18, of which the generator makes
four relevant): ``SimplexGP.posterior_cache_screened`` with ``PRNGKey(0)``
and ``prune_thresh=0.3``, then ``predict_from_cache_screened`` on the 3,320
test rows.  The raw parameters: the median-init lengthscale on the four dims
the generator draws as relevant (``relevant_dims``, a replay of its draws),
``raw_lengthscale`` 60 on the other fourteen, and the default outputscale,
noise and mean; screening at 0.3 keeps the four.  It also reruns the
screened eval CG on its own (the JAX functions ``posterior_cache`` calls) for
its iteration count and residual, counts the occupied lattice points of the
screened plan, and, for the record, serves the same parameters unscreened.

The PyTorch port's ``chip_smoke.py`` holds the GPU run against this file.
Run from the repository root (a few minutes on a CPU)::

    JAX_PLATFORMS=cpu python tests/fixtures/make_elevators_sparse_screened_golden.py
"""

from __future__ import annotations

import pathlib
import sys
import time
import zlib

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from simplex_gp_tpu import BBMMConfig, SimplexGP  # noqa: E402
from simplex_gp_tpu.linalg.cg import cg_solve  # noqa: E402
from simplex_gp_tpu.linalg.mll import build_precond  # noqa: E402
from simplex_gp_tpu.linalg.pivoted_cholesky import precond_solve  # noqa: E402
from simplex_gp_tpu.ops.filter import build_plan_any  # noqa: E402
from simplex_gp_tpu.ops.lattice import count_lattice_points  # noqa: E402
from simplex_gp_tpu.utils.data import UCI_SHAPES, load_uci, prepare_dataset  # noqa: E402

OUT = ROOT / "tests" / "fixtures" / "elevators_sparse_screened_golden.npz"
PRUNE_THRESH = 0.3
IRRELEVANT_RAW_LENGTHSCALE = 60.0

# The round-5 elevators configuration (runs/r5/simplexgp_elevators_s0), screened at 0.3.
MODEL = SimplexGP(
    num_dims=18, kernel="matern", nu=1.5, order=1, min_noise=0.1, prune_thresh=PRUNE_THRESH,
    bbmm=BBMMConfig(cg_tolerance=1.0, max_cg_iterations=500,
                    max_lanczos_iterations=100, precond_rank=100, num_probes=10),
    eval_cg_tolerance=0.01,
)


def relevant_dims(name: str, seed: int = 0) -> np.ndarray:
    """The input dims ``utils/data.py::_synthetic_uci`` draws as relevant for ``<name>_sparse``, by replaying
    its draws in order."""
    n, d = UCI_SHAPES[name]
    rng = np.random.default_rng(zlib.crc32((name + "_sp").encode()) + seed)
    rng.normal(size=(50, d))
    rng.integers(0, 50, size=n)
    rng.normal(size=(n, d))
    rank = min(3, d)
    rng.normal(size=(d, rank))
    rng.normal(size=(rank,))
    return np.sort(rng.permutation(d)[: min(4, d)])


def median_lengthscale(x: np.ndarray) -> float:
    """experiments/common.py::init_kwargs's median heuristic."""
    sub = x[np.random.default_rng(0).permutation(x.shape[0])[:2000]]
    d2 = ((sub[:, None, :] - sub[None, :, :]) ** 2).sum(-1)
    return float(np.sqrt(np.median(d2[d2 > 0]))) / np.sqrt(2.0)


def metrics(mean, var, y):
    err = mean - y
    return float(np.sqrt((err**2).mean())), float(0.5 * (np.log(2 * np.pi * var) + err**2 / var).mean())


def main():
    ds = prepare_dataset(load_uci("elevators_sparse"), "elevators_sparse")
    x, y = jnp.asarray(ds.train_x), jnp.asarray(ds.train_y)
    xt = jnp.asarray(ds.test_x)
    rel = relevant_dims("elevators")
    raw = MODEL.init_params(lengthscale=median_lengthscale(ds.train_x))
    rl = np.full(MODEL.num_dims, IRRELEVANT_RAW_LENGTHSCALE, np.float32)
    rl[rel] = np.asarray(raw["raw_lengthscale"])[rel]
    raw = dict(raw, raw_lengthscale=jnp.asarray(rl))

    sub, raw_sub, keep = MODEL.screened(raw)
    assert keep is not None and list(keep) == list(rel), (keep, rel)
    key = jax.random.PRNGKey(0)
    t0 = time.perf_counter()
    cache = MODEL.posterior_cache_screened(raw, x, y, key)
    mean, var = map(np.asarray, MODEL.predict_from_cache_screened(cache, x, xt))
    t_screened = time.perf_counter() - t0
    rmse, nll = metrics(mean, var, ds.test_y)

    xs = x[:, jnp.asarray(keep)]

    @jax.jit
    def eval_cg(raw, x, y):
        params = sub.constrained(raw)
        ref = x * params["inv_ell"]
        plan = build_plan_any(ref, sub.dk)
        P = build_precond(sub.dk, sub.bbmm, params, ref, x.shape[0])
        r = cg_solve(sub._khat_mv(params, plan), (y - params["mean"])[:, None], tol=sub.eval_cg_tolerance,
                     max_iters=sub.bbmm.max_cg_iterations, precond=lambda V: precond_solve(P, V))
        return r.iterations, r.residual_norm[0]

    cg_iters, cg_res = eval_cg(raw_sub, xs, y)
    inv_sub = sub.constrained(raw_sub)["inv_ell"]
    dk = sub.dk
    occupancy = int(count_lattice_points(xs * inv_sub, dk.variance, dk.coeffs))

    t0 = time.perf_counter()
    full = MODEL.posterior_cache(raw, x, y, key)
    fmean, fvar = map(np.asarray, MODEL.predict_from_cache(full, x, xt))
    t_full = time.perf_counter() - t0
    rmse_full, nll_full = metrics(fmean, fvar, ds.test_y)

    np.savez_compressed(
        OUT,
        keep=np.asarray(keep, np.int64), prune_thresh=np.float32(PRUNE_THRESH),
        **{k: np.asarray(v, np.float32) for k, v in raw.items()},
        pred_mean=mean.astype(np.float32), pred_var=var.astype(np.float32),
        rmse=np.float32(rmse), nll=np.float32(nll),
        cg_iters=np.int32(cg_iters), cg_res=np.float32(cg_res), occupancy=np.int32(occupancy),
        rmse_unscreened=np.float32(rmse_full), nll_unscreened=np.float32(nll_full),
    )
    print(f"screened: keep {list(keep)} of {MODEL.num_dims}, {t_screened:.1f} s; unscreened {t_full:.1f} s "
          f"(CPU, incl. compile)")
    print(f"rmse {rmse:.4f} nll {nll:.4f} (unscreened {rmse_full:.4f} / {nll_full:.4f}) cg_iters {int(cg_iters)} "
          f"cg_res {float(cg_res):.3e} occupancy {occupancy} -> {OUT}")


if __name__ == "__main__":
    main()
