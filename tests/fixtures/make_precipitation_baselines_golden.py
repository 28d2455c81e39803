"""Write the JAX-on-CPU golden file for the SKIP and SGPR baselines at precipitation.

Runs the unchanged JAX package on the seeded synthetic stand-in of
precipitation (d = 3; the first 65,536 of its 402,223 training rows, as
``--max-n 65536``; all 125,695 test rows) with the configuration of
``runs/r5/{skip,sgpr}_precipitation_s0`` (kernel Matern-1.5, min_noise
0.1; SKIP grid 100, rank 64; SGPR 512 inducing points) and records:

  * JAX's two Omega arrays of SKIP's Hadamard steps (PRNGKey(1), (2); each
    (4096, 64) float32) and the median-init raw parameters
    (experiments/common.py:95-103);
  * SKIP's NLML and raw gradients at the median init and at
    ``model_best.pkl``, and the root's first 256 rows there (R R^T on
    them is what a port can compare: R itself is defined up to rotations);
  * SKIP's test RMSE / NLL on all test rows at ``model_best.pkl``, and the
    mean and variance of the first 4,096 test rows;
  * SGPR's NLML and raw gradients (the 512 x 3 inducing points included) at
    its ``model_best.pkl``, its test RMSE / NLL and the first 4,096 rows'
    mean and variance.

SKIP's eigenvectors and range-finder columns are defined up to sign, and the
port fixes them (simplex_gp_torch/models/ski.py::fix_signs).  Every SKIP
value above is computed with JAX's ``eigh`` / ``qr`` / ``svd`` giving the
port's signs (tests/jax_ski_signs.py::port_signs); the same values with
LAPACK's own signs are stored under ``native_*`` (the round-5 records:
test RMSE 0.3196).  Run from the repository root::

    JAX_PLATFORMS=cpu python tests/fixtures/make_precipitation_baselines_golden.py
"""

from __future__ import annotations

import argparse
import pathlib
import pickle
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "tests"), str(ROOT / "experiments")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from common import init_kwargs, load_dataset, regression_metrics  # noqa: E402
from jax_ski_signs import jax_omegas, port_signs  # noqa: E402

from simplex_gp_tpu.models.sgpr import SGPR  # noqa: E402
from simplex_gp_tpu.models.ski import SKIP  # noqa: E402

OUT = ROOT / "tests" / "fixtures" / "precipitation_baselines_golden.npz"
RUNS = ROOT / "runs" / "r5"
RAW_NAMES = ("raw_lengthscale", "raw_outputscale", "raw_noise", "mean")
ROWS = 4096  # test rows whose mean and variance are stored
ROOT_ROWS = 256  # training rows of the stored root


def _load(path) -> dict:
    with open(path, "rb") as f:
        return {k: jnp.asarray(v) for k, v in pickle.load(f).items()}


def main():
    t_start = time.perf_counter()
    args = argparse.Namespace(dataset="precipitation", data_dir=None, max_n=65536, ls_init="median")
    ds = load_dataset(args)
    x, y, xt = jnp.asarray(ds.train_x), jnp.asarray(ds.train_y), jnp.asarray(ds.test_x)
    print(f"precipitation: train {x.shape}, test {xt.shape}", flush=True)
    rec = {}

    skip = SKIP(num_dims=3, grid_size=100, rank=64, kernel="matern", nu=1.5, min_noise=0.1)
    omegas = jax_omegas(3, 64)
    rec["omega_1"], rec["omega_2"] = omegas
    init = skip.init_params(**init_kwargs(args, ds))
    best = _load(RUNS / "skip_precipitation_s0" / "model_best.pkl")
    for k in RAW_NAMES:
        rec[f"skip_init_{k}"] = np.asarray(init[k])

    def loss_grad(model, raw):
        loss, g = jax.value_and_grad(lambda r: model.nlml(r, x, y))(raw)
        return float(loss), {k: np.asarray(v) for k, v in g.items()}

    for tag, raw in (("init", init), ("best", best)):
        for prefix, signs in (("skip", True), ("native_skip", False)):
            t0 = time.perf_counter()
            if signs:
                with port_signs():
                    loss, g = loss_grad(skip, raw)
                    R = skip._root(skip.constrained(raw), x)
                rec[f"skip_root_{tag}"] = np.asarray(R[:ROOT_ROWS])
            else:
                loss, g = loss_grad(skip, raw)
            rec[f"{prefix}_loss_{tag}"] = loss
            for k in RAW_NAMES:
                rec[f"{prefix}_grad_{tag}_{k}"] = g[k]
            print(f"{prefix} {tag}: NLML {loss:.6f}, grads " + ", ".join(f"{k} {np.round(g[k], 6).tolist()}"
                                                                     for k in RAW_NAMES)
                  + f" ({time.perf_counter() - t0:.1f} s)", flush=True)

    for prefix, signs in (("skip", True), ("native_skip", False)):
        t0 = time.perf_counter()
        if signs:
            with port_signs():
                mean, var = skip.predict(best, x, y, xt)
        else:
            mean, var = skip.predict(best, x, y, xt)
        m = regression_metrics(mean, var, ds.test_y)
        rec[f"{prefix}_rmse"], rec[f"{prefix}_nll"] = m["rmse"], m["nll"]
        if signs:
            rec["skip_mean"], rec["skip_var"] = np.asarray(mean[:ROWS]), np.asarray(var[:ROWS])
        print(f"{prefix} serving: RMSE {m['rmse']:.4f}, NLL {m['nll']:.3f} ({time.perf_counter() - t0:.1f} s)",
              flush=True)

    sgpr = SGPR(num_dims=3, num_inducing=512, kernel="matern", nu=1.5, min_noise=0.1)
    sbest = _load(RUNS / "sgpr_precipitation_s0" / "model_best.pkl")
    t0 = time.perf_counter()
    loss, g = loss_grad(sgpr, sbest)
    rec["sgpr_loss_best"] = loss
    for k in (*RAW_NAMES, "inducing"):
        rec[f"sgpr_grad_best_{k}"] = g[k]
    mean, var = sgpr.predict(sbest, x, y, xt)
    m = regression_metrics(mean, var, ds.test_y)
    rec["sgpr_rmse"], rec["sgpr_nll"] = m["rmse"], m["nll"]
    rec["sgpr_mean"], rec["sgpr_var"] = np.asarray(mean[:ROWS]), np.asarray(var[:ROWS])
    print(f"sgpr best: NLML {loss:.6f}, RMSE {m['rmse']:.4f}, NLL {m['nll']:.4f} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    np.savez_compressed(OUT, **{k: np.asarray(v) for k, v in rec.items()})
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes) in {time.perf_counter() - t_start:.1f} s")


if __name__ == "__main__":
    main()
