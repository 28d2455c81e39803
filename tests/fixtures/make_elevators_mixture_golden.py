"""Write the JAX-on-CPU golden file for the Gaussian-mixture kernel path at elevators.

Runs the unchanged JAX package on the seeded synthetic stand-in of elevators
(10,623 training and 3,320 test rows, d = 18, as ``elevators_golden.npz``)
with the configuration of ``runs/r5/simplexgp_elevators_s0`` and
``--kernel mixture --mix-components 8`` (SimplexGP kernel "mixture", J = 8
RBF components of order 1 targeting Matern-1.5, min_noise 0.1; BBMM cg tol
1.0, 500 CG / 100 Lanczos iterations, preconditioner rank 100, 10 probes,
slq_mode "cg"; eval cg tol 1e-2) and records:

  * the median-init raw parameters (experiments/common.py:95-103) and the
    mixture weights that ``with_fitted_mixture`` fits there (m = 1024,
    seed 0), as experiments/train_simplexgp.py:88-93 does;
  * one mixture MVM with those weights, ``lattice_filter_any`` of a seeded
    normal column at the median-init positions;
  * the NLML and its raw-parameter gradients at the median init, and three
    Adam steps (lr 0.1) from there, with the per-step losses and the raw
    parameters after each step;
  * the serving path at the trained ``model_best.pkl``, with the weights
    ``with_fitted_mixture`` fits at its lengthscales (the median-init
    weights there give a kernel diagonal well above 1, so most predictive
    variances clamp at 1e-8 and the test NLL is ~1.5e4):
    ``posterior_cache`` (PRNGKey(0)) and ``predict_from_cache`` on the test
    rows -- mean, variance, alpha, RMSE, NLL -- and the eval CG's iteration
    count and final residual;
  * experiments/mvm_err.py's accuracy measurement for ``--kernel mixture``
    (order 1, nu 1.5) on all 16,599 rows: the subset-fit weights, rel_err
    and cos_err, the dense side in row blocks.

Probes and the MVM column are numpy draws, so the port can feed the same
ones: probes ``default_rng(seed).choice([-1, 1], (n, 10))`` as float32, the
column ``default_rng(MVM_SEED).normal(size=(n, 1))`` as float32.  The
PyTorch port's ``chip_smoke.py`` phase 8 holds the GPU run against this
file.  Run from the repository root::

    JAX_PLATFORMS=cpu python tests/fixtures/make_elevators_mixture_golden.py
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
import optax  # noqa: E402

from simplex_gp_tpu import BBMMConfig, SimplexGP  # noqa: E402
from simplex_gp_tpu.linalg.cg import cg_solve  # noqa: E402
from simplex_gp_tpu.linalg.mll import build_precond, lattice_nlml  # noqa: E402
from simplex_gp_tpu.linalg.pivoted_cholesky import precond_solve  # noqa: E402
from simplex_gp_tpu.ops import kernels as K  # noqa: E402
from simplex_gp_tpu.ops.filter import build_plan_any, lattice_filter_any  # noqa: E402
from simplex_gp_tpu.utils.data import _synthetic_uci, prepare_dataset  # noqa: E402

PARAMS = ROOT / "runs" / "r5" / "simplexgp_elevators_s0" / "model_best.pkl"
OUT = ROOT / "tests" / "fixtures" / "elevators_mixture_golden.npz"

MODEL = SimplexGP(
    num_dims=18, kernel="mixture", nu=1.5, order=1, min_noise=0.1, mix_components=8,
    bbmm=BBMMConfig(cg_tolerance=1.0, max_cg_iterations=500, max_lanczos_iterations=100,
                    precond_rank=100, num_probes=10, slq_mode="cg", grad_mode="exact"),
    eval_cg_tolerance=0.01,
)
NAMES = ("raw_lengthscale", "raw_outputscale", "raw_noise", "mean")
SEED_INIT, SEED_ADAM, MVM_SEED = 100, 200, 7  # Adam step e draws seed SEED_ADAM + e
ADAM_STEPS, LR = 3, 0.1
MAX_EXACT, BLOCK = 20000, 1024


def probes(seed: int, n: int, p: int) -> np.ndarray:
    return np.random.default_rng(seed).choice([-1.0, 1.0], size=(n, p)).astype(np.float32)


def median_lengthscale(x: np.ndarray) -> float:
    """experiments/common.py:95-103: median pairwise distance of 2,000 rows / sqrt(2)."""
    sub = x[np.random.default_rng(0).permutation(x.shape[0])[:2000]]
    d2 = ((sub[:, None, :] - sub[None, :, :]) ** 2).sum(-1)
    return float(np.sqrt(np.median(d2[d2 > 0]))) / np.sqrt(2.0)


def mvm_accuracy(ds, out: dict):
    """experiments/mvm_err.py:78-113 for --kernel mixture, the dense product in row blocks."""
    x_all = np.concatenate([ds.train_x, ds.val_x, ds.test_x], axis=0)
    y_all = np.concatenate([ds.train_y, ds.val_y, ds.test_y], axis=0)
    ns = min(MAX_EXACT, x_all.shape[0])
    xs, vs = x_all[:ns], y_all[:ns, None]
    dk = K.fit_mixture_weights_subset(K.mixture_kernel(1.5, 1), xs, m=1024)
    lat_s = np.asarray(lattice_filter_any(jnp.asarray(vs), jnp.asarray(xs), dk))
    xj, vj = jnp.asarray(xs), jnp.asarray(vs)

    @jax.jit
    def rows(xb):
        d2 = ((xb[:, None, :] - xj[None, :, :]) ** 2).sum(-1)
        return K.kernel_value_jnp(dk, d2) @ vj

    exact = np.concatenate([np.asarray(rows(xj[i:i + BLOCK])) for i in range(0, ns, BLOCK)])
    scale = (lat_s * exact).sum() / (lat_s * lat_s).sum()
    out["mvm_weights"] = np.asarray(dk.weights, np.float64)
    out["mvm_rel_err"] = np.float64(np.linalg.norm(scale * lat_s - exact) / np.linalg.norm(exact))
    out["mvm_cos_err"] = np.float64((lat_s * exact).sum() / (np.linalg.norm(lat_s) * np.linalg.norm(exact)))
    out["mvm_exact_subset_n"] = np.int32(ns)
    print(f"mvm_err elevators mixture: rel {float(out['mvm_rel_err']):.6f} cos {float(out['mvm_cos_err']):.6f}",
          flush=True)


def main():
    ds = prepare_dataset(_synthetic_uci("elevators"), "elevators")
    x, y, xt = jnp.asarray(ds.train_x), jnp.asarray(ds.train_y), jnp.asarray(ds.test_x)
    n, p = x.shape[0], MODEL.bbmm.num_probes
    ell0 = median_lengthscale(ds.train_x)
    raw0 = MODEL.init_params(lengthscale=ell0)
    with open(PARAMS, "rb") as f:
        best = {k: jnp.asarray(v) for k, v in pickle.load(f).items()}

    t0 = time.perf_counter()
    model = MODEL.with_fitted_mixture(raw0, x)
    dk = model.dk
    out = {"ls_init": np.float32(ell0), "num_probes": np.int32(p), "seed_init": np.int32(SEED_INIT),
           "seed_adam": np.int32(SEED_ADAM), "mvm_seed": np.int32(MVM_SEED),
           "alphas": np.asarray(dk.alphas, np.float64), "weights": np.asarray(dk.weights, np.float64)}
    for k in NAMES:
        out[f"init_{k}"] = np.asarray(raw0[k], np.float32)
    print(f"weights at the median init {np.round(out['weights'], 5).tolist()} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    ref0 = x * model.constrained(raw0)["inv_ell"]
    v = np.random.default_rng(MVM_SEED).normal(size=(n, 1)).astype(np.float32)
    out["mvm_out"] = np.asarray(jax.jit(lambda vv, rr: lattice_filter_any(vv, rr, dk))(jnp.asarray(v), ref0),
                                np.float32)

    def loss(raw, z):
        return lattice_nlml(dk, model.bbmm, model.constrained(raw), x, y, z)

    val, g = jax.jit(jax.value_and_grad(loss))(raw0, jnp.asarray(probes(SEED_INIT, n, p)))
    out["loss_init"] = np.float32(val)
    for k in NAMES:
        out[f"grad_init_{k}"] = np.asarray(g[k], np.float32)
    print(f"init: nlml {float(val):.6f} ({time.perf_counter() - t0:.1f} s so far)", flush=True)

    opt = optax.adam(LR)

    @jax.jit
    def step(raw, opt_state, z):
        v, g = jax.value_and_grad(loss)(raw, z)
        updates, opt_state = opt.update(g, opt_state)
        return optax.apply_updates(raw, updates), opt_state, v

    raw, opt_state = raw0, opt.init(raw0)
    losses, traj = [], {k: [] for k in NAMES}
    for e in range(ADAM_STEPS):
        raw, opt_state, v_ = step(raw, opt_state, jnp.asarray(probes(SEED_ADAM + e, n, p)))
        losses.append(float(v_))
        for k in NAMES:
            traj[k].append(np.asarray(raw[k], np.float32))
        print(f"adam step {e}: nlml {float(v_):.6f} ({time.perf_counter() - t0:.1f} s so far)", flush=True)
    out["adam_loss"] = np.asarray(losses, np.float32)
    for k in NAMES:
        out[f"adam_{k}"] = np.stack(traj[k])

    smodel = MODEL.with_fitted_mixture(best, x)
    sdk = smodel.dk
    out["serve_weights"] = np.asarray(sdk.weights, np.float64)
    print(f"weights at model_best.pkl {np.round(out['serve_weights'], 5).tolist()}", flush=True)
    cache = smodel.posterior_cache(best, x, y, jax.random.PRNGKey(0))
    mean, var = smodel.predict_from_cache(cache, x, xt)
    mean, var = np.asarray(mean), np.asarray(var)

    @jax.jit
    def eval_cg(raw):
        params = smodel.constrained(raw)
        ref = x * params["inv_ell"]
        mv = smodel._khat_mv(params, build_plan_any(ref, sdk))
        P = build_precond(sdk, smodel.bbmm, params, ref, n)
        r = cg_solve(mv, (y - params["mean"])[:, None], tol=smodel.eval_cg_tolerance,
                     max_iters=smodel.bbmm.max_cg_iterations, precond=lambda V: precond_solve(P, V))
        return r.iterations, r.residual_norm[0]

    cg_iters, cg_res = eval_cg(best)
    err = mean - ds.test_y
    out.update(mean=mean.astype(np.float32), var=var.astype(np.float32),
               alpha=np.asarray(cache["alpha"], np.float32), cg_iters=np.int32(cg_iters),
               cg_res=np.float32(cg_res), rmse=np.float32(np.sqrt((err**2).mean())),
               nll=np.float32(0.5 * (np.log(2 * np.pi * var) + err**2 / var).mean()))
    for k in NAMES:
        out[f"best_{k}"] = np.asarray(best[k], np.float32)
    print(f"serving at model_best.pkl: rmse {float(out['rmse']):.4f} nll {float(out['nll']):.4f} "
          f"cg_iters {int(cg_iters)} cg_res {float(cg_res):.3e} ({time.perf_counter() - t0:.1f} s so far)",
          flush=True)

    mvm_accuracy(ds, out)
    np.savez_compressed(OUT, **out)
    print(f"total {time.perf_counter() - t0:.1f} s (CPU, incl. compile) -> {OUT}")


if __name__ == "__main__":
    main()
