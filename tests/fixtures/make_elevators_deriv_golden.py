"""Write the JAX-on-CPU golden file for the derivative-tap gradient and the MVM check at elevators.

Runs the unchanged JAX package on the seeded synthetic stand-in of elevators
(as ``elevators_train_golden.npz``) and records:

  * the training path with ``BBMMConfig(grad_mode="deriv_filter")`` -- the
    reference-parity gradient, whose backward runs the one-shot filter and
    the derivative-tap filter (simplex_gp_tpu/ops/filter.py::lattice_filter)
    -- in the configuration of ``runs/r5/simplexgp_elevators_s0`` (SimplexGP
    d=18, Matern-1.5, order 1, min_noise 0.1; cg tol 1.0, 500 CG / 100
    Lanczos iterations, preconditioner rank 100, 10 probes, slq_mode "cg"):
    the NLML and its raw-parameter gradients at the median init and at the
    trained ``model_best.pkl``, and three Adam steps (lr 0.1) from the median
    init, with the probes of ``make_elevators_train_golden.py`` (numpy
    Rademacher draws from the same seeds);
  * experiments/mvm_err.py's accuracy measurement for rbf order 1 on all
    16,599 rows (train, val and test; --max-exact 20000 covers them):
    ``filter_once`` of the targets against the dense kernel product, as
    rel_err and cos_err, with the dense side computed in row blocks;
  * the lattice occupancy (``count_lattice_points``) of those 16,599 rows
    and of the median-init training positions.

The PyTorch port's ``chip_smoke.py`` holds the GPU run against this file.
Run from the repository root::

    JAX_PLATFORMS=cpu python tests/fixtures/make_elevators_deriv_golden.py
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
from simplex_gp_tpu.linalg.mll import lattice_nlml  # noqa: E402
from simplex_gp_tpu.ops import kernels as K  # noqa: E402
from simplex_gp_tpu.ops.lattice import count_lattice_points, filter_once  # noqa: E402
from simplex_gp_tpu.utils.data import _synthetic_uci, prepare_dataset  # noqa: E402

PARAMS = ROOT / "runs" / "r5" / "simplexgp_elevators_s0" / "model_best.pkl"
OUT = ROOT / "tests" / "fixtures" / "elevators_deriv_golden.npz"

MODEL = SimplexGP(
    num_dims=18, kernel="matern", nu=1.5, order=1, min_noise=0.1,
    bbmm=BBMMConfig(cg_tolerance=1.0, max_cg_iterations=500, max_lanczos_iterations=100,
                    precond_rank=100, num_probes=10, slq_mode="cg", grad_mode="deriv_filter"),
)
NAMES = ("raw_lengthscale", "raw_outputscale", "raw_noise", "mean")
SEED_INIT, SEED_BEST, SEED_ADAM = 100, 101, 200  # Adam step e draws seed SEED_ADAM + e
ADAM_STEPS, LR = 3, 0.1
MVM_ORDER, MAX_EXACT, BLOCK = 1, 20000, 1024


def probes(seed: int, n: int, p: int) -> np.ndarray:
    return np.random.default_rng(seed).choice([-1.0, 1.0], size=(n, p)).astype(np.float32)


def median_lengthscale(x: np.ndarray) -> float:
    """experiments/common.py:95-103: median pairwise distance of 2,000 rows / sqrt(2)."""
    sub = x[np.random.default_rng(0).permutation(x.shape[0])[:2000]]
    d2 = ((sub[:, None, :] - sub[None, :, :]) ** 2).sum(-1)
    return float(np.sqrt(np.median(d2[d2 > 0]))) / np.sqrt(2.0)


def mvm_accuracy(ds, out: dict):
    """experiments/mvm_err.py:78-113 for rbf order 1, the dense product in row blocks."""
    dk = K.rbf_kernel(MVM_ORDER)
    x_all = np.concatenate([ds.train_x, ds.val_x, ds.test_x], axis=0)
    y_all = np.concatenate([ds.train_y, ds.val_y, ds.test_y], axis=0)
    ns = min(MAX_EXACT, x_all.shape[0])
    xs, vs = x_all[:ns], y_all[:ns, None]
    lat_s = np.asarray(filter_once(jnp.asarray(vs), jnp.asarray(xs), dk.coeffs, dk.variance))
    xj, vj = jnp.asarray(xs), jnp.asarray(vs)

    @jax.jit
    def rows(xb):
        d2 = ((xb[:, None, :] - xj[None, :, :]) ** 2).sum(-1)
        return K.kernel_value_jnp(dk, d2) @ vj

    exact = np.concatenate([np.asarray(rows(xj[i:i + BLOCK])) for i in range(0, ns, BLOCK)])
    scale = (lat_s * exact).sum() / (lat_s * lat_s).sum()
    out["mvm_rel_err"] = np.float64(np.linalg.norm(scale * lat_s - exact) / np.linalg.norm(exact))
    out["mvm_cos_err"] = np.float64((lat_s * exact).sum() / (np.linalg.norm(lat_s) * np.linalg.norm(exact)))
    out["mvm_exact_subset_n"] = np.int32(ns)
    out["mvm_n_lattice"] = np.int32(count_lattice_points(jnp.asarray(x_all), dk.variance, dk.coeffs))
    print(f"mvm_err elevators: rel {float(out['mvm_rel_err']):.6f} cos {float(out['mvm_cos_err']):.6f} "
          f"occupancy {int(out['mvm_n_lattice'])}", flush=True)


def main():
    ds = prepare_dataset(_synthetic_uci("elevators"), "elevators")
    x, y = jnp.asarray(ds.train_x), jnp.asarray(ds.train_y)
    n, p = x.shape[0], MODEL.bbmm.num_probes
    ell0 = median_lengthscale(ds.train_x)
    raw0 = MODEL.init_params(lengthscale=ell0)
    with open(PARAMS, "rb") as f:
        best = {k: jnp.asarray(v) for k, v in pickle.load(f).items()}

    out = {"ls_init": np.float32(ell0), "num_probes": np.int32(p),
           "seed_init": np.int32(SEED_INIT), "seed_best": np.int32(SEED_BEST),
           "seed_adam": np.int32(SEED_ADAM)}
    t0 = time.perf_counter()
    mvm_accuracy(ds, out)
    dk = MODEL.dk
    ref0 = x * MODEL.constrained(raw0)["inv_ell"]
    out["n_lattice_init"] = np.int32(count_lattice_points(ref0, dk.variance, dk.coeffs))

    def loss(raw, z):
        return lattice_nlml(MODEL.dk, MODEL.bbmm, MODEL.constrained(raw), x, y, z)

    value_and_grad = jax.jit(jax.value_and_grad(loss))
    for tag, raw, seed in (("init", raw0, SEED_INIT), ("best", best, SEED_BEST)):
        v, g = value_and_grad(raw, jnp.asarray(probes(seed, n, p)))
        out[f"loss_{tag}"] = np.float32(v)
        for k in NAMES:
            out[f"{tag}_{k}"] = np.asarray(raw[k], np.float32)
            out[f"grad_{tag}_{k}"] = np.asarray(g[k], np.float32)
        print(f"{tag}: nlml {float(v):.6f} ({time.perf_counter() - t0:.1f} s so far)", flush=True)

    opt = optax.adam(LR)

    @jax.jit
    def step(raw, opt_state, z):
        v, g = jax.value_and_grad(loss)(raw, z)
        updates, opt_state = opt.update(g, opt_state)
        return optax.apply_updates(raw, updates), opt_state, v

    raw, opt_state = raw0, opt.init(raw0)
    losses, traj = [], {k: [] for k in NAMES}
    for e in range(ADAM_STEPS):
        raw, opt_state, v = step(raw, opt_state, jnp.asarray(probes(SEED_ADAM + e, n, p)))
        losses.append(float(v))
        for k in NAMES:
            traj[k].append(np.asarray(raw[k], np.float32))
        print(f"adam step {e}: nlml {float(v):.6f}", flush=True)
    out["adam_loss"] = np.asarray(losses, np.float32)
    for k in NAMES:
        out[f"adam_{k}"] = np.stack(traj[k])
    np.savez_compressed(OUT, **out)
    print(f"total {time.perf_counter() - t0:.1f} s (CPU, incl. compile) -> {OUT}")


if __name__ == "__main__":
    main()
