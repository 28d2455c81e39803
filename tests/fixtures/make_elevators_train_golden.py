"""Write the JAX-on-CPU golden file for the full-size elevators training path.

Runs the unchanged JAX package on the 10,623 elevators training rows
(the seeded synthetic stand-in, as ``elevators_golden.npz``) with the
configuration of ``runs/r5/simplexgp_elevators_s0`` (SimplexGP d=18,
Matern-1.5, order 1, min_noise 0.1; BBMM cg tol 1.0, 500 CG / 100 Lanczos
iterations, preconditioner rank 100, 10 probes, slq_mode "cg", exact
gradients) and records:

  * the median-init raw parameters (experiments/common.py:95-103);
  * the NLML and its raw-parameter gradients at that point and at the
    trained ``model_best.pkl``, each with the seed of its probes;
  * three Adam steps (lr 0.1) from the median init, as
    experiments/common.py's jitted step takes them, with the per-step
    losses and the raw parameters after each step.

Probes are Rademacher draws made with numpy,
``default_rng(seed).choice([-1, 1], (n, 10))`` as float32, so the port can
feed the same ones.  The PyTorch port's ``chip_smoke.py`` holds the GPU run
against this file.  Run from the repository root::

    JAX_PLATFORMS=cpu python tests/fixtures/make_elevators_train_golden.py
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
from simplex_gp_tpu.utils.data import _synthetic_uci, prepare_dataset  # noqa: E402

PARAMS = ROOT / "runs" / "r5" / "simplexgp_elevators_s0" / "model_best.pkl"
OUT = ROOT / "tests" / "fixtures" / "elevators_train_golden.npz"

MODEL = SimplexGP(
    num_dims=18, kernel="matern", nu=1.5, order=1, min_noise=0.1,
    bbmm=BBMMConfig(cg_tolerance=1.0, max_cg_iterations=500, max_lanczos_iterations=100,
                    precond_rank=100, num_probes=10, slq_mode="cg", grad_mode="exact"),
)
NAMES = ("raw_lengthscale", "raw_outputscale", "raw_noise", "mean")
SEED_INIT, SEED_BEST, SEED_ADAM = 100, 101, 200  # Adam step e draws seed SEED_ADAM + e
ADAM_STEPS, LR = 3, 0.1


def probes(seed: int, n: int, p: int) -> np.ndarray:
    return np.random.default_rng(seed).choice([-1.0, 1.0], size=(n, p)).astype(np.float32)


def median_lengthscale(x: np.ndarray) -> float:
    """experiments/common.py:95-103: median pairwise distance of 2,000 rows / sqrt(2)."""
    sub = x[np.random.default_rng(0).permutation(x.shape[0])[:2000]]
    d2 = ((sub[:, None, :] - sub[None, :, :]) ** 2).sum(-1)
    return float(np.sqrt(np.median(d2[d2 > 0]))) / np.sqrt(2.0)


def main():
    ds = prepare_dataset(_synthetic_uci("elevators"), "elevators")
    x, y = jnp.asarray(ds.train_x), jnp.asarray(ds.train_y)
    n, p = x.shape[0], MODEL.bbmm.num_probes
    ell0 = median_lengthscale(ds.train_x)
    raw0 = MODEL.init_params(lengthscale=ell0)
    with open(PARAMS, "rb") as f:
        best = {k: jnp.asarray(v) for k, v in pickle.load(f).items()}

    def loss(raw, z):
        return lattice_nlml(MODEL.dk, MODEL.bbmm, MODEL.constrained(raw), x, y, z)

    value_and_grad = jax.jit(jax.value_and_grad(loss))
    out = {"ls_init": np.float32(ell0), "num_probes": np.int32(p),
           "seed_init": np.int32(SEED_INIT), "seed_best": np.int32(SEED_BEST),
           "seed_adam": np.int32(SEED_ADAM)}
    t0 = time.perf_counter()
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
