"""Write the JAX-on-CPU golden file for the houseelectric training plan.

Runs the unchanged JAX package on the seeded synthetic stand-in of
houseelectric (2,049,280 x 11; prepare_dataset's 0.8/0.8 split gives
1,311,539 training rows) with the model of ``runs/r5/simplexgp_houseelectric_s0``
(SimplexGP d=11, Matern-1.5, order 1, min_noise 0.1, median lengthscale
init; BBMM cg tol 1.0, 500 CG / 100 Lanczos iterations, preconditioner rank
100, 10 probes, slq_mode "cg", exact gradients, ``--plan-capacity -1``) and
records:

  * at all training rows: the median-init lengthscale, the occupancy
    ``count_lattice_points`` finds at it and the capacity the trainer's
    autotrim takes from it (experiments/train_simplexgp.py:53-67);
  * at the first ``MAX_N`` = 360,000 training rows (``--max-n 360000``):
    the same three numbers, and the NLML and its raw-parameter gradients at
    the median init with that capacity as ``BBMMConfig.plan_capacity``,
    with the iterations JAX's training CG ran (tag ``init``); and the same
    with the CG run for exactly ``FIXED_ITERS`` iterations (tag ``fixed``),
    which a port can match whatever side of the tolerance its f32 sums
    fall on;
  * ``ADAM_STEPS`` Adam steps (lr 0.1) from that point at 360,000 rows, as
    experiments/common.py's jitted step takes them, with the CG at tolerance
    1.0: per-step losses and the raw parameters after each step, the probes
    of step e drawn with seed ``SEED + 1 + e``.

Probes are Rademacher draws made with numpy,
``default_rng(SEED).choice([-1, 1], (n, 10))`` as float32, so the port can
feed the same ones.  ``chip_smoke.py`` and the card tests hold the PyTorch
port against this file.  Run from the repository root (about 28 minutes on 8
CPU cores)::

    JAX_PLATFORMS=cpu python tests/fixtures/make_houseelectric_golden.py
"""

from __future__ import annotations

import pathlib
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
from simplex_gp_tpu.linalg.pivoted_cholesky import precond_solve, precond_sqrt  # noqa: E402
from simplex_gp_tpu.ops.filter import apply_plan_any, build_plan_any  # noqa: E402
from simplex_gp_tpu.ops.lattice import count_lattice_points  # noqa: E402
from simplex_gp_tpu.utils.data import _synthetic_uci, prepare_dataset  # noqa: E402

OUT = ROOT / "tests" / "fixtures" / "houseelectric_golden.npz"
MAX_N = 360_000
SEED = 300
FIXED_ITERS = 11
ADAM_STEPS, LR = 5, 0.1
NAMES = ("raw_lengthscale", "raw_outputscale", "raw_noise", "mean")


def probes(seed: int, n: int, p: int) -> np.ndarray:
    return np.random.default_rng(seed).choice([-1.0, 1.0], size=(n, p)).astype(np.float32)


def median_lengthscale(x: np.ndarray) -> float:
    """experiments/common.py:95-103: median pairwise distance of 2,000 rows / sqrt(2)."""
    sub = x[np.random.default_rng(0).permutation(x.shape[0])[:2000]]
    d2 = ((sub[:, None, :] - sub[None, :, :]) ** 2).sum(-1)
    return float(np.sqrt(np.median(d2[d2 > 0]))) / np.sqrt(2.0)


def autotrim(x: np.ndarray, dk) -> tuple[float, int, int]:
    """(median lengthscale, occupancy, capacity) as train_simplexgp.py:53-67 computes them."""
    ell = median_lengthscale(x)
    occ = int(count_lattice_points(jnp.asarray(x / ell), dk.variance, dk.coeffs))
    n, d = x.shape
    return ell, occ, min(-(-int(occ * 1.25) // 8192) * 8192, n * (d + 1))


def cg_iterations(model, params, x, y, z) -> int:
    """Iterations of the training CG inside lattice_nlml (mll.py:159-204), run alone."""
    cfg = model.bbmm
    ref = x * params["inv_ell"]
    plan = build_plan_any(ref, model.dk, capacity=cfg.plan_capacity)
    P = build_precond(model.dk, cfg, params, ref, x.shape[0])
    s, noise = params["outputscale"], params["noise"]
    rhs = jnp.concatenate([(y - params["mean"])[:, None], precond_sqrt(P, z)], axis=-1)
    res = cg_solve(lambda V: s * apply_plan_any(plan, V, model.dk) + noise * V, rhs, tol=cfg.cg_tolerance,
                   max_iters=cfg.max_cg_iterations, precond=lambda V: precond_solve(P, V),
                   tridiag_m=min(cfg.max_lanczos_iterations, cfg.max_cg_iterations))
    return int(res.iterations)


def adam_steps(model, raw, x, y, out, t0):
    """ADAM_STEPS steps of experiments/common.py's jitted Adam step, numpy probes per step."""
    opt = optax.adam(LR)

    @jax.jit
    def step(raw, opt_state, z):
        v, g = jax.value_and_grad(lambda r: lattice_nlml(model.dk, model.bbmm, model.constrained(r), x, y, z))(raw)
        updates, opt_state = opt.update(g, opt_state)
        return optax.apply_updates(raw, updates), opt_state, v

    opt_state, losses, traj = opt.init(raw), [], {k: [] for k in NAMES}
    for e in range(ADAM_STEPS):
        raw, opt_state, v = step(raw, opt_state, jnp.asarray(probes(SEED + 1 + e, MAX_N, 10)))
        losses.append(float(v))
        for k in NAMES:
            traj[k].append(np.asarray(raw[k], np.float32))
        print(f"adam step {e}: nlml {float(v):.6f} ({time.perf_counter() - t0:.1f} s so far)", flush=True)
    out["adam_loss"] = np.asarray(losses, np.float32)
    for k in NAMES:
        out[f"adam_{k}"] = np.stack(traj[k])


def main():
    ds = prepare_dataset(_synthetic_uci("houseelectric"), "houseelectric")
    probe_model = SimplexGP(num_dims=11, kernel="matern", nu=1.5, order=1, min_noise=0.1)
    dk = probe_model.dk
    t0 = time.perf_counter()
    out = {"n_train": np.int32(ds.train_x.shape[0]), "max_n": np.int32(MAX_N), "seed": np.int32(SEED)}
    for tag, x in (("full", ds.train_x), ("cut", ds.train_x[:MAX_N])):
        ell, occ, cap = autotrim(x, dk)
        out.update({f"{tag}_ls_init": np.float32(ell), f"{tag}_occupancy": np.int32(occ),
                    f"{tag}_capacity": np.int32(cap)})
        print(f"{tag} n={x.shape[0]}: ell {ell:.6f}, occupancy {occ}, capacity {cap} "
              f"({time.perf_counter() - t0:.1f} s so far)", flush=True)

    x, y = jnp.asarray(ds.train_x[:MAX_N]), jnp.asarray(ds.train_y[:MAX_N])
    z = jnp.asarray(probes(SEED, MAX_N, 10))
    for tag, tol, iters in (("init", 1.0, 500), ("fixed", 0.0, FIXED_ITERS)):
        model = SimplexGP(
            num_dims=11, kernel="matern", nu=1.5, order=1, min_noise=0.1,
            bbmm=BBMMConfig(cg_tolerance=tol, max_cg_iterations=iters, max_lanczos_iterations=100,
                            precond_rank=100, num_probes=10, slq_mode="cg", grad_mode="exact",
                            plan_capacity=int(out["cut_capacity"])),
        )
        raw = model.init_params(lengthscale=float(out["cut_ls_init"]))

        def loss(raw):
            return lattice_nlml(model.dk, model.bbmm, model.constrained(raw), x, y, z)

        v, g = jax.jit(jax.value_and_grad(loss))(raw)
        out[f"loss_{tag}"] = np.float32(v)
        out[f"cg_iters_{tag}"] = np.int32(cg_iterations(model, model.constrained(raw), x, y, z))
        for k in NAMES:
            out[f"init_{k}"] = np.asarray(raw[k], np.float32)
            out[f"grad_{tag}_{k}"] = np.asarray(g[k], np.float32)
        print(f"cut, {tag}: nlml {float(v):.6f}, {int(out[f'cg_iters_{tag}'])} CG iterations "
              f"({time.perf_counter() - t0:.1f} s so far)", flush=True)
        if tag == "init":
            adam_steps(model, raw, x, y, out, t0)
    np.savez_compressed(OUT, **out)
    print(f"total {time.perf_counter() - t0:.1f} s (CPU, incl. compile) -> {OUT}")


if __name__ == "__main__":
    main()
