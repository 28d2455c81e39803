"""The port's CG tridiagonal record, Lanczos and SLQ log-det held against the JAX package.

Same numpy inputs on both sides.  Tolerances, each with its reason:
  * CG record: the liveness mask equal, element for element; alphas and
    betas rel 1e-5 (f32 roundoff of the two reduction orders, on a
    well-conditioned system that converges before the roundoff grows);
  * Lanczos coefficients rel 1e-4 over 20 steps of CGS2 (the same roundoff,
    carried through the recurrence);
  * the quadratures fed identical coefficients: rel 1e-5 (batched f32 eigh
    in LAPACK on both sides, eigenvector signs do not enter e1^2 weights);
  * the ports of tests/test_linalg.py keep their own bounds against dense
    slogdet (5% relative).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel_err

from simplex_gp_torch.linalg import cg as t_cg
from simplex_gp_torch.linalg import lanczos as t_lz
from simplex_gp_torch.linalg import pivoted_cholesky as t_pc
from simplex_gp_tpu.linalg import cg as j_cg

# simplex_gp_tpu.linalg exports a function of the module's own name.
j_lz = importlib.import_module("simplex_gp_tpu.linalg.lanczos")


def _spd(n, seed, cond=100.0):
    """tests/test_linalg.py::_spd, in float32."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    evals = np.geomspace(1.0, cond, n)
    return ((Q * evals) @ Q.T).astype(np.float32)


def _probes(n, p, seed):
    return np.random.default_rng(seed).choice([-1.0, 1.0], size=(n, p)).astype(np.float32)


@pytest.mark.parametrize("jacobi", [False, True])
@pytest.mark.parametrize("stop_mode,tol", [("mean", 1e-4), ("column", 1e-3)])
def test_cg_tridiag_record_matches_jax(stop_mode, tol, jacobi):
    A = _spd(80, 3, cond=20.0)
    b = _probes(80, 5, 4)
    b[:, 0] *= 1e-3 * np.arange(80)  # a column of another scale converges on its own schedule
    jA, tA = jnp.asarray(A), torch.from_numpy(A)
    jp = tp = None
    if jacobi:
        dg = np.diag(A).copy()
        jp, tp = (lambda V: V / jnp.asarray(dg)[:, None]), (lambda V: V / torch.from_numpy(dg)[:, None])
    kw = dict(tol=tol, max_iters=200, stop_mode=stop_mode, tridiag_m=40)
    jr = j_cg.cg_solve(lambda V: jA @ V, jnp.asarray(b), precond=jp, **kw)
    tr = t_cg.cg_solve(lambda V: tA @ V, torch.from_numpy(b), precond=tp, **kw)
    assert tr.iterations == int(jr.iterations)
    np.testing.assert_array_equal(tr.tmask.numpy(), np.asarray(jr.tmask))
    assert not bool(tr.tmask.all())  # dead steps exist and keep (alpha 1, beta 0)
    dead = ~tr.tmask.numpy()
    assert (tr.alphas.numpy()[dead] == 1.0).all() and (tr.betas.numpy()[dead] == 0.0).all()
    assert rel_err(tr.alphas, jr.alphas) < 1e-5
    assert rel_err(tr.betas, jr.betas) < 1e-5


def test_lanczos_matches_jax():
    A = _spd(60, 4, cond=50.0)
    z = _probes(60, 3, 5)
    jres = j_lz.lanczos(lambda v: jnp.asarray(A) @ v, jnp.asarray(z), num_iters=20)
    tres = t_lz.lanczos(lambda v: torch.from_numpy(A) @ v, torch.from_numpy(z), num_iters=20)
    assert tres.alphas.shape == (3, 20) and tres.betas.shape == (3, 19) and tres.vecs.shape == (20, 60, 3)
    assert rel_err(tres.alphas, jres.alphas) < 1e-4
    assert rel_err(tres.betas, jres.betas) < 1e-4


def test_lanczos_breakdown_freeze_matches_jax():
    """A 6-dim Krylov space: the column freezes with alpha 1 / beta 0, as in JAX."""
    A = np.diag(np.repeat(np.arange(1.0, 7.0), 5)).astype(np.float32)
    z = _probes(30, 2, 6)
    jres = j_lz.lanczos(lambda v: jnp.asarray(A) @ v, jnp.asarray(z), num_iters=12)
    tres = t_lz.lanczos(lambda v: torch.from_numpy(A) @ v, torch.from_numpy(z), num_iters=12)
    np.testing.assert_array_equal(tres.betas.numpy()[:, 6:] == 0, np.asarray(jres.betas)[:, 6:] == 0)
    assert (tres.alphas.numpy()[:, 7:] == 1.0).all()
    np.testing.assert_allclose(tres.alphas.numpy()[:, :6], np.asarray(jres.alphas)[:, :6], rtol=1e-4)


def test_tridiag_matrices_matches_jax():
    rng = np.random.default_rng(7)
    al, be = rng.normal(size=(4, 9)).astype(np.float32), rng.normal(size=(4, 8)).astype(np.float32)
    np.testing.assert_array_equal(t_lz.tridiag_matrices(torch.from_numpy(al), torch.from_numpy(be)).numpy(),
                                  np.asarray(j_lz.tridiag_matrices(jnp.asarray(al), jnp.asarray(be))))


def test_slq_logdet_matches_jax():
    A = _spd(100, 6, cond=100.0)
    z = _probes(100, 16, 7)
    j = float(j_lz.slq_logdet(lambda v: jnp.asarray(A) @ v, jnp.asarray(z), num_iters=30))
    t = float(t_lz.slq_logdet(lambda v: torch.from_numpy(A) @ v, torch.from_numpy(z), num_iters=30))
    assert abs(t - j) <= 1e-4 * abs(j)


def test_logdet_from_cg_tridiag_matches_jax_on_identical_records():
    A = _spd(96, 9, cond=5.0)
    z = _probes(96, 16, 17)
    jr = j_cg.cg_solve(lambda v: jnp.asarray(A) @ v, jnp.asarray(z), tol=1e-6, max_iters=80, tridiag_m=80)
    rec = [np.array(a) for a in (jr.alphas, jr.betas, jr.tmask)]
    z2 = (z * z).sum(0)
    j = float(j_lz.logdet_from_cg_tridiag(*map(jnp.asarray, rec), jnp.asarray(z2)))
    t = float(t_lz.logdet_from_cg_tridiag(*map(torch.from_numpy, rec), torch.from_numpy(z2)))
    assert abs(t - j) <= 1e-5 * abs(j)


def test_lanczos_root_matches_jax():
    A = _spd(40, 8, cond=10.0)
    z = _probes(40, 1, 9)
    jQ, jT = j_lz.lanczos_root(lambda v: jnp.asarray(A) @ v, jnp.asarray(z), 10)
    tQ, tT = t_lz.lanczos_root(lambda v: torch.from_numpy(A) @ v, torch.from_numpy(z), 10)
    assert rel_err(tT, jT) < 1e-4 and rel_err(tQ, jQ) < 1e-3


# ---- ports of tests/test_linalg.py (:55, :66, :178, :237, :273) ---------------


def test_lanczos_recovers_eigenvalues():
    n = 60
    A = torch.from_numpy(_spd(n, 4, cond=50.0))
    z = torch.from_numpy(np.random.default_rng(5).normal(size=(n, 1)).astype(np.float32))
    res = t_lz.lanczos(lambda v: A @ v, z, num_iters=n)
    T = t_lz.tridiag_matrices(res.alphas, res.betas)[0]
    ritz = np.sort(np.linalg.eigvalsh(T.numpy()))
    true = np.sort(np.linalg.eigvalsh(A.numpy()))
    np.testing.assert_allclose(ritz[-5:], true[-5:], rtol=1e-2)


def test_slq_logdet_accuracy():
    n, p = 100, 16
    A = _spd(n, 6, cond=100.0)
    z = torch.from_numpy(_probes(n, p, 7))
    est = float(t_lz.slq_logdet(lambda v: torch.from_numpy(A) @ v, z, num_iters=50))
    true = float(np.linalg.slogdet(A.astype(np.float64))[1])
    assert abs(est - true) / abs(true) < 0.05, (est, true)


def test_preconditioned_slq_logdet_beats_plain():
    """log|P| + SLQ(P^{-1/2} K P^{-1/2}) at least as accurate as plain SLQ (same budget)."""
    n, p, k = 120, 8, 30
    rng = np.random.default_rng(13)
    X = rng.normal(size=(n, 2))
    d2 = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    noise = 1e-3
    Kd = np.exp(-d2)
    A = torch.from_numpy((Kd + noise * np.eye(n)).astype(np.float32))
    true = float(np.linalg.slogdet(Kd + noise * np.eye(n))[1])
    z = torch.from_numpy(rng.choice([-1.0, 1.0], size=(n, p)).astype(np.float32))
    m = 15
    plain = float(t_lz.slq_logdet(lambda v: A @ v, z, num_iters=m))
    # The exact-kernel pivoted Cholesky of exp(-d2) (rbf: nu = 0) stands in
    # for JAX's column-oracle pivoted_cholesky on the same matrix.
    pc = t_pc.pivoted_cholesky_features(torch.from_numpy(X.astype(np.float32)), torch.ones(n), 0.0,
                                        torch.tensor(1.0), k)
    P = t_pc.make_preconditioner(pc.L, torch.tensor(noise, dtype=torch.float32), n)
    mv_pre = lambda v: t_pc.precond_inv_sqrt(P, A @ t_pc.precond_inv_sqrt(P, v))
    pre = float(P.logdet) + float(t_lz.slq_logdet(mv_pre, z, num_iters=m))
    assert abs(pre - true) <= abs(plain - true) + 1e-3, (pre, plain, true)
    assert abs(pre - true) / abs(true) < 0.05, (pre, true)


def test_cg_tridiag_logdet_matches_dense():
    n, p, m = 200, 48, 60
    A = _spd(n, 7, cond=200.0)
    tA = torch.from_numpy(A)
    truth = np.linalg.slogdet(A.astype(np.float64))[1]
    z = torch.from_numpy(_probes(n, p, 13))
    z_norm2 = (z * z).sum(0)
    res = t_cg.cg_solve(lambda v: tA @ v, z, tol=1e-8, max_iters=m, tridiag_m=m)
    est = float(t_lz.logdet_from_cg_tridiag(res.alphas, res.betas, res.tmask, z_norm2))
    assert abs(est - truth) / abs(truth) < 0.05, (est, truth)

    L = torch.from_numpy(np.linalg.cholesky(A.astype(np.float64))[:, :12].astype(np.float32))
    P = t_pc.make_preconditioner(L, torch.tensor(1.0), n)
    b = t_pc.precond_sqrt(P, z)
    res_p = t_cg.cg_solve(lambda v: tA @ v, b, tol=1e-8, max_iters=m,
                          precond=lambda v: t_pc.precond_solve(P, v), tridiag_m=m)
    est_p = float(t_lz.logdet_from_cg_tridiag(res_p.alphas, res_p.betas, res_p.tmask, z_norm2)) + float(P.logdet)
    assert abs(est_p - truth) / abs(truth) < 0.05, (est_p, truth)


def test_cg_tridiag_truncation_on_early_convergence():
    n, p = 96, 16
    A = _spd(n, 9, cond=5.0)
    z = torch.from_numpy(_probes(n, p, 17))
    res = t_cg.cg_solve(lambda v: torch.from_numpy(A) @ v, z, tol=1e-6, max_iters=80, tridiag_m=80)
    assert bool(res.tmask.any()) and not bool(res.tmask.all())
    est = float(t_lz.logdet_from_cg_tridiag(res.alphas, res.betas, res.tmask, (z * z).sum(0)))
    truth = np.linalg.slogdet(A.astype(np.float64))[1]
    assert np.isfinite(est)
    assert abs(est - truth) / abs(truth) < 0.05, (est, truth)
