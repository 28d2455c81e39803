"""The port's CG and pivoted-Cholesky preconditioner held against the JAX package.

Same numpy inputs on both sides, PyTorch on the CPU (plain versions of the
kernels).  CG must take the SAME number of iterations as the JAX solver;
its solution agrees to f32 roundoff of the two reduction orders (rtol 1e-4
relative to the solution norm).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel_err

from simplex_gp_torch.linalg import cg as t_cg
from simplex_gp_torch.linalg import pivoted_cholesky as t_pc
from simplex_gp_torch.ops import kernels as t_kernels
from simplex_gp_tpu.linalg import cg as j_cg
from simplex_gp_tpu.ops import kernels as j_kernels

# simplex_gp_tpu.linalg exports a function of the module's own name.
j_pc = importlib.import_module("simplex_gp_tpu.linalg.pivoted_cholesky")


def _spd(n, cond, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    evals = np.geomspace(1.0, cond, n)
    return ((Q * evals) @ Q.T).astype(np.float32)


def _run_both(A, b, precond_diag=None, **kw):
    jA, tA = jnp.asarray(A), torch.from_numpy(A)
    jp = tp = None
    if precond_diag is not None:
        jd, td = jnp.asarray(precond_diag), torch.from_numpy(precond_diag)
        jp = lambda V: V / jd[:, None]
        tp = lambda V: V / td[:, None]
    jr = j_cg.cg_solve(lambda V: jA @ V, jnp.asarray(b), precond=jp, **kw)
    tr = t_cg.cg_solve(lambda V: tA @ V, torch.from_numpy(b), precond=tp, **kw)
    return jr, tr


@pytest.mark.parametrize("mode,tol,t,jacobi", [
    ("mean", 1e-4, 1, False),
    ("mean", 1e-2, 4, True),
    ("column", 1e-3, 3, True),
])
def test_cg_matches_jax(mode, tol, t, jacobi):
    # Condition 1e2: CG converges in well under n steps, so the iteration
    # count is set by the spectrum and not by f32 loss of orthogonality.
    A = _spd(120, 1e2, seed=0)
    b = np.random.default_rng(1).normal(size=(120, t)).astype(np.float32)
    diag = np.diag(A).copy() if jacobi else None
    jr, tr = _run_both(A, b, diag, tol=tol, max_iters=300, stop_mode=mode)
    assert tr.iterations == int(jr.iterations)
    assert rel_err(tr.x.numpy(), np.asarray(jr.x)) < 1e-4
    # Near the f32 noise floor the final residuals differ in their leading
    # digit; both must meet the stopping rule.
    for res in (tr.residual_norm.numpy(), np.asarray(jr.residual_norm)):
        assert (res.mean() if mode == "mean" else res.max()) < tol


def test_cg_floor_and_stall_guard_match_jax():
    """tol=1 stops at the 10-iteration floor; an unreachable tol stops at the stall guard."""
    A = _spd(60, 10.0, seed=2)
    b = np.random.default_rng(3).normal(size=(60, 2)).astype(np.float32)
    jr, tr = _run_both(A, b, tol=1.0, max_iters=100)
    assert tr.iterations == int(jr.iterations) == 10
    jr, tr = _run_both(A, b, tol=0.0, max_iters=400, stall_window=5)
    assert tr.iterations == int(jr.iterations) < 400
    assert rel_err(tr.x.numpy(), np.asarray(jr.x)) < 1e-4


def test_cg_breakdown_freeze_matches_jax():
    """An indefinite operator (pap <= 0) freezes the column at its best iterate."""
    rng = np.random.default_rng(4)
    Q, _ = np.linalg.qr(rng.normal(size=(40, 40)))
    evals = np.concatenate([-np.ones(5), np.linspace(1.0, 3.0, 35)])
    A = ((Q * evals) @ Q.T).astype(np.float32)
    b = rng.normal(size=(40, 2)).astype(np.float32)
    jr, tr = _run_both(A, b, tol=1e-6, max_iters=200, stop_mode="column")
    assert tr.iterations == int(jr.iterations)
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tr.residual_norm.numpy(), np.asarray(jr.residual_norm), rtol=1e-4)


def _features(n=400, d=3, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)) * np.array([0.8, 1.5, 0.5])[:d]).astype(np.float32)


@pytest.mark.parametrize("kind", ["rbf", "matern"])
def test_pivoted_cholesky_features_matches_jax(kind):
    ref = _features()
    s = np.float32(1.3)
    jdk = j_kernels.rbf_kernel(1) if kind == "rbf" else j_kernels.matern_kernel(1.5, 1)
    tdk = t_kernels.rbf_kernel(1) if kind == "rbf" else t_kernels.matern_kernel(1.5, 1)
    kfun = lambda d2: s * j_kernels.kernel_value_jnp(jdk, d2)
    jpc = j_pc.pivoted_cholesky_features(jnp.asarray(ref), s * jnp.ones(400), kfun, 30)
    tpc = t_pc.pivoted_cholesky_features(torch.from_numpy(ref), s * torch.ones(400), tdk.nu,
                                         torch.tensor(s), 30)
    np.testing.assert_array_equal(tpc.pivots.numpy(), np.asarray(jpc.pivots))
    np.testing.assert_allclose(tpc.L.numpy(), np.asarray(jpc.L), rtol=1e-4, atol=2e-5)


def test_pivot_threshold_zeroes_exhausted_columns():
    """Rank above the numerical rank: exhausted pivots give zero columns, as in JAX."""
    ref = np.repeat(_features(n=20, seed=6), 5, axis=0)  # 20 distinct points, rank <= 20
    jdk = j_kernels.rbf_kernel(1)
    kfun = lambda d2: j_kernels.kernel_value_jnp(jdk, d2)
    jpc = j_pc.pivoted_cholesky_features(jnp.asarray(ref), jnp.ones(100), kfun, 30)
    tpc = t_pc.pivoted_cholesky_features(torch.from_numpy(ref), torch.ones(100), 0.0,
                                         torch.tensor(1.0), 30)
    jL = np.asarray(jpc.L)
    assert (np.abs(jL[:, 25:]).max() == 0) and (tpc.L[:, 25:].abs().max() == 0)
    np.testing.assert_allclose(tpc.L.numpy(), jL, rtol=1e-4, atol=2e-5)


def test_preconditioner_matches_jax():
    rng = np.random.default_rng(7)
    L = (rng.normal(size=(300, 20)) * np.geomspace(3.0, 1e-3, 20)).astype(np.float32)
    V = rng.normal(size=(300, 3)).astype(np.float32)
    noise = np.float32(0.05)
    jP = j_pc.make_preconditioner(jnp.asarray(L), jnp.float32(noise), 300)
    tP = t_pc.make_preconditioner(torch.from_numpy(L), torch.tensor(noise), 300)
    np.testing.assert_allclose(tP.s2.numpy(), np.asarray(jP.s2), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(tP.logdet), float(jP.logdet), rtol=1e-5)
    np.testing.assert_allclose(float(tP.gamma), float(jP.gamma), rtol=1e-5)
    for t_fn, j_fn in ((t_pc.precond_solve, j_pc.precond_solve),
                       (t_pc.precond_inv_sqrt, j_pc.precond_inv_sqrt),
                       (t_pc.precond_sqrt, j_pc.precond_sqrt)):
        out_t = t_fn(tP, torch.from_numpy(V)).numpy()
        out_j = np.asarray(j_fn(jP, jnp.asarray(V)))
        assert rel_err(out_t, out_j) < 1e-4


def test_preconditioned_cg_on_kernel_matrix_matches_jax():
    """The eval solve's pieces together: exact-kernel preconditioner + CG, equal iterations."""
    ref = _features(n=300, seed=8)
    s, noise = np.float32(1.1), np.float32(0.1)
    jdk, tdk = j_kernels.matern_kernel(1.5, 1), t_kernels.matern_kernel(1.5, 1)
    d2 = ((ref[:, None, :] - ref[None, :, :]) ** 2).sum(-1)
    A = (s * np.asarray(j_kernels.kernel_value_jnp(jdk, jnp.asarray(d2))) + noise * np.eye(300)).astype(np.float32)
    b = np.random.default_rng(9).normal(size=(300, 1)).astype(np.float32)
    kfun = lambda x: s * j_kernels.kernel_value_jnp(jdk, x)
    jP = j_pc.make_preconditioner(
        j_pc.pivoted_cholesky_features(jnp.asarray(ref), s * jnp.ones(300), kfun, 40).L, jnp.float32(noise), 300)
    tP = t_pc.make_preconditioner(
        t_pc.pivoted_cholesky_features(torch.from_numpy(ref), s * torch.ones(300), tdk.nu,
                                       torch.tensor(s), 40).L, torch.tensor(noise), 300)
    jA, tA = jnp.asarray(A), torch.from_numpy(A)
    jr = j_cg.cg_solve(lambda V: jA @ V, jnp.asarray(b), tol=1e-4, precond=lambda V: j_pc.precond_solve(jP, V))
    tr = t_cg.cg_solve(lambda V: tA @ V, torch.from_numpy(b), tol=1e-4, precond=lambda V: t_pc.precond_solve(tP, V))
    assert tr.iterations == int(jr.iterations)
    assert rel_err(tr.x.numpy(), np.asarray(jr.x)) < 1e-4


def test_cg_zero_rhs_column():
    """A zero right-hand side stays zero (b_norm guard) in both packages."""
    A = _spd(30, 10.0, seed=10)
    b = np.zeros((30, 2), np.float32)
    b[:, 0] = np.random.default_rng(11).normal(size=30)
    jr, tr = _run_both(A, b, tol=1e-5, max_iters=100)
    assert tr.iterations == int(jr.iterations)
    assert float(tr.x[:, 1].abs().max()) == 0.0
    assert jax.numpy.abs(jr.x[:, 1]).max() == 0.0


def test_pivoted_cholesky_low_rank_recovery():
    """Port of test_linalg.py::test_pivoted_cholesky_low_rank_recovery: rank 8 recovers an exactly rank-8 K."""
    n, k = 50, 8
    rng = np.random.default_rng(8)
    L0 = rng.normal(size=(n, k))
    K = torch.from_numpy((L0 @ L0.T).astype(np.float32))
    pc = t_pc.pivoted_cholesky(torch.diagonal(K), lambda i: K[:, i], rank=k)
    np.testing.assert_allclose((pc.L @ pc.L.T).numpy(), K.numpy(), rtol=1e-3, atol=1e-2)


def test_pivoted_cholesky_matches_jax_and_the_features_form():
    """The column oracle against JAX's on the same kernel matrix, and against the exact-row factorization."""
    n, d, k = 60, 3, 12
    ref = np.random.default_rng(10).normal(size=(n, d)).astype(np.float32)
    rt = torch.from_numpy(ref)
    Kt = torch.exp(-((rt[:, None, :] - rt[None, :, :]) ** 2).sum(-1))
    pc = t_pc.pivoted_cholesky(torch.ones(n), lambda i: Kt[:, i], rank=k)
    Kj = jnp.asarray(Kt.numpy())
    jpc = j_pc.pivoted_cholesky(jnp.ones(n), lambda i: Kj[:, i], rank=k)
    assert pc.pivots.tolist() == np.asarray(jpc.pivots).tolist()
    np.testing.assert_allclose(pc.L.numpy(), np.asarray(jpc.L), rtol=1e-4, atol=1e-5)
    feat = t_pc.pivoted_cholesky_features(rt, torch.ones(n), 0.0, torch.tensor(1.0), k)
    assert pc.pivots.tolist() == feat.pivots.tolist()
    np.testing.assert_allclose(pc.L.numpy(), feat.L.numpy(), rtol=1e-4, atol=1e-5)


def test_woodbury_solve_and_logdet():
    """Port of test_linalg.py::test_woodbury_solve_and_logdet, and against JAX's."""
    n, k = 40, 6
    rng = np.random.default_rng(9)
    L = rng.normal(size=(n, k)).astype(np.float32)
    V = rng.normal(size=(n, 2)).astype(np.float32)
    P = L.astype(np.float64) @ L.T + 0.5 * np.eye(n)
    noise = torch.tensor(0.5)
    got = t_pc.woodbury_solve(torch.from_numpy(L), noise, torch.from_numpy(V)).numpy()
    np.testing.assert_allclose(got, np.linalg.solve(P, V), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got, np.asarray(j_pc.woodbury_solve(jnp.asarray(L), jnp.float32(0.5),
                                                                   jnp.asarray(V))), rtol=1e-4, atol=1e-5)
    logdet = float(t_pc.woodbury_logdet(torch.from_numpy(L), noise, n))
    np.testing.assert_allclose(logdet, np.linalg.slogdet(P)[1], rtol=1e-4)
    np.testing.assert_allclose(logdet, float(j_pc.woodbury_logdet(jnp.asarray(L), jnp.float32(0.5), n)),
                               rtol=1e-5)
