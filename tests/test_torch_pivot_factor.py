"""K6's factor with a column-major L and K3'c's fused axes, their plain twins held against JAX and each other.

The same numpy inputs go through JAX's ``pivoted_cholesky_features`` (on the
CPU) and the port's (its plain twins: the tensors lie on the CPU), whose L
is now the (n, k) view of a contiguous (k, n) tensor.  Tolerances: pivots
equal; L at test_torch_linalg.py's rtol 1e-4 / atol 2e-5 (f32 row sums in
another order than XLA's).  The fused argmax of a step (``next_piv``) takes
the lowest index on ties, as torch.argmax and jnp.argmax do.  A column-major
L passed to the preconditioner and the Woodbury helpers gives what its
contiguous copy gives, bit for bit on the CPU.

K3'c fused (``chain_axes_plain``, the twin of one launch for the d+1 axes,
which computes only the live rows and skips taps past them) is held
``torch.equal`` over the live rows to the loop of the per-axis twin
``chain_axis_plain``, on synthetic plans with taps and transitions and on
built plans untrimmed, trimmed and one row short of the occupancy.
"""

import importlib
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from chain_fixtures import RUN_LENGTHS, chain_class_positions, synthetic_chain_plan

from simplex_gp_torch.kernels import chain as KC
from simplex_gp_torch.kernels import pivot as KP
from simplex_gp_torch.linalg import pivoted_cholesky as t_pc
from simplex_gp_torch.ops import kernels as t_kernels
from simplex_gp_torch.ops import lattice as t_lattice
from simplex_gp_tpu.ops import kernels as j_kernels

# simplex_gp_tpu.linalg exports a function of the module's own name.
j_pc = importlib.import_module("simplex_gp_tpu.linalg.pivoted_cholesky")

KINDS = [("rbf", 0.0), ("matern", 0.5), ("matern", 1.5), ("matern", 2.5)]


def _features(n, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)) * np.linspace(0.5, 1.5, d)).astype(np.float32)


def _both(ref, s, kind, nu, rank):
    # kernel_value_jnp reads the kernel's name and nu only (JAX builds no taps for Matern-0.5).
    jdk = SimpleNamespace(name="rbf" if kind == "rbf" else f"matern{nu}", nu=nu)
    kfun = lambda d2: s * j_kernels.kernel_value_jnp(jdk, d2)
    n = ref.shape[0]
    jpc = j_pc.pivoted_cholesky_features(jnp.asarray(ref), s * jnp.ones(n), kfun, rank)
    tpc = t_pc.pivoted_cholesky_features(torch.from_numpy(ref), s * torch.ones(n), nu,
                                         torch.tensor(s), rank)
    return jpc, tpc


@pytest.mark.parametrize("kind,nu", KINDS)
def test_factor_matches_jax_with_a_column_major_L(kind, nu):
    ref = _features(300, 4, seed=21)
    jpc, tpc = _both(ref, np.float32(1.3), kind, nu, 40)
    assert tpc.L.shape == (300, 40) and tpc.L.T.is_contiguous() and not tpc.L.is_contiguous()
    np.testing.assert_array_equal(tpc.pivots.numpy(), np.asarray(jpc.pivots))
    np.testing.assert_allclose(tpc.L.numpy(), np.asarray(jpc.L), rtol=1e-4, atol=2e-5)


def test_constant_diagonal_takes_row_zero_first():
    """The initial diagonal is constant: every row ties, and the first pivot is row 0 in both packages."""
    ref = _features(120, 3, seed=22)
    jpc, tpc = _both(ref, np.float32(0.7), "matern", 1.5, 10)
    assert int(tpc.pivots[0]) == 0 == int(jpc.pivots[0])
    np.testing.assert_array_equal(tpc.pivots.numpy(), np.asarray(jpc.pivots))
    np.testing.assert_allclose(tpc.L.numpy(), np.asarray(jpc.L), rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("kind,nu", [("rbf", 0.0), ("matern", 1.5)])
def test_duplicated_rows_tie_and_exhaust_the_rank(kind, nu):
    """12 distinct points, each four times: later pivots tie exactly between copies, and past the numerical
    rank every column is zero (the relative threshold), as test_pivot_threshold_zeroes_exhausted_columns."""
    ref = np.repeat(_features(12, 3, seed=23), 4, axis=0)
    jpc, tpc = _both(ref, np.float32(1.0), kind, nu, 20)
    jL = np.asarray(jpc.L)
    alive = np.abs(jL).max(axis=0) > 0
    # A live pivot is the first copy of its point: its copies tie with it exactly, and the lowest index wins.
    assert alive[:12].all() and (np.asarray(jpc.pivots)[alive] % 4 == 0).all()
    np.testing.assert_array_equal(tpc.pivots.numpy()[alive], np.asarray(jpc.pivots)[alive])
    # Past the rank the pivots are argmaxes of roundoff-level residuals, which the two packages' sums
    # order differently; their columns are zero in both.
    assert np.abs(jL[:, 16:]).max() == 0 and float(tpc.L[:, 16:].abs().max()) == 0
    np.testing.assert_allclose(tpc.L.numpy(), jL, rtol=1e-4, atol=2e-5)


def test_fused_argmax_takes_the_lowest_index_on_ties():
    """pivot_column_plain's next_piv: the argmax of the new diagonal, the lowest index among equal maxima."""
    n, k = 9, 3
    ref = torch.zeros((n, 2))
    ref[:, 0] = torch.tensor([0.0, 5.0, 5.0, 9.0, 9.0, 5.0, 0.0, 9.0, 5.0])
    L = torch.zeros((k, n)).T
    pivots = torch.zeros(k, dtype=torch.int64)
    diag, s = torch.ones(n), torch.tensor(1.0)
    nxt = torch.zeros((), dtype=torch.int64)
    new = KP.pivot_column_plain(ref, L, diag, torch.tensor(0), 0, s, diag.max(), 0.0, pivots, next_piv=nxt)
    # Row 0's copy (row 6) is exhausted; rows 1, 2, 3, ... tie at 1 - exp(-50)^2 = 1: the lowest is row 1.
    assert int(nxt) == int(torch.argmax(new)) == 1
    new = KP.pivot_column_plain(ref, L, new, nxt.clone(), 1, s, diag.max(), 0.0, pivots, next_piv=nxt)
    assert int(nxt) == 3 and pivots.tolist()[:2] == [0, 1]


def test_factor_plain_is_the_loop_of_steps_in_either_layout():
    """pivot_factor_plain = the per-pivot loop of pivot_column_plain with torch.argmax, row-major or not."""
    ref = torch.from_numpy(_features(200, 5, seed=24))
    s = torch.tensor(1.1)
    L, pivots = KP.pivot_factor_plain(KP.column_major(ref), s * torch.ones(200), s, 1.5, 25)
    Lr, pr = torch.zeros((200, 25)), torch.zeros(25, dtype=torch.int64)
    d = s * torch.ones(200)
    d0 = d.max()
    for j in range(25):
        d = KP.pivot_column_plain(ref, Lr, d, torch.argmax(d), j, s, d0, 1.5, pr)
    assert torch.equal(pivots, pr) and torch.equal(L, Lr)


def test_column_major_L_through_the_preconditioner_and_woodbury():
    """PivotedCholesky.L as a non-contiguous view gives what its contiguous copy gives."""
    ref = _features(250, 3, seed=25)
    _, tpc = _both(ref, np.float32(1.2), "matern", 1.5, 30)
    Lc = tpc.L.contiguous()
    noise = torch.tensor(0.05)
    V = torch.from_numpy(np.random.default_rng(26).normal(size=(250, 3)).astype(np.float32))
    Pv, Pc = t_pc.make_preconditioner(tpc.L, noise, 250), t_pc.make_preconditioner(Lc, noise, 250)
    assert Pv.U.is_contiguous()
    assert all(torch.equal(a, b) for a, b in zip(Pv, Pc))
    assert torch.equal(t_pc.precond_solve(Pv, V), t_pc.precond_solve(Pc, V))
    assert torch.equal(t_pc.woodbury_solve(tpc.L, noise, V), t_pc.woodbury_solve(Lc, noise, V))
    assert torch.equal(t_pc.woodbury_logdet(tpc.L, noise, 250), t_pc.woodbury_logdet(Lc, noise, 250))


def _axis_loop(table, plan, taps):
    d = plan.gather.shape[0]
    for j in range(d + 1):
        table = KC.chain_axis_plain(table, plan.tapw[j], plan.gather[j] if j < d else None, taps)
    return table


@pytest.mark.parametrize("c", [1, 11, 17])
@pytest.mark.parametrize("d,order", [(3, 1), (5, 2)])
def test_fused_axes_equal_the_axis_loop_on_synthetic_plans(d, order, c):
    plan = synthetic_chain_plan(RUN_LENGTHS, 500, seed=c + 10 * d, axes=(d, order))
    taps = [float(t) for t in np.linspace(0.2, 1.0, order + 1)] + [float(t) for t in np.linspace(0.9, 0.1, order)]
    live = int(plan.n_lattice)
    table = torch.from_numpy(np.random.default_rng(c).normal(size=(plan.cnt.shape[0], c)).astype(np.float32))
    fused = KC.chain_axes_plain(table, plan, taps)
    assert torch.equal(fused[:live], _axis_loop(table, plan, taps)[:live])
    assert torch.equal(fused[live:], table[live:])  # rows past the live count are left as they were


@pytest.mark.parametrize("capacity", [None, "trim", "over"])
def test_fused_axes_equal_the_axis_loop_on_built_plans(capacity):
    dk = t_kernels.matern_kernel(1.5, 1)
    x = torch.from_numpy(chain_class_positions())
    occ = int(t_lattice.build_plan_chain(x, dk.coeffs, dk.variance).n_lattice)
    cap = {None: None, "trim": occ, "over": occ - 1}[capacity]
    plan = t_lattice.build_plan_chain(x, dk.coeffs, dk.variance, cap)
    taps = [float(t) for t in dk.coeffs]
    live = min(int(plan.n_lattice), plan.cnt.shape[0])
    for c in (1, 11, 17):
        v = torch.from_numpy(np.random.default_rng(c).normal(size=(x.shape[0], c)).astype(np.float32))
        table = KC.chain_splat_plain(plan, v)
        assert torch.equal(KC.chain_axes_plain(table, plan, taps)[:live], _axis_loop(table, plan, taps)[:live])
        out = KC.chain_apply_plain(plan, v, taps, t_lattice.SLICE_NORM(2))
        assert bool(torch.isnan(out).all()) == (capacity == "over")
