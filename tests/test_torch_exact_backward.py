"""The exact backward on a join plan's row lists: K9's transposed apply and its tables, and the gradients.

The NLML's exact backward and ``LatticeFilterExactGrad`` build the join plan
with its row lists (a ``WidePlan``) and run both of their applies -- V with
its blurred table, then the transposed s U with its table -- through K9 over
one window: K3'b's row-order splat, the live-row blur (in reverse axis
order when transposed) and K3's slice, then K5.  With no atomic splat, two
backward calls give the same bits.  The plain K9 with ``transpose`` /
``return_table`` stays within rel 1e-6 of K3's plain apply in float64 (the
formula it replaces: index_add_ splat, the same blurs, a gather slice) on
untrimmed, trimmed and overflowing plans; the overflow keeps its NaN.  The NLML
gradients keep test_torch_mll.py's bounds against JAX (value 1e-5,
gradients rel 2e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from chain_fixtures import chain_class_positions
from torch_parity import rel_err

from simplex_gp_torch.kernels import lattice as K
from simplex_gp_torch.linalg import mll as t_mll
from simplex_gp_torch.ops import filter as t_filter
from simplex_gp_torch.ops import kernels as t_kernels
from simplex_gp_torch.ops import lattice as t_lattice
from simplex_gp_tpu.linalg import mll as j_mll
from simplex_gp_tpu.ops import filter as j_filter
from simplex_gp_tpu.ops import kernels as j_kernels


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("capacity", [None, "trim", "over"])
@pytest.mark.parametrize("c", [1, 11])
def test_plain_k9_transposed_with_its_table_is_k3s_apply(c, capacity, transpose):
    """apply_cols_plain(transpose, return_table) against apply_plain on runs of every class (up to 3,072
    contributions a row): outputs and the live rows of the table within rel 1e-6 of apply_plain in float64
    (apply_plain's own float32 index_add_ errs by 3.6e-6 on these runs at c = 1, K9's order by 1.5e-7);
    past the capacity the output is all NaN in both."""
    dk = t_kernels.matern_kernel(1.5, 1)
    x = torch.from_numpy(chain_class_positions())
    occ = int(t_lattice.count_lattice_points(x, dk.variance, dk.coeffs))
    cap = {None: None, "trim": occ + 3, "over": occ - 5}[capacity]
    plan = t_lattice.build_plan_join(x, dk.coeffs, dk.variance, cap)
    v = torch.from_numpy(np.random.default_rng(c).normal(size=(x.shape[0], c)).astype(np.float32))
    taps, norm = list(dk.coeffs), t_lattice.SLICE_NORM(x.shape[1])
    out, table = K.apply_cols_plain(*plan, v, taps, norm, c, transpose=transpose, return_table=True)
    want, want_table = K.apply_plain(plan.seg_ids, plan.weights, plan.neighbors, v.double(), taps, norm, transpose,
                                     True, plan.n_lattice)
    assert table.shape == want_table.shape == (plan.neighbors.shape[1], c)
    if capacity == "over":
        assert bool(torch.isnan(out).all() and torch.isnan(want).all())
        return
    live = int(plan.n_lattice)
    assert rel_err(out.numpy(), want.numpy()) < 1e-6
    assert rel_err(table[:live].numpy(), want_table[:live].numpy()) < 1e-6
    same = K.lattice_apply_cols(*plan, v, taps, norm, c, transpose=transpose, return_table=True)
    assert torch.equal(same[0], out) and torch.equal(same[1], table)


def test_return_table_needs_one_window():
    dk = t_kernels.rbf_kernel(1)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(50, 2)).astype(np.float32))
    plan = t_lattice.build_plan_join(x, dk.coeffs, dk.variance)
    with pytest.raises(ValueError, match="one window"):
        K.apply_cols_plain(*plan, torch.ones((50, 9)), list(dk.coeffs), 1.0, 8, return_table=True)


def test_the_transposed_apply_is_the_adjoint():
    """<u, K^T v> = <K u, v> through apply_plan_rows, to f32 roundoff."""
    dk = t_kernels.matern_kernel(1.5, 2)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(400, 4)).astype(np.float32))
    plan = t_lattice.wide_plan(t_lattice.build_plan_join(x, dk.coeffs, dk.variance))
    u, v = (torch.from_numpy(rng.normal(size=(400, 5)).astype(np.float32)) for _ in range(2))
    lhs = (u.double() * t_lattice.apply_plan_rows(plan, v, dk.coeffs, transpose=True).double()).sum()
    rhs = (t_lattice.apply_plan_rows(plan, u, dk.coeffs).double() * v.double()).sum()
    assert abs(float(lhs - rhs)) <= 1e-5 * abs(float(rhs))


def _nlml_case(n=300, d=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, size=(n, d)).astype(np.float32)
    y = (np.sin(3 * x[:, 0]) + 0.1 * rng.normal(size=n)).astype(np.float32)
    probes = np.random.default_rng(42).choice([-1.0, 1.0], size=(n, 8)).astype(np.float32)
    values = {"inv_ell": np.linspace(0.8, 1.5, d).astype(np.float32), "outputscale": np.float32(0.8),
              "noise": np.float32(0.1), "mean": np.float32(0.05)}
    return x, y, probes, values


def _torch_grads(dk, cfg, x, y, probes, values):
    params = {k: torch.tensor(v, requires_grad=True) for k, v in values.items()}
    loss = t_mll.lattice_nlml(dk, cfg, params, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(probes))
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


@pytest.mark.parametrize("capacity", [None, "occupancy"])
def test_nlml_gradients_on_the_row_lists_match_jax_and_repeat(capacity):
    """The exact backward on the join plan's row lists: JAX's value and gradients within test_torch_mll.py's
    bounds, and two backward calls bit for bit."""
    x, y, probes, values = _nlml_case()
    tdk, jdk = t_kernels.matern_kernel(1.5, 1), j_kernels.matern_kernel(1.5, 1)
    cap = None
    if capacity == "occupancy":
        cap = int(t_lattice.count_lattice_points(torch.from_numpy(x * values["inv_ell"]), tdk.variance, tdk.coeffs))
    kw = dict(cg_tolerance=1.0, max_cg_iterations=300, max_lanczos_iterations=40, num_probes=8, precond_rank=30,
              plan_capacity=cap)
    j_val, j_grad = jax.value_and_grad(
        lambda p: j_mll.lattice_nlml(jdk, j_mll.BBMMConfig(**kw), p, jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(probes)))({k: jnp.asarray(v) for k, v in values.items()})
    one = _torch_grads(tdk, t_mll.BBMMConfig(**kw), x, y, probes, values)
    two = _torch_grads(tdk, t_mll.BBMMConfig(**kw), x, y, probes, values)
    assert abs(one[0] - float(j_val)) <= 1e-5
    for k in values:
        assert rel_err(one[1][k], j_grad[k]) <= 2e-3, k
        assert torch.equal(one[1][k], two[1][k]), k


def test_filter_exact_grad_runs_on_the_row_lists_matches_jax_and_repeats(monkeypatch):
    """LatticeFilterExactGrad: its forward keeps K9's table, its backward runs the transposed K9 on the same
    row lists; src and ref gradients against jax.vjp of lattice_filter_exact_grad, and bit-equal twice."""
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(250, 3))).astype(np.float32)
    src = rng.normal(size=(250, 4)).astype(np.float32)
    g = rng.normal(size=(250, 4)).astype(np.float32)
    tdk, jdk = t_kernels.matern_kernel(1.5, 1), j_kernels.matern_kernel(1.5, 1)
    calls = []
    rows_fn = t_filter.apply_plan_rows
    monkeypatch.setattr(t_filter, "apply_plan_rows", lambda *a, **k: calls.append(a[3:]) or rows_fn(*a, **k))

    def grads():
        ts, tx = (torch.from_numpy(a).requires_grad_(True) for a in (src, x))
        out = t_filter.lattice_filter_exact_grad(ts, tx, tdk)
        return out.detach(), torch.autograd.grad(out, [ts, tx], torch.from_numpy(g))

    out, (gs, gx) = grads()
    assert calls == [(False, True), (True, True)]
    _, vjp = jax.vjp(lambda s_, r_: j_filter.lattice_filter_exact_grad(s_, r_, jdk), jnp.asarray(src), jnp.asarray(x))
    js, jx = vjp(jnp.asarray(g))
    assert rel_err(gs.numpy(), np.asarray(js)) <= 1e-4 and rel_err(gx.numpy(), np.asarray(jx)) <= 1e-3
    out2, (gs2, gx2) = grads()
    assert torch.equal(out, out2) and torch.equal(gs, gs2) and torch.equal(gx, gx2)
