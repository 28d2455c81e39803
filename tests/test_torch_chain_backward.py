"""Reverse mode through the sort-chain apply (K3'c transposed), held against JAX's autodiff.

The exact backward runs on the CG's own chain plan: the chain apply with its
final-order table, the transposed apply S^T B^T S (the axis-0 splat of the
cotangent, the d+1 axes in reverse order over the inverse transitions, the
slice) and K5 at the plan's ``slice_idx``.  On the CPU the wrappers take their
plain versions.  Tolerances:
  * grad_v and grad_ref against ``jax.vjp`` of the JAX package's
    build_plan_chain / apply_plan_chain: rtol 1e-4 / atol 1e-5 and rtol 1e-3 /
    atol 1e-4, the bounds of JAX's own chain-against-join gradient test
    (test_chain_plan.py:95-115); the port sums each row directly where JAX
    differences a running sum, and elevates by a sequential sum where JAX
    uses a matmul;
  * the adjoint identities <B u, w> = <u, B^T w> and <K u, g> = <u, K^T g>:
    rel 1e-5, float32 roundoff of two summation orders;
  * the maps (the inverse transitions and the composite G) exactly, by their
    definitions;
  * the NLML and raw gradients through the chain backward against JAX's
    ``jax.value_and_grad`` of lattice_nlml: test_torch_mll.py's value 1e-5
    and gradients rel 2e-3, and two backward calls bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from chain_fixtures import chain_class_positions, synthetic_chain_plan
from torch_parity import rel_err, seeded

from simplex_gp_torch.kernels import chain as t_chain
from simplex_gp_torch.linalg import mll as t_mll
from simplex_gp_torch.ops import filter as t_filter
from simplex_gp_torch.ops import kernels as t_kernels
from simplex_gp_torch.ops import lattice as t_lattice
from simplex_gp_tpu.linalg import mll as j_mll
from simplex_gp_tpu.ops import kernels as j_kernels
from simplex_gp_tpu.ops import lattice as j_lattice

# test_chain_plan.py::test_chain_matches_join's grid (:25-35).
GRID = [
    (200, 1, 1, "rbf"),
    (300, 3, 1, "rbf"),
    (257, 5, 2, "rbf"),
    (150, 2, 3, "matern"),
    (400, 9, 1, "matern"),
    (64, 17, 1, "rbf"),
]


def _kernels(kind, order):
    if kind == "rbf":
        return t_kernels.rbf_kernel(order), j_kernels.rbf_kernel(order)
    return t_kernels.matern_kernel(1.5, order), j_kernels.matern_kernel(1.5, order)


def _port_vjp(x, v, g, dk, capacity=None):
    """(out, grad_v, grad_ref) of <g, K(x) v> through the chain plan, as the NLML's exact backward runs it."""
    ref = torch.from_numpy(x)
    plan = t_lattice.build_plan_chain(ref, dk.coeffs, dk.variance, capacity)
    out, table_f = t_filter.apply_plan_any(plan, torch.from_numpy(v), dk, return_table=True)
    grad_v, grad_ref = t_filter.filter_backward(plan, ref, dk, torch.from_numpy(v), torch.from_numpy(g), table_f)
    return plan, out.numpy(), grad_v.numpy(), grad_ref.numpy()


@pytest.mark.parametrize("c", [1, 11])
@pytest.mark.parametrize("n,d,order,kind", GRID)
def test_chain_vjp_matches_jax_vjp(n, d, order, kind, c):
    """grad_v = slice_norm S^T B^T S g and grad_ref from K5 against jax.vjp of apply_plan_chain (in v) and of
    build_plan_chain + apply_plan_chain (in x), cotangent g."""
    x, v = seeded(n, d, c)
    g = np.random.default_rng(7).normal(size=(n, c)).astype(np.float32)
    tdk, jdk = _kernels(kind, order)
    plan, out, grad_v, grad_ref = _port_vjp(x, v, g, tdk)

    def jax_filter(xx, vv):
        return j_lattice.apply_plan_chain(j_lattice.build_plan_chain(xx, jdk.coeffs, jdk.variance), vv, jdk.coeffs)

    jout, pullback = jax.vjp(jax_filter, jnp.asarray(x), jnp.asarray(v))
    jgx, jgv = pullback(jnp.asarray(g))
    assert rel_err(out, np.asarray(jout)) < 2e-5
    np.testing.assert_allclose(grad_v, np.asarray(jgv), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(grad_ref, np.asarray(jgx), rtol=1e-3, atol=1e-4)


def _live_plan(kind: str, capacity=None):
    """A built plan on positions with runs of every class (or a synthetic one with taps), and its live rows."""
    if kind == "synthetic":
        plan = synthetic_chain_plan([1, 2, 5, 40, 700], 300, seed=3, axes=(4, 2))
    else:
        dk = t_kernels.matern_kernel(1.5, 1)
        plan = t_lattice.build_plan_chain(torch.from_numpy(chain_class_positions()), dk.coeffs, dk.variance,
                                          capacity)
    return plan, min(int(plan.n_lattice), plan.cnt.shape[0])


def _capacity(spec):
    dk = t_kernels.matern_kernel(1.5, 1)
    occ = int(t_lattice.count_lattice_points(torch.from_numpy(chain_class_positions()), dk.variance, dk.coeffs))
    return {None: None, "trim": occ + 3, "over": occ - 5}[spec]


@pytest.mark.parametrize("case", ["synthetic", None, "trim", "over"])
def test_chain_maps_match_their_definition(case):
    """Each transition is a permutation of the live rows and the identity past them; tmap's row d-1-j is its
    inverse and row d the composite G = gather[0][gather[1][... gather[d-1][q]]], on synthetic and built
    plans (untrimmed, trimmed, overflowing)."""
    plan, live = _live_plan("synthetic") if case == "synthetic" else _live_plan("built", _capacity(case))
    d, Mc = plan.gather.shape
    tmap = t_chain.chain_maps(plan)
    assert tmap.dtype == torch.int32 and tuple(tmap.shape) == (d + 1, Mc)
    q = torch.arange(Mc)
    for j in range(d):
        gj = plan.gather[j].long()
        assert torch.equal(torch.sort(gj[:live]).values, q[:live]) and torch.equal(gj[live:], q[live:])
        assert torch.equal(tmap[d - 1 - j].long()[gj], q)
    G = q.clone()
    for j in range(d - 1, -1, -1):
        G = plan.gather[j].long()[G]
    assert torch.equal(tmap[d].long(), G)


@pytest.mark.parametrize("c", [1, 11])
@pytest.mark.parametrize("case", ["synthetic", None, "trim", "over"])
def test_transposed_axes_are_the_adjoint(case, c):
    """<B u, w> = <u, B^T w> over the live rows at rel 1e-5: B the fused axes (axis-0 order in, final order
    out), B^T w read back from chain_axes_transpose's final-order output through G (its input is the axis-0
    table whose row G[q] holds w[q])."""
    plan, live = _live_plan("synthetic") if case == "synthetic" else _live_plan("built", _capacity(case))
    taps = [0.25, 0.5, 1.0, 0.5, 0.25] if case == "synthetic" else list(t_kernels.matern_kernel(1.5, 1).coeffs)
    d, Mc = plan.gather.shape
    rng = np.random.default_rng(c)
    u, w = (torch.from_numpy(rng.normal(size=(Mc, c)).astype(np.float32)) for _ in range(2))
    G = t_chain.chain_maps(plan)[d].long()
    Bu = t_chain.chain_axes(u.clone(), plan, taps)
    x0 = torch.zeros_like(w)
    x0[G[:live]] = w[:live]
    y = t_chain.chain_axes_transpose(x0, plan, taps)
    Btw = torch.zeros_like(w)
    Btw[G[:live]] = y[:live]
    lhs = float((Bu[:live].double() * w[:live].double()).sum())
    rhs = float((u[:live].double() * Btw[:live].double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)
    # B^T is not B: the axis blurs do not commute (test_chain_plan.py:58-60)
    x_f = torch.zeros_like(u)
    x_f[G[:live]] = u[:live]
    assert rel_err(t_chain.chain_axes_transpose(x_f, plan, taps)[:live].numpy(), Bu[:live].numpy()) > 1e-4


@pytest.mark.parametrize("capacity", [None, "trim"])
def test_transposed_apply_is_the_adjoint_with_its_tables(capacity):
    """<K u, g> = <u, K^T g> at rel 1e-5 (K^T through the transposed chain apply, K not symmetric); each
    returned table is the final-order table its slice read, bit for bit; K3'c transposed alone on the axis-0
    splat gives the transposed apply's table."""
    plan, _ = _live_plan("built", _capacity(capacity))
    dk = t_kernels.matern_kernel(1.5, 1)
    n, c = plan.weights.shape[0], 3
    rng = np.random.default_rng(5)
    u, g = (torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32)) for _ in range(2))
    taps, norm = [float(t) for t in dk.coeffs], t_lattice.SLICE_NORM(plan.weights.shape[1] - 1)
    Ku, table_f = t_chain.chain_apply(plan, u, taps, norm, return_table=True)
    KTg, table_b = t_chain.chain_apply(plan, g, taps, norm, transpose=True, return_table=True)
    Kg = t_chain.chain_apply(plan, g, taps, norm)
    lhs, rhs = float((Ku.double() * g.double()).sum()), float((u.double() * KTg.double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)
    assert rel_err(KTg.numpy(), Kg.numpy()) > 1e-4
    assert torch.equal(Ku, t_chain.chain_slice(table_f, plan, norm))
    assert torch.equal(KTg, t_chain.chain_slice(table_b, plan, norm))
    assert torch.equal(table_b, t_chain.chain_axes_transpose(t_chain.chain_splat(plan, g), plan, taps))


def test_overflowing_plan_gives_nan_through_the_transpose():
    """One row short of the occupancy: the transposed apply is all NaN (K3'd's guard), as the forward; its
    table and K5's gradient stay finite, so a zero cotangent leaves a zero position gradient (the tripped
    NLML's gradients: test_torch_plan_capacity.py)."""
    x = chain_class_positions()
    dk = t_kernels.matern_kernel(1.5, 1)
    v = np.random.default_rng(2).normal(size=(x.shape[0], 2)).astype(np.float32)
    plan, out, grad_v, grad_ref = _port_vjp(x, v, np.ones_like(v), dk, _capacity("over"))
    assert int(plan.n_lattice) > plan.cnt.shape[0]
    assert np.isnan(out).all() and np.isnan(grad_v).all() and np.isfinite(grad_ref).all()
    *_, zero_ref = _port_vjp(x, v, np.zeros_like(v), dk, _capacity("over"))
    assert not np.any(zero_ref)


def _nlml_case(n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, size=(n, d)).astype(np.float32)
    y = (np.sin(2 * x[:, 0]) + 0.5 * np.cos(x[:, -1]) + 0.1 * rng.normal(size=n)).astype(np.float32)
    probes = np.random.default_rng(seed + 1).choice([-1.0, 1.0], size=(n, 6)).astype(np.float32)
    values = {"inv_ell": np.linspace(0.7, 1.6, d).astype(np.float32), "outputscale": np.float32(1.2),
              "noise": np.float32(0.15), "mean": np.float32(-0.1)}
    return x, y, probes, values


@pytest.mark.parametrize("kind,order,d,capacity", [("rbf", 2, 3, None), ("matern", 1, 4, "occupancy")])
def test_nlml_gradient_through_the_chain_backward_matches_jax(monkeypatch, kind, order, d, capacity):
    """The exact backward reuses the CG's chain plan: no join plan is built, one transposed chain apply and one
    forward apply with its table run on the very plan the CG solved with; the NLML and raw gradients within
    test_torch_mll.py's bounds of JAX's, and two backward calls bit for bit."""
    x, y, probes, values = _nlml_case(200, d, 3)
    tdk, jdk = _kernels(kind, order)
    cap = None
    if capacity == "occupancy":
        cap = int(t_lattice.count_lattice_points(torch.from_numpy(x * values["inv_ell"]), tdk.variance, tdk.coeffs))
    kw = dict(cg_tolerance=1.0, max_cg_iterations=300, max_lanczos_iterations=40, num_probes=6, precond_rank=25,
              plan_capacity=cap)
    j_val, j_grad = jax.value_and_grad(
        lambda p: j_mll.lattice_nlml(jdk, j_mll.BBMMConfig(**kw), p, jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(probes)))({k: jnp.asarray(v) for k, v in values.items()})
    calls = {"build_plan": [], "apply_plan_chain": [], "build_wide_plan_join": []}
    for name in calls:
        real = getattr(t_filter, name)

        def spy(*a, _real=real, _name=name, **k):
            out = _real(*a, **k)
            calls[_name].append((a, k, out))
            return out

        monkeypatch.setattr(t_filter, name, spy)
    results = []
    for _ in range(2):
        params = {k: torch.tensor(v, requires_grad=True) for k, v in values.items()}
        loss = t_mll.lattice_nlml(tdk, t_mll.BBMMConfig(**kw), params, torch.from_numpy(x), torch.from_numpy(y),
                                  torch.from_numpy(probes))
        forward_applies = len(calls["apply_plan_chain"])
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        backward = calls["apply_plan_chain"][forward_applies:]
        results.append((float(loss.detach()), grads))
        assert [(a[3:], k) for a, k, _ in backward] == [((False, True), {}), ((True, True), {})]
        cg_plan = calls["build_plan"][-1][2]
        assert all(a[0].slice_idx.data_ptr() == cg_plan.slice_idx.data_ptr() for a, _, _ in backward)
    assert calls["build_wide_plan_join"] == [] and len(calls["build_plan"]) == 2
    assert abs(results[0][0] - float(j_val)) <= 1e-5
    for k in values:
        assert rel_err(results[0][1][k], j_grad[k]) <= 2e-3, k
        assert torch.equal(results[0][1][k], results[1][1][k]), k
