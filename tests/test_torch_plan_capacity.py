"""The capacity-bounded training plan and its NaN guard, against the JAX package.

``build_plan_join(capacity)`` + ``apply_plan_join`` (the port's join plan,
plain kernel versions on the CPU) against JAX's ``build_plan(capacity)`` +
``apply_plan`` (the sort chain), on the same numpy inputs: equal up to the
chain-vs-join bound (rel < 2e-5, test_chain_plan.py::test_chain_matches_join)
when the capacity holds the occupancy, all NaN in both at occupancy - 1
(lattice.py:1093-1100).  The NLML with ``plan_capacity`` (its CG on the
port's trimmed chain plan, its backward on a trimmed join plan) equals the
untrimmed NLML (same operator, same probes) when the capacity holds, and
JAX's on an overflow.  The trainer's autotrim equals train_simplexgp.py:53-67.
"""

import argparse
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel_err

from simplex_gp_torch import train
from simplex_gp_torch.kernels import lattice as K
from simplex_gp_torch.linalg import mll as t_mll
from simplex_gp_torch.ops import kernels as t_kernels
from simplex_gp_torch.ops import lattice as t_lattice
from simplex_gp_tpu.linalg import mll as j_mll
from simplex_gp_tpu.linalg.host_loop import host_inv_quad_logdet_grads
from simplex_gp_tpu.models.components import constrain as j_constrain
from simplex_gp_tpu.models.components import init_raw_params as j_init_raw
from simplex_gp_tpu.ops import kernels as j_kernels
from simplex_gp_tpu.ops import lattice as j_lattice


def _dk(kind, order):
    if kind == "rbf":
        return t_kernels.rbf_kernel(order), j_kernels.rbf_kernel(order)
    return t_kernels.matern_kernel(1.5, order), j_kernels.matern_kernel(1.5, order)


@pytest.mark.parametrize("n,d,order,kind,c", [(300, 3, 1, "rbf", 11), (257, 5, 2, "matern", 1),
                                               (200, 9, 1, "matern", 3), (150, 1, 3, "rbf", 2)])
def test_bounded_plan_matches_jax_and_guards(n, d, order, kind, c):
    rng = np.random.default_rng(n + d)
    x = (rng.normal(size=(n, d)) * (1.0 if d < 9 else 0.3)).astype(np.float32)
    v = rng.normal(size=(n, c)).astype(np.float32)
    tdk, jdk = _dk(kind, order)
    occ = int(j_lattice.count_lattice_points(jnp.asarray(x), jdk.variance, jdk.coeffs))
    full = t_lattice.apply_plan_join(t_lattice.build_plan_join(torch.from_numpy(x), tdk.coeffs, tdk.variance),
                                     torch.from_numpy(v), tdk.coeffs).numpy()
    for cap in (occ + 8, occ, occ - 1):
        jplan = j_lattice.build_plan(jnp.asarray(x), jdk.coeffs, jdk.variance, capacity=cap)
        want = np.asarray(j_lattice.apply_plan(jplan, jnp.asarray(v), jdk.coeffs))
        plan = t_lattice.build_plan_join(torch.from_numpy(x), tdk.coeffs, tdk.variance, capacity=cap)
        got = t_lattice.apply_plan_join(plan, torch.from_numpy(v), tdk.coeffs).numpy()
        assert tuple(plan.neighbors.shape) == (d + 1, cap, 2 * order)
        assert int(plan.n_lattice) == int(jplan.n_lattice) == occ
        if cap >= occ:
            assert rel_err(got, want) < 2e-5
            np.testing.assert_array_equal(got, full)
        else:
            assert np.isnan(want).all() and np.isnan(got).all()
            # A tripped plan stays in bounds: every row id and neighbour index fits its table.
            assert int(plan.seg_ids.max()) < cap and int(plan.neighbors.max()) <= cap


def test_capacity_above_the_worst_case_is_the_untrimmed_plan():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(40, 2)).astype(np.float32)
    dk = t_kernels.rbf_kernel(1)
    plan = t_lattice.build_plan_join(torch.from_numpy(x), dk.coeffs, dk.variance, capacity=10**6)
    assert plan.neighbors.shape[1] == 40 * 3
    with pytest.raises(ValueError, match="capacity"):
        t_lattice.build_plan_join(torch.from_numpy(x), dk.coeffs, dk.variance, capacity=0)


def test_tripped_transposed_apply_and_filter_gradient_stay_finite_shaped():
    """On a tripped plan the transposed apply is NaN and K5's plain version keeps its shape."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(120, 3)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(120, 2)).astype(np.float32))
    dk = t_kernels.rbf_kernel(1)
    occ = int(t_lattice.count_lattice_points(x, dk.variance, dk.coeffs))
    plan = t_lattice.build_plan_join(x, dk.coeffs, dk.variance, capacity=occ - 1)
    out, table = t_lattice.apply_plan_join(plan, v, dk.coeffs, transpose=True, return_table=True)
    assert torch.isnan(out).all() and table.shape == (occ - 1, 2)
    E = torch.from_numpy(t_lattice.build_rotation(3, dk.variance))
    grad = K.lattice_filter_grad(x, E, plan.seg_ids, out, v, table, table, t_lattice.SLICE_NORM(3))
    assert grad.shape == (120, 3) and torch.isnan(grad).all()


def _nlml_problem(n=256, d=3, seed=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.2 * rng.normal(size=n)).astype(np.float32)
    z = rng.choice([-1.0, 1.0], size=(n, 4)).astype(np.float32)
    raw = {k: np.asarray(v, np.float32) for k, v in j_init_raw(d, lengthscale=1.3).items()}
    return x, y, z, raw


@pytest.mark.parametrize("grad_mode", ["exact", "deriv_filter"])
def test_nlml_with_plan_capacity_matches_untrimmed_and_jax_on_overflow(grad_mode):
    """At capacity >= occupancy, the untrimmed NLML and gradients.  At occupancy - 1 both packages
    return the same finite NLML, not NaN: every CG residual is NaN, so the best iterate stays the
    zero start.  The gradients are those of JAX's host loop (host_loop.py:222-224, the path of the
    round-5 houseelectric run): in exact mode the backward reuses the tripped plan, so the
    outputscale gradient is NaN and the others zero; in deriv_filter mode K V is untrimmed and every
    gradient zero.  (JAX's fused backward filters untrimmed in both modes.)"""
    x, y, z, raw = _nlml_problem()
    tdk, jdk = _dk("matern", 1)
    jparams = j_constrain({k: jnp.asarray(v) for k, v in raw.items()}, 0.1)
    occ = int(j_lattice.count_lattice_points(jnp.asarray(x * np.asarray(jparams["inv_ell"])), jdk.variance,
                                             jdk.coeffs))

    def torch_nlml(cap):
        cfg = t_mll.BBMMConfig(precond_rank=20, num_probes=4, grad_mode=grad_mode, plan_capacity=cap)
        params = {k: torch.tensor(np.asarray(v)).requires_grad_(True) for k, v in jparams.items()}
        loss = t_mll.lattice_nlml(tdk, cfg, params, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(z))
        loss.backward()
        return float(loss.detach()), {k: p.grad.numpy() for k, p in params.items()}

    def jax_config(cap):
        return j_mll.BBMMConfig(precond_rank=20, num_probes=4, grad_mode=grad_mode, plan_capacity=cap)

    def jax_nlml(cap):
        return float(j_mll.lattice_nlml(jdk, jax_config(cap), jparams, jnp.asarray(x), jnp.asarray(y),
                                        jnp.asarray(z)))

    base, base_grads = torch_nlml(None)
    for cap in (occ + 16, occ):
        value, grads = torch_nlml(cap)
        assert abs(value - base) <= 1e-6 and abs(value - jax_nlml(cap)) <= 1e-4
        for k in grads:
            np.testing.assert_allclose(grads[k], base_grads[k], rtol=1e-5, atol=1e-6, err_msg=k)
    value, grads = torch_nlml(occ - 1)
    assert math.isfinite(value) and abs(value - jax_nlml(occ - 1)) <= 1e-6 and abs(value - base) > 1e-3
    *_, jgrads, _ = host_inv_quad_logdet_grads(jdk, jax_config(occ - 1), jparams, jnp.asarray(x),
                                               jnp.asarray(y) - jparams["mean"], jnp.asarray(z))
    for k in ("inv_ell", "outputscale", "noise"):
        np.testing.assert_array_equal(grads[k], np.asarray(jgrads[k]), err_msg=k)
    assert np.isnan(grads["outputscale"]) == (grad_mode == "exact") and grads["mean"] == 0


@pytest.mark.parametrize("ls_init", ["median", "default"])
def test_autotrim_matches_the_jax_trainer(ls_init):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(3000, 4)).astype(np.float32)
    tdk, jdk = _dk("matern", 1)
    ell = train.median_lengthscale(x) if ls_init == "median" else 0.6931
    # train_simplexgp.py:60-65, verbatim.
    occ = int(j_lattice.count_lattice_points(x / ell, jdk.variance, jdk.coeffs))
    n, d = x.shape
    want = min(-(-int(occ * 1.25) // 8192) * 8192, n * (d + 1))
    args = argparse.Namespace(plan_capacity=-1)
    assert train._plan_capacity(args, torch.from_numpy(x), tdk, ell) == want
    assert train._plan_capacity(argparse.Namespace(plan_capacity=0), torch.from_numpy(x), tdk, ell) is None
    assert train._plan_capacity(argparse.Namespace(plan_capacity=777), torch.from_numpy(x), tdk, ell) == 777
    assert train.trim_capacity(8192 * 4, 10**6, 3) == 8192 * 5 and train.trim_capacity(10**6, 100, 3) == 400
