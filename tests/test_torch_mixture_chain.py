"""The mixture's CG plan, one sort-chain plan a component, against the JAX package on the CPU.

JAX's one-device mixture builds J untrimmed chain plans at ``ref * alpha_j``
and applies their weighted sum (simplex_gp_tpu/ops/filter.py::build_plan_any
/ apply_plan_any, :186-204); the port's CG and its exact backward run on the
same plans.  Same numpy inputs on both sides, the port's plain kernel
versions.  Tolerances, each with its reason:
  * the forward apply against JAX's, rel 1e-5: the same chain plans and
    operations, float32 sums in another order (measured <= 3e-7);
  * the transposed apply against jax.vjp of JAX's apply, rel 1e-4, the
    bound of test_torch_chain_backward.py (JAX's transpose of its sorts and
    gathers against K3'c transposed);
  * the NLML and raw gradients of a mixture SimplexGP against JAX's on the
    same probes and weights: value 1e-5 and gradients rel 2e-3, the bounds
    of test_torch_mixture.py;
  * the position gradient against central differences of points moved
    within their simplices, rel 1e-3 (test_torch_mixture.py's bound and
    reason).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel_err

import simplex_gp_torch as T
import simplex_gp_tpu as J
from simplex_gp_torch import convert
from simplex_gp_torch.kernels import chain as KC
from simplex_gp_torch.kernels import lattice as K
from simplex_gp_torch.kernels import mixture as KM
from simplex_gp_torch.ops import filter as t_filter
from simplex_gp_torch.ops import kernels as t_kernels
from simplex_gp_torch.ops import lattice as t_lattice
from simplex_gp_tpu.linalg import mll as j_mll
from simplex_gp_tpu.ops import filter as j_filter
from simplex_gp_tpu.ops import kernels as j_kernels

_WEIGHTS = {2: (0.6, 0.9), 8: (0.05, 0.2, 0.9, 1.1, 0.3, 0.0, 0.4, 0.7)}


def _kernels(J_):
    """The JAX and the port's MixtureKernel of J_ components with the same weights."""
    w = _WEIGHTS[J_]
    return (dataclasses.replace(j_kernels.mixture_kernel(1.5, 1, J_), weights=w),
            dataclasses.replace(t_kernels.mixture_kernel(1.5, 1, J_), weights=w))


def _data(n, d, c, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32), rng.normal(size=(n, c)).astype(np.float32),
            rng.normal(size=(n, c)).astype(np.float32))


@pytest.mark.parametrize("J_", [2, 8])
def test_build_plan_any_is_j_untrimmed_chain_plans(J_):
    """A tuple of J ChainPlans, component j's the plan of ref * alpha_j built alone, untrimmed whatever the
    capacity (filter.py:174-176, :186-193)."""
    x, _, _ = _data(240, 5, 1, seed=J_)
    _, tm = _kernels(J_)
    xt = torch.from_numpy(x)
    plans = t_filter.build_plan_any(xt, tm)
    trimmed = t_filter.build_plan_any(xt, tm, capacity=9)
    assert type(plans) is tuple and len(plans) == J_ and len(trimmed) == J_
    for a, plan, other in zip(tm.alphas, plans, trimmed):
        assert isinstance(plan, t_lattice.ChainPlan) and plan.cnt.shape == (240 * 6,)
        alone = t_lattice.build_plan(xt * a, tm.base.coeffs, tm.base.variance)
        for f, u, v, w in zip(t_lattice.ChainPlan._fields, plan, alone, other):
            assert torch.equal(u, v) and torch.equal(u, w), f


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("c", [1, 11])
@pytest.mark.parametrize("J_", [2, 8])
def test_apply_plan_any_matches_jax(J_, c, transpose):
    """sum_j w_j K_j V in component order against JAX's apply_plan_any(build_plan_any(...)), and its
    transpose against jax.vjp of that apply; with return_table, the components' final-order tables."""
    n, d = 300, 6
    x, v, _ = _data(n, d, c, seed=10 * J_ + c)
    jm, tm = _kernels(J_)
    jplan = j_filter.build_plan_any(jnp.asarray(x), jm)
    plans = t_filter.build_plan_any(torch.from_numpy(x), tm)
    got, tables = t_filter.apply_plan_any(plans, torch.from_numpy(v), tm, transpose=transpose, return_table=True)
    assert got.shape == (n, c) and len(tables) == J_
    assert all(t.shape == (n * (d + 1), c) for t in tables)
    assert torch.equal(got, t_filter.apply_plan_any(plans, torch.from_numpy(v), tm, transpose=transpose))
    if transpose:
        _, vjp = jax.vjp(lambda u: j_filter.apply_plan_any(jplan, u, jm), jnp.zeros((n, c), jnp.float32))
        assert rel_err(got.numpy(), np.asarray(vjp(jnp.asarray(v))[0])) <= 1e-4
    else:
        assert rel_err(got.numpy(), np.asarray(j_filter.apply_plan_any(jplan, jnp.asarray(v), jm))) <= 1e-5


@pytest.mark.parametrize("J_", [2, 8])
def test_chain_backward_matches_jax_vjp(J_):
    """filter_backward on the J chain plans (per component the transposed chain apply of w_j g and K5 at its
    slice_idx, the position gradient sum_j w_j alpha_j K5_j) against jax.vjp of JAX's apply_plan_any over
    build_plan_any, in the values and the positions."""
    n, d, c = 256, 5, 3
    x, v, g = _data(n, d, c, seed=J_)
    x = 0.6 * x
    jm, tm = _kernels(J_)
    _, vjp = jax.vjp(lambda s, r: j_filter.apply_plan_any(j_filter.build_plan_any(r, jm), s, jm),
                     jnp.asarray(v), jnp.asarray(x))
    jgv, jgx = vjp(jnp.asarray(g))
    xt, vt = torch.from_numpy(x), torch.from_numpy(v)
    plans = t_filter.build_plan_any(xt, tm)
    _, tables = t_filter.apply_plan_any(plans, vt, tm, return_table=True)
    gv, gx = t_filter.filter_backward(plans, xt, tm, vt, torch.from_numpy(g), tables)
    assert rel_err(gv.numpy(), np.asarray(jgv)) <= 1e-4
    assert rel_err(gx.numpy(), np.asarray(jgx)) <= 1e-3


def test_chain_position_gradient_matches_finite_differences():
    """The chain backward's position gradient against central differences that move one point within its
    simplices (test_torch_mixture.py's test of K12's): a point that keeps every component's vertex keys
    changes only its own barycentric weights, in which <g, K v> is quadratic."""
    n, d, eps = 300, 5, 1e-2
    x, v, g = _data(n, d, 2, seed=9)
    _, tm = _kernels(8)
    vt, gt, xt = torch.from_numpy(v), torch.from_numpy(g), torch.from_numpy(x)
    plans = t_filter.build_plan_any(xt, tm)
    _, tables = t_filter.apply_plan_any(plans, vt, tm, return_table=True)
    _, grad = t_filter.filter_backward(plans, xt, tm, vt, gt, tables)
    E, a, _, _ = t_lattice._lattice_constants(d, tm.base.coeffs, tm.base.variance, "cpu")

    def f(xx):
        return float((gt.double() * t_filter.apply_plan_any(t_filter.build_plan_any(xx, tm), vt, tm).double()).sum())

    def keys(pt):
        return torch.cat([torch.cat(K.geometry_plain(pt[None] * al, E, a)[:2]) for al in tm.alphas])

    got, fd = [], []
    for p in range(0, n, 15):
        for k in range(d):
            xp, xm = xt.clone(), xt.clone()
            xp[p, k] += eps
            xm[p, k] -= eps
            if torch.equal(keys(xp[p]), keys(xm[p])):
                got.append(float(grad[p, k]))
                fd.append((f(xp) - f(xm)) / (2 * eps))
    assert len(got) >= 20
    assert rel_err(got, fd) <= 1e-3


def _problem(n=300, d=5, seed=11):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (np.sin(2 * x[:, 0]) + 0.5 * x[:, 1] + 0.2 * rng.normal(size=n)).astype(np.float32)
    raw = {"raw_lengthscale": np.log(np.expm1(np.linspace(0.8, 2.0, d).astype(np.float32))),
           "raw_outputscale": np.float32(0.3), "raw_noise": np.float32(-1.5), "mean": np.float32(0.1)}
    return x, y, raw


@pytest.mark.parametrize("J_", [2, 8])
def test_chain_nlml_and_raw_grads_match_jax(J_):
    """A mixture SimplexGP's NLML and raw gradients on the J chain plans against JAX's, same weights and
    probes (test_torch_mixture.py::test_mixture_nlml_and_raw_grads_match_jax at J = 2 and 8)."""
    x, y, raw = _problem(seed=20 + J_)
    bbmm = dict(cg_tolerance=1.0, max_cg_iterations=500, max_lanczos_iterations=100, precond_rank=100,
                num_probes=10)
    probes = np.random.default_rng(J_).choice([-1.0, 1.0], size=(300, 10)).astype(np.float32)
    jm = J.SimplexGP(num_dims=5, kernel="mixture", nu=1.5, order=1, min_noise=0.1, mix_components=J_,
                     mix_weights=_WEIGHTS[J_], bbmm=J.BBMMConfig(**bbmm))
    j_val, j_grad = jax.value_and_grad(
        lambda r: j_mll.lattice_nlml(jm.dk, jm.bbmm, jm.constrained(r), jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(probes)))({k: jnp.asarray(v) for k, v in raw.items()})
    tm = convert.mixture_model_from_jax(raw, _WEIGHTS[J_], nu=1.5, order=1, min_noise=0.1,
                                        bbmm=T.BBMMConfig(**bbmm))
    assert tm.dk.weights == jm.dk.weights and tm.dk.alphas == jm.dk.alphas
    stats = {}
    loss = tm.nlml(torch.from_numpy(x), torch.from_numpy(y), probes=torch.from_numpy(probes), stats=stats)
    loss.backward()
    assert stats["cg_iters"] >= 10
    assert abs(float(loss.detach()) - float(j_val)) <= 1e-5
    for k in raw:
        assert rel_err(getattr(tm, k).grad, j_grad[k]) <= 2e-3, k


def test_cg_and_backward_build_j_chain_plans_and_no_mixture_plan(monkeypatch):
    """The NLML's CG applies only the J chain plans it built (no MixturePlan, no K12); its backward builds no
    plan at all and runs, per component, the chain apply with its table and the transposed chain apply with
    its table on the CG's own plan.  posterior_cache's eval CG runs on J chain plans too, and its range
    sketch and the rect predict keep K12's stacked route below _JOIN_MAX_ROWS."""
    calls = {name: [] for name in ("build_plan", "apply_plan_chain", "build_plan_mixture", "apply_plan_mixture",
                                   "build_wide_plan_join")}
    for name in calls:
        real = getattr(t_filter, name)

        def spy(*a, _real=real, _name=name, **k):
            out = _real(*a, **k)
            calls[_name].append((a, k, out))
            return out

        monkeypatch.setattr(t_filter, name, spy)
    x, y, raw = _problem(n=240, seed=3)
    _, tm = _kernels(8)
    model = T.SimplexGP(num_dims=5, kernel="mixture", nu=1.5, order=1, min_noise=0.1, mix_components=8,
                        mix_weights=_WEIGHTS[8], bbmm=T.BBMMConfig(precond_rank=40, num_probes=6)).load_raw(raw)
    launches = KM.lattice_mixture_apply.launches, KC.chain_splat.launches
    probes = torch.from_numpy(np.random.default_rng(2).choice([-1.0, 1.0], size=(240, 6)).astype(np.float32))
    loss = model.nlml(torch.from_numpy(x), torch.from_numpy(y), probes=probes)
    plans = [out for _, _, out in calls["build_plan"]]
    assert len(plans) == 8 and all(isinstance(p, t_lattice.ChainPlan) for p in plans)
    assert len(calls["apply_plan_chain"]) >= 8 * 10
    assert {id(a[0]) for a, _, _ in calls["apply_plan_chain"]} == {id(p) for p in plans}
    forward_applies = len(calls["apply_plan_chain"])
    loss.backward()
    assert len(calls["build_plan"]) == 8
    backward = calls["apply_plan_chain"][forward_applies:]
    assert [a[3:5] for a, _, _ in backward] == [(False, True)] * 8 + [(True, True)] * 8
    ptrs = [p.slice_idx.data_ptr() for p in plans]
    assert [a[0].slice_idx.data_ptr() for a, _, _ in backward] == ptrs + ptrs
    assert not calls["build_plan_mixture"] and not calls["apply_plan_mixture"] and not calls["build_wide_plan_join"]
    for name in calls:
        calls[name].clear()
    with torch.no_grad():
        cache = model.posterior_cache(torch.from_numpy(x), torch.from_numpy(y),
                                      omega=torch.from_numpy(np.random.default_rng(4).normal(
                                          size=(240, 100)).astype(np.float32)))
        model.predict_from_cache(cache, torch.from_numpy(x), torch.from_numpy(x[:30] + 0.1))
    assert len(calls["build_plan"]) == 8 and len(calls["build_plan_mixture"]) == 2  # the sketch's, the predict's
    assert len(calls["apply_plan_mixture"]) == 3  # two sketch MVMs and the rect filter: K12
    assert (KM.lattice_mixture_apply.launches, KC.chain_splat.launches) == launches  # CPU: plain, no launch
