"""The Gaussian-mixture lattice kernel (K12) against the JAX package, on the CPU.

Ports of tests/test_mixture.py's first three tests on the port alone, and
the port against JAX on the same numpy inputs (n 256-512, d 5-9, J 6-8).
The NNLS fit is discontinuous in its inputs (a rounding-level change can
flip its active set), so every parity test of the operator, the NLML, the
gradients and serving feeds both packages the same weights; the port's own
fit is compared through the operator it gives.  Tolerances, each with its
reason:
  * the host constants (alphas, profile-fit weights, taps): bit-equal, the
    same numpy and scipy calls;
  * the plain K12 forward and transpose against JAX's mixture filter:
    JAX filters each component with its sort-chain engine, the port with
    the join operator, so the chain-vs-join bound, rel 2e-5
    (test_chain_plan.py; measured <= 6e-7);
  * the position and value gradients of <g, K_mix(ref) V> against
    jax.grad of JAX's lattice_filter_any: rel 1e-3, well inside the 2e-2
    the NLML gradients are held to (measured <= 2e-6); central differences
    of single points moved within their simplices, rel 1e-3 (f32 rounding of
    the sum; measured 7e-5);
  * the NLML and raw gradients of a mixture SimplexGP against JAX's on the
    same probes and weights: value 1e-5 and gradients rel 2e-3, the bounds
    of the single-kernel tests (test_torch_mll.py), well inside 1e-3 / 2e-2;
  * the subset fit against JAX's, through the fitted operator on a probe:
    rel 1e-3 (two least-squares fits of one target whose columns differ by
    rel 2e-5);
  * serving against JAX's with JAX's omega: posterior mean atol 1e-3 and
    variance rel 1e-3 (two CG solves of the same system to tol 1e-2 whose
    operators differ by rel 2e-5; measured 3e-6 / 2e-6).
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
from simplex_gp_torch.kernels import lattice as K
from simplex_gp_torch.kernels import mixture as KM
from simplex_gp_torch.ops import filter as t_filter
from simplex_gp_torch.ops import kernels as t_kernels
from simplex_gp_torch.ops import lattice as t_lattice
from simplex_gp_tpu.linalg import mll as j_mll
from simplex_gp_tpu.ops import filter as j_filter
from simplex_gp_tpu.ops import kernels as j_kernels


def _data(n=512, d=9, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return x, v, rng


def _probes(n, p, seed=42):
    return torch.from_numpy(np.random.default_rng(seed).choice([-1.0, 1.0], size=(n, p)).astype(np.float32))


def _rel_err_scaled(approx, exact):
    sc = (approx * exact).sum() / (approx * approx).sum()
    return float(np.linalg.norm(sc * approx - exact) / np.linalg.norm(exact))


def _kernels(weights, nu=1.5, order=1):
    """The JAX and the port's MixtureKernel with the same ``weights``."""
    J_ = len(weights)
    jm = dataclasses.replace(j_kernels.mixture_kernel(nu, order, J_), weights=tuple(weights))
    tm = dataclasses.replace(t_kernels.mixture_kernel(nu, order, J_), weights=tuple(weights))
    return jm, tm


_WEIGHTS6 = (0.05, 0.2, 0.9, 1.1, 0.3, 0.0)  # subset-fit weights sum above 1 and may be 0


# ---- ports of tests/test_mixture.py -----------------------------------------------


def test_mixture_beats_matern_taps():
    """Subset-fit mixture MVM error < the Matern tap filter's (d = 9), on the port alone."""
    x, v, _ = _data()
    dk = t_kernels.matern_kernel(1.5, 1)
    xt, vt = torch.from_numpy(x), torch.from_numpy(v)
    d2 = ((xt[:, None, :] - xt[None, :, :]) ** 2).sum(-1)
    exact = (t_kernels.kernel_value(dk, d2) @ vt).numpy()
    with torch.no_grad():
        out_taps = t_filter.lattice_filter_any(vt, xt, dk).numpy()
        mk = t_kernels.fit_mixture_weights_subset(t_kernels.mixture_kernel(1.5, 1), x, m=512)
        out_mix = t_filter.lattice_filter_any(vt, xt, mk).numpy()
    e_taps, e_mix = _rel_err_scaled(out_taps, exact), _rel_err_scaled(out_mix, exact)
    assert e_mix < 0.8 * e_taps, (e_mix, e_taps)
    assert all(w >= 0 for w in mk.weights)  # PSD by construction


def test_mixture_value_is_target_matern():
    """kernel_value(mixture) is the target Matern, as JAX's kernel_value_jnp gives it."""
    mk = t_kernels.mixture_kernel(1.5, 1)
    d2 = np.linspace(0.0, 9.0, 32, dtype=np.float32)
    got = t_kernels.kernel_value(mk, torch.from_numpy(d2)).numpy()
    np.testing.assert_allclose(got, t_kernels.kernel_value(t_kernels.matern_kernel(1.5, 1),
                                                           torch.from_numpy(d2)).numpy(), rtol=1e-6)
    np.testing.assert_allclose(got, np.asarray(j_kernels.kernel_value_jnp(j_kernels.mixture_kernel(1.5, 1),
                                                                          jnp.asarray(d2))), rtol=1e-6)
    assert mk.nu == 1.5  # build_precond's columns (dk.nu): Matern-1.5, never rbf (nu 0)


def test_mixture_model_trains_and_predicts():
    """MixtureLattice end to end: finite NLML and gradients, one step lowers the loss, finite predictions."""
    x, _, rng = _data(n=256, d=5)
    y = torch.from_numpy((np.tanh(x[:, 0]) + 0.1 * rng.normal(size=x.shape[0])).astype(np.float32))
    xt = torch.from_numpy(x)
    model = T.MixtureLattice(5, components=6).with_fitted_mixture(xt, m=256)
    assert model.kernel == "mixture" and len(model.mix_weights) == 6
    probes = _probes(256, model.bbmm.num_probes)
    loss = model.nlml(xt, y, probes=probes)
    loss.backward()
    assert np.isfinite(float(loss.detach()))
    for p in model.parameters():
        assert torch.isfinite(p.grad).all()
    with torch.no_grad():
        for p in model.parameters():
            p -= 0.1 * p.grad
    assert float(model.nlml(xt, y, probes=probes).detach()) < float(loss.detach())
    mu, var = model.predict_from_cache(model.posterior_cache(xt, y, torch.Generator().manual_seed(0)), xt, xt[:16])
    assert torch.isfinite(mu).all() and (var > 0).all()


# ---- host constants ------------------------------------------------------------------


@pytest.mark.parametrize("nu,order,components", [(1.5, 1, 8), (2.5, 2, 6), (1.5, 1, 4)])
def test_mixture_constants_equal_jax(nu, order, components):
    jm, tm = j_kernels.mixture_kernel(nu, order, components), t_kernels.mixture_kernel(nu, order, components)
    assert tm.name == jm.name and tm.order == jm.order and tm.nu == jm.nu
    assert tm.alphas == jm.alphas and tm.weights == jm.weights  # bit-equal floats
    assert tm.coeffs == jm.coeffs and tm.variance == jm.variance
    assert tm.base.coeffs == jm.base.coeffs and tm.base.deriv_coeffs == jm.base.deriv_coeffs


# ---- K12: the stacked apply -------------------------------------------------------------


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("n,d,c", [(384, 7, 1), (300, 5, 3)])
def test_plain_k12_matches_jax(n, d, c, transpose):
    """K12 (plain) through build_wide_plan_any / apply_plan_any (the stacked join route, which the one-shot
    exact filter, the rect predict and the range sketch below _JOIN_MAX_ROWS take) against JAX's
    per-component chain applies (build_plan_any / apply_plan_any)."""
    x, _, rng = _data(n, d, seed=n)
    v = rng.normal(size=(n, c)).astype(np.float32)
    jm, tm = _kernels(_WEIGHTS6)
    jplan = j_filter.build_plan_any(jnp.asarray(x), jm)
    plan = t_filter.build_wide_plan_any(torch.from_numpy(x), tm)
    assert isinstance(plan, t_lattice.MixturePlan) and plan.seg_ids.shape == (6, n, d + 1)
    got = t_filter.apply_plan_any(plan, torch.from_numpy(v), tm, transpose=transpose).numpy()
    if transpose:  # K^T v is the gradient of <v, K u> in u
        _, vjp = jax.vjp(lambda u: j_filter.apply_plan_any(jplan, u, jm), jnp.zeros((n, c), jnp.float32))
        want = np.asarray(vjp(jnp.asarray(v))[0])
    else:
        want = np.asarray(j_filter.apply_plan_any(jplan, jnp.asarray(v), jm))
        one_shot = np.asarray(j_filter.lattice_filter_any(jnp.asarray(v), jnp.asarray(x), jm))
        assert rel_err(got, one_shot) <= 2e-5
    assert rel_err(got, want) <= 2e-5


def test_stacked_table_is_the_component_tables():
    """The stacked layout: component j's rows of K12's table are K3's table on component j's own plan."""
    x, _, rng = _data(256, 6, seed=3)
    v = torch.from_numpy(rng.normal(size=(256, 2)).astype(np.float32))
    _, tm = _kernels(_WEIGHTS6)
    plan = t_filter.build_wide_plan_any(torch.from_numpy(x), tm)
    M = plan.neighbors.shape[1] // 6
    for transpose in (False, True):
        out, table = t_lattice.apply_plan_mixture(plan, v, tm.coeffs, tm.weights, transpose, return_table=True)
        total = 0.0
        for j, w in enumerate(tm.weights):
            comp = t_lattice.mixture_component(plan, j)
            assert int(comp.n_lattice) == int(plan.live[j]) <= M
            o_j, t_j = t_lattice.apply_plan_join(comp, v, tm.coeffs, transpose, return_table=True)
            live = int(plan.live[j])
            torch.testing.assert_close(table[j * M:j * M + live], t_j[:live], rtol=1e-6, atol=1e-6)
            total = total + w * o_j
        torch.testing.assert_close(out, total, rtol=1e-5, atol=1e-6)
    # Live counts differ from component to component (alpha scales the occupancy).
    assert len(set(plan.live.tolist())) > 1


def test_cpu_tensor_takes_the_plain_route():
    """The wrapper counts only kernel launches; a CPU tensor runs the plain version."""
    x, v, _ = _data(128, 4)
    _, tm = _kernels(_WEIGHTS6)
    plan = t_filter.build_wide_plan_any(torch.from_numpy(x), tm)
    before = KM.lattice_mixture_apply.launches
    out = t_filter.apply_plan_any(plan, torch.from_numpy(v), tm)
    want = KM.mixture_apply_plain(plan.seg_ids, plan.weights, plan.neighbors, torch.from_numpy(v),
                                  list(tm.coeffs), t_lattice.SLICE_NORM(4), tm.weights)
    assert KM.lattice_mixture_apply.launches == before
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_mixture_plan_ignores_capacity():
    """Mixture plans are untrimmed whatever the capacity (filter.py:174-176): the CG's J chain plans
    (build_plan_any) and the stacked join plan (build_wide_plan_any)."""
    x, _, _ = _data(200, 5)
    _, tm = _kernels(_WEIGHTS6)
    for build in (t_filter.build_plan_any, t_filter.build_wide_plan_any):
        a = build(torch.from_numpy(x), tm)
        b = build(torch.from_numpy(x), tm, capacity=7)
        flat_a, flat_b = t_filter._plan_tensors(a), t_filter._plan_tensors(b)
        assert len(flat_a) == len(flat_b)
        for s, t in zip(flat_a, flat_b):
            torch.testing.assert_close(s, t, rtol=0, atol=0)
    assert all(p.cnt.shape == (200 * 6,) for p in t_filter.build_plan_any(torch.from_numpy(x), tm, capacity=7))


# ---- gradients ------------------------------------------------------------------------


@pytest.mark.parametrize("n,d,c", [(384, 7, 2), (256, 5, 4)])
def test_mixture_gradients_match_jax_grad(n, d, c):
    """grad of <g, K_mix(ref) V> in ref and V: transposed K12 and K5 on the stacked problem vs jax.grad."""
    x, _, rng = _data(n, d, seed=7)
    v = rng.normal(size=(n, c)).astype(np.float32)
    g = rng.normal(size=(n, c)).astype(np.float32)
    jm, tm = _kernels((0.3, 0.0, 0.7, 1.4, 0.9, 0.2, 0.05))
    jx, jv = jax.grad(lambda xx, vv: (j_filter.lattice_filter_any(vv, xx, jm) * g).sum(), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(v))
    xt = torch.from_numpy(x).requires_grad_(True)
    vt = torch.from_numpy(v).requires_grad_(True)
    (t_filter.lattice_filter_any(vt, xt, tm) * torch.from_numpy(g)).sum().backward()
    assert rel_err(xt.grad, jx) <= 1e-3
    assert rel_err(vt.grad, jv) <= 1e-3


def test_mixture_position_gradient_matches_finite_differences():
    """Entries of grad_ref against central differences that move one point within its simplices.

    The operator is discontinuous where a point enters another simplex: a
    newly occupied lattice point relays mass in the later axis blurs.  Moved
    by +-eps without changing any component's vertex keys, a point changes
    only its own barycentric weights, in which <g, K v> is quadratic, so the
    central difference is exact up to f32 rounding (measured rel 7e-5).
    """
    n, d, eps = 300, 5, 1e-2
    x, _, rng = _data(n, d, seed=9)
    v = torch.from_numpy(rng.normal(size=(n, 2)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(n, 2)).astype(np.float32))
    _, tm = _kernels(_WEIGHTS6)
    xt = torch.from_numpy(x).requires_grad_(True)
    (g * t_filter.lattice_filter_any(v, xt, tm)).sum().backward()
    E, a, _, _ = t_lattice._lattice_constants(d, tm.base.coeffs, tm.base.variance, "cpu")

    def f(xx):
        with torch.no_grad():
            return float((g.double() * t_filter.lattice_filter_any(v, xx, tm).double()).sum())

    def keys(pt):
        return torch.cat([torch.cat(K.geometry_plain(pt[None] * al, E, a)[:2]) for al in tm.alphas])

    got, fd = [], []
    for p in range(0, n, 30):
        for k in range(d):
            xp, xm = torch.from_numpy(x.copy()), torch.from_numpy(x.copy())
            xp[p, k] += eps
            xm[p, k] -= eps
            if torch.equal(keys(xp[p]), keys(xm[p])):
                got.append(float(xt.grad[p, k]))
                fd.append((f(xp) - f(xm)) / (2 * eps))
    assert len(got) >= 20
    assert rel_err(got, fd) <= 1e-3


def test_wide_mixture_above_join_max_rows_goes_through_k9_per_component(monkeypatch):
    """Above _JOIN_MAX_ROWS a wide block takes one untrimmed chunked chain per component (make_wide_filter_any,
    filter.py:207-220), the same operator as K12's below it: no K9 and no K12 there, and the exact gradient
    through the components' chunked chains."""
    x, _, rng = _data(200, 5, seed=5)
    V = torch.from_numpy(rng.normal(size=(200, 20)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(200, 20)).astype(np.float32))
    _, tm = _kernels(_WEIGHTS6)
    xt = torch.from_numpy(x)
    plan = t_filter.build_wide_plan_any(xt, tm)
    want = t_filter.apply_plan_wide(plan, V, tm)  # K12
    xa = xt.clone().requires_grad_(True)
    (g * t_filter.lattice_filter_exact_grad(V, xa, tm)).sum().backward()
    calls = []
    for name in ("apply_plan_cols", "apply_plan_mixture", "build_plan_mixture"):
        real = getattr(t_filter, name)
        monkeypatch.setattr(t_filter, name, lambda *a, _real=real, _n=name, **k: calls.append(_n) or _real(*a, **k))
    launches = K.lattice_apply_cols.launches, KM.lattice_mixture_apply.launches
    monkeypatch.setattr(t_filter, "_JOIN_MAX_ROWS", 1000)  # 200 x 6 rows: above it
    torch.testing.assert_close(t_filter.make_wide_filter(xt, tm)(V), want, rtol=1e-5, atol=1e-5)
    xb = xt.clone().requires_grad_(True)
    (g * t_filter.lattice_filter_exact_grad(V, xb, tm)).sum().backward()
    torch.testing.assert_close(xb.grad, xa.grad, rtol=1e-4, atol=1e-5)
    assert calls == []
    assert launches == (K.lattice_apply_cols.launches, KM.lattice_mixture_apply.launches)  # CPU: plain, no launch


# ---- the engine and the model against JAX ----------------------------------------------------


def _problem(n=300, d=5, seed=11):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (np.sin(2 * x[:, 0]) + 0.5 * x[:, 1] + 0.2 * rng.normal(size=n)).astype(np.float32)
    raw = {"raw_lengthscale": np.log(np.expm1(np.linspace(0.8, 2.0, d).astype(np.float32))),
           "raw_outputscale": np.float32(0.3), "raw_noise": np.float32(-1.5), "mean": np.float32(0.1)}
    return x, y, raw


@pytest.mark.parametrize("grad_mode", ["exact", "deriv_filter"])
def test_mixture_nlml_and_raw_grads_match_jax(grad_mode):
    """A mixture SimplexGP's NLML and raw gradients against JAX's, same weights and probes.

    Mixtures ignore grad_mode (JAX mll.py:107-110): "deriv_filter" runs the exact gradient in both.
    """
    x, y, raw = _problem()
    kw = dict(num_dims=5, kernel="mixture", nu=1.5, order=1, min_noise=0.1, mix_components=8)
    bbmm = dict(cg_tolerance=1.0, max_cg_iterations=500, max_lanczos_iterations=100, precond_rank=100,
                num_probes=10, grad_mode=grad_mode)
    probes = np.random.default_rng(5).choice([-1.0, 1.0], size=(300, 10)).astype(np.float32)
    jm = J.SimplexGP(**kw, bbmm=J.BBMMConfig(**bbmm)).with_fitted_mixture(
        {k: jnp.asarray(v) for k, v in raw.items()}, jnp.asarray(x), m=256)
    j_val, j_grad = jax.value_and_grad(
        lambda r: j_mll.lattice_nlml(jm.dk, jm.bbmm, jm.constrained(r), jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(probes)))({k: jnp.asarray(v) for k, v in raw.items()})
    tm = convert.mixture_model_from_jax(raw, jm.mix_weights, nu=1.5, order=1, min_noise=0.1,
                                        bbmm=T.BBMMConfig(**bbmm))
    assert tm.dk.weights == jm.dk.weights and tm.dk.alphas == jm.dk.alphas
    stats = {}
    loss = tm.nlml(torch.from_numpy(x), torch.from_numpy(y), probes=torch.from_numpy(probes), stats=stats)
    loss.backward()
    assert stats["cg_iters"] >= 10
    assert abs(float(loss.detach()) - float(j_val)) <= 1e-5
    for k in raw:
        assert rel_err(getattr(tm, k).grad, j_grad[k]) <= 2e-3, k


def test_with_fitted_mixture_matches_jax_at_operator_level():
    x, _, raw = _problem(n=400, d=6, seed=2)
    jmodel = J.SimplexGP(num_dims=6, kernel="mixture", mix_components=7).with_fitted_mixture(
        {k: jnp.asarray(v) for k, v in raw.items()}, jnp.asarray(x), m=300)
    tmodel = T.SimplexGP(num_dims=6, kernel="mixture", mix_components=7).load_raw(raw)
    assert tmodel.with_fitted_mixture(torch.from_numpy(x), m=300) is tmodel
    assert all(w >= 0 for w in tmodel.mix_weights)
    with torch.no_grad():
        ref = torch.from_numpy(x) * tmodel.constrained()["inv_ell"]
        probe = torch.from_numpy(np.random.default_rng(1).normal(size=(400, 2)).astype(np.float32))
        _, j_dk = _kernels(jmodel.mix_weights)
        got = t_filter.lattice_filter_any(probe, ref, tmodel.dk)
        want = t_filter.lattice_filter_any(probe, ref, j_dk)
    assert rel_err(got, want) <= 1e-3


def test_mixture_serving_matches_jax():
    """posterior_cache + predict_from_cache with JAX's omega: mean and variance close to JAX's."""
    x, y, raw = _problem(n=256, d=5, seed=6)
    xs = np.random.default_rng(8).normal(size=(40, 5)).astype(np.float32)
    kw = dict(num_dims=5, kernel="mixture", nu=1.5, order=1, min_noise=0.1, mix_components=6,
              mix_weights=_WEIGHTS6, eval_cg_tolerance=1e-2)
    jm = J.SimplexGP(**kw, bbmm=J.BBMMConfig(precond_rank=50))
    key = jax.random.PRNGKey(0)
    jraw = {k: jnp.asarray(v) for k, v in raw.items()}
    cache = jm.posterior_cache(jraw, jnp.asarray(x), jnp.asarray(y), key)
    j_mean, j_var = (np.asarray(a) for a in jm.predict_from_cache(cache, jnp.asarray(x), jnp.asarray(xs)))
    omega = torch.from_numpy(np.array(jax.random.normal(key, (256, 100), jnp.float32)))
    tm = T.SimplexGP(**kw, bbmm=T.BBMMConfig(precond_rank=50)).load_raw(raw)
    t_cache = tm.posterior_cache(torch.from_numpy(x), torch.from_numpy(y), omega=omega)
    t_mean, t_var = tm.predict_from_cache(t_cache, torch.from_numpy(x), torch.from_numpy(xs))
    assert torch.isfinite(t_mean).all() and (t_var > 0).all()
    np.testing.assert_allclose(t_mean.numpy(), j_mean, rtol=0, atol=1e-3)
    assert rel_err(t_var, j_var) <= 1e-3
