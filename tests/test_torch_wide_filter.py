"""The chunked wide filter (K9) and JAX's wide dispatch, against the JAX package.

Same numpy inputs on both sides; the port on the CPU (plain kernel
versions).  JAX's chunked filter runs the sort-chain plan, the port's the
join plan, so the two agree up to 64-bit hash collisions: the bound of
test_chain_plan.py::test_chain_matches_join, rel < 2e-5 with equal
n_lattice.  The threshold above which a wide block is chunked
(``_JOIN_MAX_ROWS``, 4M contribution rows) is patched low in both packages
to reach the chunked branch at test sizes; the JAX source does not change.
The serving slice uses the tolerances of test_torch_slice.py at eval CG
tolerance 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel_err

import simplex_gp_torch as T
import simplex_gp_tpu as J
from simplex_gp_torch.kernels import lattice as K
from simplex_gp_torch.ops import filter as t_filter
from simplex_gp_torch.ops import kernels as t_kernels
from simplex_gp_torch.ops import lattice as t_lattice
from simplex_gp_tpu.ops import filter as j_filter
from simplex_gp_tpu.ops import kernels as j_kernels
from simplex_gp_tpu.ops import lattice as j_lattice

N, D = 600, 3
LOW = 1000  # rows; below N (D + 1) = 2,400


def _data(c, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(N, D)).astype(np.float32), rng.normal(size=(N, c)).astype(np.float32)


def _occupancy(x, dk):
    return int(j_lattice.count_lattice_points(jnp.asarray(x), dk.variance, dk.coeffs))


@pytest.fixture
def chunks_spy(monkeypatch):
    """Counts the port's calls of the chunked apply (K9's entry point in ops/filter.py)."""
    calls = []
    real = t_filter.apply_plan_cols

    def spy(plan, v, coeffs, chunk):
        calls.append((tuple(v.shape), chunk))
        return real(plan, v, coeffs, chunk)

    monkeypatch.setattr(t_filter, "apply_plan_cols", spy)
    return calls


@pytest.fixture
def plans_spy(monkeypatch):
    """The plans that ops/filter.py hands to K9's windowed apply (apply_plan_cols) and to K3's (apply_plan_join)."""
    calls = {"cols": [], "join": []}
    for name, key in (("apply_plan_cols", "cols"), ("apply_plan_join", "join")):
        real = getattr(t_filter, name)

        def spy(plan, v, *args, _real=real, _key=key, **kwargs):
            calls[_key].append(plan)
            return _real(plan, v, *args, **kwargs)

        monkeypatch.setattr(t_filter, name, spy)
    return calls


@pytest.fixture
def low_threshold(monkeypatch):
    monkeypatch.setattr(t_filter, "_JOIN_MAX_ROWS", LOW)
    monkeypatch.setattr(j_filter, "_JOIN_MAX_ROWS", LOW)


@pytest.mark.parametrize("trim", [None, "occupancy", "short"])
@pytest.mark.parametrize("c", [8, 20, 101])
def test_wide_chunked_matches_jax(c, trim):
    """c = 8: one exact chunk; 20: a padded last chunk; 101: thirteen chunks."""
    x, v = _data(c)
    tdk, jdk = t_kernels.matern_kernel(1.5, 1), j_kernels.matern_kernel(1.5, 1)
    occ = _occupancy(x, jdk)
    cap = {None: None, "occupancy": occ, "short": occ - 1}[trim]
    want = np.asarray(j_filter.lattice_filter_wide_chunked(jnp.asarray(v), jnp.asarray(x), jdk, capacity=cap))
    got = t_filter.lattice_filter_wide_chunked(torch.from_numpy(v), torch.from_numpy(x), tdk, cap).numpy()
    assert got.shape == (N, c)
    if trim == "short":
        assert np.isnan(want).all() and np.isnan(got).all()
    else:
        assert rel_err(got, want) < 2e-5


@pytest.mark.parametrize("low", [False, True])
@pytest.mark.parametrize("c", [20, 101])
def test_make_wide_filter_matches_jax(monkeypatch, chunks_spy, low, c):
    if low:
        monkeypatch.setattr(t_filter, "_JOIN_MAX_ROWS", LOW)
        monkeypatch.setattr(j_filter, "_JOIN_MAX_ROWS", LOW)
    x, v = _data(c, seed=1)
    tdk, jdk = t_kernels.rbf_kernel(2), j_kernels.rbf_kernel(2)
    cap = _occupancy(x, jdk) + 8
    jmv = j_filter.make_wide_filter(jnp.asarray(x), jdk, capacity=cap)
    tmv = t_filter.make_wide_filter(torch.from_numpy(x), tdk, capacity=cap)
    for k in range(2):  # one plan, two MVMs, as the range sketch uses it
        vk = v * (k + 1)
        assert rel_err(tmv(torch.from_numpy(vk)).numpy(), np.asarray(jmv(jnp.asarray(vk)))) < 2e-5
    assert chunks_spy == [((N, c), t_filter._WIDE_CHUNK)] * 2  # K9 by windows at any size


@pytest.mark.parametrize("c", [20, 101])
def test_make_wide_filter_below_the_threshold_takes_the_row_lists(plans_spy, c):
    """Below _JOIN_MAX_ROWS the range sketch's filter is a WidePlan, untrimmed, applied by K9 by windows on its
    row lists (never K3), both MVMs on the one build, and it matches JAX's join branch."""
    x, v = _data(c, seed=7)
    tdk, jdk = t_kernels.matern_kernel(1.5, 1), j_kernels.matern_kernel(1.5, 1)
    jmv = j_filter.make_wide_filter(jnp.asarray(x), jdk, capacity=_occupancy(x, jdk) + 8)
    tmv = t_filter.make_wide_filter(torch.from_numpy(x), tdk, capacity=_occupancy(x, jdk) + 8)
    for k in range(2):
        vk = v * (k + 1)
        assert rel_err(tmv(torch.from_numpy(vk)).numpy(), np.asarray(jmv(jnp.asarray(vk)))) < 2e-5
    assert plans_spy["join"] == [] and len(plans_spy["cols"]) == 2
    first, second = plans_spy["cols"]
    assert isinstance(first, t_lattice.WidePlan) and first is second
    assert first.neighbors.shape[1] == N * (D + 1)  # untrimmed below the threshold, as JAX's join branch


def test_chunked_apply_plain_is_the_apply_per_block():
    """K9's plain version sums every column alone (row-order splat, blurs, slice), so blocks of 8 or 3
    columns give the apply of the whole block bit for bit, and that is the wide operator: against K3's
    formula in float64 (JAX pads to whole blocks and drops the padding columns, the same output)."""
    x, v = _data(20, seed=2)
    dk = t_kernels.rbf_kernel(1)
    plan = t_lattice.build_plan_join(torch.from_numpy(x), dk.coeffs, dk.variance)
    whole = K.apply_plain(plan.seg_ids, plan.weights, plan.neighbors, torch.from_numpy(v).double(), dk.coeffs,
                          t_lattice.SLICE_NORM(D))
    chunked = t_lattice.apply_plan_cols(plan, torch.from_numpy(v), dk.coeffs, 8)
    torch.testing.assert_close(chunked.double(), whole, rtol=1e-6, atol=1e-6)
    before = K.lattice_apply_cols.launches
    for chunk in (3, 20):
        assert torch.equal(t_lattice.apply_plan_cols(plan, torch.from_numpy(v), dk.coeffs, chunk), chunked)
    assert K.lattice_apply_cols.launches == before  # a CPU tensor takes the plain version


@pytest.mark.parametrize("c,route", [(8, "once"), (20, "chunked"), (101, "chunked")])
def test_filter_plain_dispatch(low_threshold, chunks_spy, c, route):
    x, v = _data(c, seed=3)
    tdk, jdk = t_kernels.rbf_kernel(1), j_kernels.rbf_kernel(1)
    want = np.asarray(j_filter._filter_plain(jnp.asarray(v), jnp.asarray(x), jdk))
    got = t_filter._filter_plain(torch.from_numpy(v), torch.from_numpy(x), tdk).numpy()
    assert rel_err(got, want) < 2e-5
    assert len(chunks_spy) == (route == "chunked")


def test_filter_plain_keeps_the_join_branch_below_the_threshold(chunks_spy):
    x, v = _data(20, seed=4)
    tdk, jdk = t_kernels.rbf_kernel(1), j_kernels.rbf_kernel(1)
    want = np.asarray(j_filter._filter_plain(jnp.asarray(v), jnp.asarray(x), jdk))
    assert rel_err(t_filter._filter_plain(torch.from_numpy(v), torch.from_numpy(x), tdk).numpy(), want) < 2e-5
    assert chunks_spy == []


def test_chunked_exact_gradient_matches_the_unchunked_one(monkeypatch):
    """The exact filter's backward after K9 (per window) against the one after K3."""
    x, v = _data(20, seed=5)
    dk = t_kernels.matern_kernel(1.5, 1)
    g = torch.from_numpy(np.random.default_rng(6).normal(size=(N, 20)).astype(np.float32))

    def grads():
        src = torch.from_numpy(v).requires_grad_(True)
        ref = torch.from_numpy(x).requires_grad_(True)
        out = t_filter.lattice_filter_exact_grad(src, ref, dk)
        out.backward(g)
        return out.detach(), src.grad, ref.grad

    base = grads()
    monkeypatch.setattr(t_filter, "_JOIN_MAX_ROWS", LOW)
    chunked = grads()
    for a, b in zip(chunked, base):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_serving_slice_takes_the_chunked_route_and_matches_jax(low_threshold, chunks_spy):
    """posterior_cache's two sketch MVMs and predict_from_cache's rect filter through K9."""
    rng = np.random.default_rng(31)
    n, d = 700, 3
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (np.sin(2 * x[:, 0]) + 0.3 * rng.normal(size=n)).astype(np.float32)
    xt = rng.normal(size=(96, d)).astype(np.float32)
    kw = dict(num_dims=d, kernel="matern", nu=1.5, order=1, min_noise=0.1)
    raw = {k: np.asarray(v) for k, v in J.SimplexGP(**kw).init_params(lengthscale=1.0).items()}
    raw["raw_lengthscale"] = np.log(np.expm1(np.array([0.8, 1.1, 1.7], np.float32))).astype(np.float32)
    raw["raw_noise"] = np.float32(-2.0)
    jm = J.SimplexGP(**kw, eval_cg_tolerance=1e-5)
    jraw = {k: jnp.asarray(v) for k, v in raw.items()}
    key = jax.random.PRNGKey(4)
    jc = jm.posterior_cache(jraw, jnp.asarray(x), jnp.asarray(y), key)
    jmean, jvar = map(np.asarray, jm.predict_from_cache(jc, jnp.asarray(x), jnp.asarray(xt)))
    omega = np.array(jax.random.normal(key, (n, jm.bbmm.max_lanczos_iterations), jnp.float32))

    tm = T.SimplexGP(**kw, eval_cg_tolerance=1e-5).load_raw(raw)
    tc = tm.posterior_cache(torch.from_numpy(x), torch.from_numpy(y), omega=torch.from_numpy(omega))
    tmean, tvar = tm.predict_from_cache(tc, torch.from_numpy(x), torch.from_numpy(xt))
    assert chunks_spy == [((n, 100), 8), ((n, 100), 8), ((n + 96, 101), 8)]
    assert rel_err(tc["alpha"].numpy(), np.asarray(jc["alpha"])) < 1e-4
    np.testing.assert_allclose(tmean.numpy(), jmean, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tvar.numpy(), jvar, rtol=1e-4)
