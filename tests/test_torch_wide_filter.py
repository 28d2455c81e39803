"""The chunked wide chain, K9's join route below it, and JAX's wide dispatch, against the JAX package.

Same numpy inputs on both sides; the port on the CPU (plain kernel
versions).  Above the threshold (``_JOIN_MAX_ROWS``, 4M contribution rows)
both packages build one sort-chain plan and apply it in column blocks (8
columns in JAX, 16 in the port), so the two agree to float32 summation order: rel 1e-5 (measured <= 3e-7),
and their exact gradients against jax.vjp of JAX's chunked filter at grad_v
rel 1e-4 and grad_ref rel 1e-3, test_torch_chain_backward.py's bounds.
Below it the port's K9 runs on the join plan where JAX applies its join
plan, the same operator up to 64-bit hash collisions, and a test that
holds the two routes against each other takes the bound of
test_chain_plan.py::test_chain_matches_join, rel < 2e-5 with equal
n_lattice.  The threshold is patched low in both packages to reach the
chunked branch at test sizes; the JAX source does not change.  The serving
slice uses the tolerances of test_torch_slice.py at eval CG tolerance 1e-5.
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
    """Counts the port's calls of the chunked apply (the chunked chain's block loop in ops/filter.py): each
    call's value shape and block width, and checks that the plan is a ChainPlan."""
    calls = []
    real = t_filter._apply_chain_blocks

    def spy(plan, v, coeffs):
        assert isinstance(plan, t_lattice.ChainPlan)
        calls.append((tuple(v.shape), t_filter._WIDE_CHUNK))
        return real(plan, v, coeffs)

    monkeypatch.setattr(t_filter, "_apply_chain_blocks", spy)
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
def test_make_wide_filter_matches_jax(monkeypatch, chunks_spy, plans_spy, low, c):
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
    if low:  # the chunked chain above the threshold, K9 below it
        assert chunks_spy == [((N, c), t_filter._WIDE_CHUNK)] * 2 and plans_spy["cols"] == []
    else:
        assert chunks_spy == [] and len(plans_spy["cols"]) == 2


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
    """The exact filter's backward after the chunked chain (per block) against the one after K9 on the join
    plan, below the threshold: the chain-vs-join operators, whose gradients agree within 1e-5."""
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
    """posterior_cache's two sketch MVMs and predict_from_cache's rect filter through the chunked chain."""
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
    w = t_filter._WIDE_CHUNK
    assert chunks_spy == [((n, 100), w), ((n, 100), w), ((n + 96, 101), w)]
    assert rel_err(tc["alpha"].numpy(), np.asarray(jc["alpha"])) < 1e-4
    np.testing.assert_allclose(tmean.numpy(), jmean, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tvar.numpy(), jvar, rtol=1e-4)


# ---- the chunked chain above the threshold, against JAX's ------------------------------------------------------


def _mixture(J=3):
    return t_kernels.mixture_kernel(1.5, 1, J), j_kernels.mixture_kernel(1.5, 1, J)


@pytest.mark.parametrize("trim", [None, "occupancy"])
@pytest.mark.parametrize("c", [17, 100])
def test_chunked_chain_matches_jax(low_threshold, chunks_spy, c, trim):
    """lattice_filter_wide_chunked and make_wide_filter (two MVMs on one plan) against JAX's chunked chain,
    untrimmed and at the occupancy; the port's blocks cover the c columns, the last one narrower."""
    x, v = _data(c, seed=11)
    tdk, jdk = t_kernels.matern_kernel(1.5, 1), j_kernels.matern_kernel(1.5, 1)
    cap = None if trim is None else _occupancy(x, jdk)
    want = np.asarray(j_filter.lattice_filter_wide_chunked(jnp.asarray(v), jnp.asarray(x), jdk, capacity=cap))
    got = t_filter.lattice_filter_wide_chunked(torch.from_numpy(v), torch.from_numpy(x), tdk, cap).numpy()
    assert rel_err(got, want) <= 1e-5
    jmv = j_filter.make_wide_filter(jnp.asarray(x), jdk, capacity=cap)
    tmv = t_filter.make_wide_filter(torch.from_numpy(x), tdk, capacity=cap)
    for k in range(2):
        vk = v * (k + 1)
        assert rel_err(tmv(torch.from_numpy(vk)).numpy(), np.asarray(jmv(jnp.asarray(vk)))) <= 1e-5
    assert chunks_spy == [((N, c), t_filter._WIDE_CHUNK)] * 3


@pytest.mark.parametrize("c", [17, 100])
def test_chunked_chain_mixture_and_rect_match_jax(low_threshold, chunks_spy, c):
    """The mixture's wide filter (one untrimmed chunked chain a component, make_wide_filter_any) and the rect
    filter above the threshold (its [from; to] plan chunked) against JAX's."""
    x, v = _data(c, seed=12)
    tmk, jmk = _mixture()
    got = t_filter.make_wide_filter(torch.from_numpy(x), tmk, capacity=5)(torch.from_numpy(v)).numpy()
    want = np.asarray(j_filter.make_wide_filter_any(jnp.asarray(x), jmk, capacity=5)(jnp.asarray(v)))
    assert rel_err(got, want) <= 1e-5
    assert chunks_spy == [((N, c), t_filter._WIDE_CHUNK)] * len(tmk.alphas)
    chunks_spy.clear()
    xt = np.random.default_rng(13).normal(size=(90, D)).astype(np.float32)
    for tdk, jdk in ((t_kernels.rbf_kernel(1), j_kernels.rbf_kernel(1)), (tmk, jmk)):
        got = t_filter.lattice_filter_rect(torch.from_numpy(v), torch.from_numpy(x), torch.from_numpy(xt), tdk)
        want = j_filter.lattice_filter_rect(jnp.asarray(v), jnp.asarray(x), jnp.asarray(xt), jdk)
        assert got.shape == (90, c) and rel_err(got.numpy(), np.asarray(want)) <= 1e-5
    assert chunks_spy == [((N + 90, c), t_filter._WIDE_CHUNK)] * (1 + len(tmk.alphas))


@pytest.mark.parametrize("trim", [None, "occupancy"])
@pytest.mark.parametrize("c", [17, 40])
def test_chunked_exact_gradient_matches_jax_vjp(low_threshold, c, trim):
    """The chunked chain's exact gradient (per block: the chain apply with its table, the transposed chain
    apply, K5 at slice_idx; the blocks' position gradients summed) against jax.vjp of JAX's
    lattice_filter_wide_chunked at the same capacity: grad_v rel 1e-4, grad_ref rel 1e-3."""
    x, v = _data(c, seed=14)
    x = 0.7 * x
    g = np.random.default_rng(15).normal(size=(N, c)).astype(np.float32)
    tdk, jdk = t_kernels.matern_kernel(1.5, 1), j_kernels.matern_kernel(1.5, 1)
    cap = None if trim is None else _occupancy(x, jdk)
    out, vjp = jax.vjp(lambda s, r: j_filter.lattice_filter_wide_chunked(s, r, jdk, capacity=cap),
                       jnp.asarray(v), jnp.asarray(x))
    jgv, jgx = vjp(jnp.asarray(g))
    src = torch.from_numpy(v).requires_grad_(True)
    ref = torch.from_numpy(x).requires_grad_(True)
    got = t_filter.lattice_filter_exact_grad(src, ref, tdk, cap)
    got.backward(torch.from_numpy(g))
    assert rel_err(got.detach().numpy(), np.asarray(out)) <= 1e-5
    assert rel_err(src.grad.numpy(), np.asarray(jgv)) <= 1e-4
    assert rel_err(ref.grad.numpy(), np.asarray(jgx)) <= 1e-3


@pytest.mark.parametrize("c", [17, 100])
def test_chain_block_loop_is_one_plain_apply(c):
    """The block loop (16 columns a block, or JAX's 8) is bit for bit one plain chain apply of all the columns:
    the columns do not interact, and the plain versions sum each column alone."""
    x, v = _data(c, seed=16)
    dk = t_kernels.rbf_kernel(2)
    plan = t_lattice.build_plan(torch.from_numpy(x), dk.coeffs, dk.variance)
    whole = t_lattice.apply_plan_chain(plan, torch.from_numpy(v), dk.coeffs)
    assert t_filter._WIDE_CHUNK == 16
    assert torch.equal(t_filter._apply_chain_blocks(plan, torch.from_numpy(v), dk.coeffs), whole)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_filter, "_WIDE_CHUNK", 8)
        assert torch.equal(t_filter._apply_chain_blocks(plan, torch.from_numpy(v), dk.coeffs), whole)


_ENTRY_POINTS = ["make_wide_filter", "make_wide_filter_mixture", "wide_chunked", "filter_plain", "rect",
                 "exact_grad", "exact_grad_mixture"]


@pytest.mark.parametrize("above", [True, False])
@pytest.mark.parametrize("entry", _ENTRY_POINTS)
def test_join_plans_only_below_the_threshold(monkeypatch, plans_spy, entry, above):
    """Above _JOIN_MAX_ROWS no entry point builds a join plan (WidePlan or MixturePlan) or calls K9's or K12's
    apply: each runs the chunked chain.  Below it the routes are as before: K9 on a WidePlan (by windows for
    the sketch's filter, one window for the exact filter and the rect predict) or K12 on a MixturePlan."""
    built, applied = [], []
    for name in ("build_wide_plan_join", "build_plan_mixture"):
        real = getattr(t_filter, name)
        monkeypatch.setattr(t_filter, name, lambda *a, _real=real, _n=name, **k: built.append(_n) or _real(*a, **k))
    for name in ("apply_plan_rows", "apply_plan_mixture", "_apply_chain_blocks"):
        real = getattr(t_filter, name)
        monkeypatch.setattr(t_filter, name, lambda *a, _real=real, _n=name, **k: applied.append(_n) or _real(*a, **k))
    if above:
        monkeypatch.setattr(t_filter, "_JOIN_MAX_ROWS", LOW)
    x, v = _data(20, seed=17)
    xt, vt = torch.from_numpy(x), torch.from_numpy(v)
    dk = _mixture()[0] if entry.endswith("mixture") else t_kernels.rbf_kernel(1)
    launches = K.lattice_apply_cols.launches
    if entry.startswith("make_wide_filter"):
        t_filter.make_wide_filter(xt, dk, capacity=None)(vt)
    elif entry == "wide_chunked":
        t_filter.lattice_filter_wide_chunked(vt, xt, dk) if above else t_filter._filter_plain(vt, xt, dk)
    elif entry == "filter_plain":
        t_filter._filter_plain(vt, xt, dk)
    elif entry == "rect":
        t_filter.lattice_filter_rect(vt[:500], xt[:500], xt[500:], dk)
    else:
        xg = xt.clone().requires_grad_(True)
        t_filter.lattice_filter_exact_grad(vt, xg, dk).sum().backward()
    mixture = entry.endswith("mixture")
    if above:
        assert built == [] and plans_spy["cols"] == [] and plans_spy["join"] == []
        assert set(applied) == {"_apply_chain_blocks"}
    elif entry == "make_wide_filter":
        assert built == ["build_wide_plan_join"] and len(plans_spy["cols"]) == 1 and applied == []
    elif mixture:
        assert built == ["build_plan_mixture"] and "apply_plan_mixture" in applied
        assert "_apply_chain_blocks" not in applied and plans_spy["cols"] == []
    else:
        assert built == ["build_wide_plan_join"] and applied and set(applied) == {"apply_plan_rows"}
    assert K.lattice_apply_cols.launches == launches  # CPU tensors: the plain versions, no launch
