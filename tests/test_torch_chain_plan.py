"""The port's sort-chain plan (K3', plain versions on the CPU) held against JAX's.

The same numpy inputs go through ``simplex_gp_tpu``'s build_plan_chain /
apply_plan_chain (JAX on the CPU) and ``simplex_gp_torch``'s (its plain
PyTorch versions: the tensors lie on the CPU), and through the port's join
plan.  Ports of tests/test_chain_plan.py, and the chain as the CG plan of
the NLML engine and of posterior_cache.  Tolerances:
  * n_lattice equal, and cnt (each table row's contribution end) equal to
    JAX's: both sort the vertices by the same 43-bit chain words;
  * the operator rel < 2e-5 against JAX's chain and the port's join, the
    bound JAX holds its own two engines to (test_chain_plan.py:36-45).  The
    port sums each row's contributions directly where JAX differences a
    running sum, so the two agree to ~1e-6, not bit for bit;
  * the NLML value 1e-5 and raw gradients rel 2e-3 against JAX's
    lattice_nlml with the same probes, test_torch_mll.py's bounds;
  * posterior_cache with JAX's omega: test_torch_slice.py's bounds at a
    tight eval tolerance (alpha rel 1e-4, mean and variance 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from chain_fixtures import RUN_LENGTHS, chain_class_positions, synthetic_chain_plan
from torch_parity import rel_err, seeded

import simplex_gp_torch as T
import simplex_gp_tpu as J
from simplex_gp_torch.kernels import chain as t_chain
from simplex_gp_torch.linalg import mll as t_mll
from simplex_gp_torch.ops import filter as t_filter
from simplex_gp_torch.ops import kernels as t_kernels
from simplex_gp_torch.ops import lattice as t_lattice
from simplex_gp_tpu.linalg import mll as j_mll
from simplex_gp_tpu.ops import kernels as j_kernels
from simplex_gp_tpu.ops import lattice as j_lattice
from simplex_gp_tpu.ops.cpu_ref import available, filter_ref

# test_chain_plan.py::test_chain_matches_join's grid.
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


def _port_chain(x, v, dk, capacity=None):
    plan = t_lattice.build_plan_chain(torch.from_numpy(x), dk.coeffs, dk.variance, capacity)
    return plan, t_lattice.apply_plan_chain(plan, torch.from_numpy(v), dk.coeffs).numpy()


@pytest.mark.parametrize("n,d,order,kind", GRID)
def test_chain_matches_join(n, d, order, kind):
    x, v = seeded(n, d, 3)
    tdk, jdk = _kernels(kind, order)
    jplan = j_lattice.build_plan_chain(jnp.asarray(x), jdk.coeffs, jdk.variance)
    jout = np.asarray(j_lattice.apply_plan_chain(jplan, jnp.asarray(v), jdk.coeffs))
    plan, out = _port_chain(x, v, tdk)
    join = t_lattice.build_plan_join(torch.from_numpy(x), tdk.coeffs, tdk.variance)
    jn = t_lattice.apply_plan_join(join, torch.from_numpy(v), tdk.coeffs).numpy()
    assert int(plan.n_lattice) == int(jplan.n_lattice) == int(join.n_lattice)
    np.testing.assert_array_equal(plan.cnt.numpy(), np.asarray(jplan.cnt))
    assert rel_err(out, jout) < 2e-5
    assert rel_err(out, jn) < 2e-5


def test_chain_is_default_plan():
    """build_plan is the chain, apply_plan dispatches on the plan type, and build_plan_any gives a
    ChainPlan for a DiscretizedKernel on one device (JAX's filter.py:186-193); apply_plan_any takes a chain
    plan's transpose (the exact backward's) through apply_plan_chain."""
    tdk, _ = _kernels("rbf", 1)
    x, v = seeded(128, 4, 3)
    xt, vt = torch.from_numpy(x), torch.from_numpy(v)
    plan = t_lattice.build_plan(xt, tdk.coeffs, tdk.variance)
    assert isinstance(plan, t_lattice.ChainPlan)
    out = t_lattice.apply_plan(plan, vt, tdk.coeffs)
    torch.testing.assert_close(out, t_lattice.apply_plan_chain(plan, vt, tdk.coeffs), rtol=0, atol=0)
    join = t_lattice.build_plan_join(xt, tdk.coeffs, tdk.variance)
    torch.testing.assert_close(t_lattice.apply_plan(join, vt, tdk.coeffs),
                               t_lattice.apply_plan_join(join, vt, tdk.coeffs), rtol=0, atol=0)
    anyp = t_filter.build_plan_any(xt, tdk, capacity=300)
    assert isinstance(anyp, t_lattice.ChainPlan) and anyp.cnt.shape == (300,)
    torch.testing.assert_close(t_filter.apply_plan_any(anyp, vt, tdk), out, rtol=0, atol=0)
    torch.testing.assert_close(t_filter.apply_plan_any(anyp, vt, tdk, transpose=True),
                               t_lattice.apply_plan_chain(anyp, vt, tdk.coeffs, transpose=True), rtol=0, atol=0)


def test_chain_symmetry_matches_join():
    """The quadratic forms u^T K v and v^T K u of the chain equal the join's (the same operator, the
    same blur-axis commutator; test_chain_plan.py:58)."""
    tdk, jdk = _kernels("rbf", 1)
    x, _ = seeded(300, 4, 1)
    rng = np.random.default_rng(1)
    u = rng.normal(size=(300, 1)).astype(np.float32)
    v = rng.normal(size=(300, 1)).astype(np.float32)

    def forms(apply):
        Ku, Kv = apply(u), apply(v)
        return float((u * Kv).sum()), float((v * Ku).sum())

    cplan = t_lattice.build_plan_chain(torch.from_numpy(x), tdk.coeffs, tdk.variance)
    jplan = t_lattice.build_plan_join(torch.from_numpy(x), tdk.coeffs, tdk.variance)
    jax_plan = j_lattice.build_plan_chain(jnp.asarray(x), jdk.coeffs, jdk.variance)
    cc = forms(lambda w: t_lattice.apply_plan_chain(cplan, torch.from_numpy(w), tdk.coeffs).numpy())
    cj = forms(lambda w: t_lattice.apply_plan_join(jplan, torch.from_numpy(w), tdk.coeffs).numpy())
    cx = forms(lambda w: np.asarray(j_lattice.apply_plan_chain(jax_plan, jnp.asarray(w), jdk.coeffs)))
    np.testing.assert_allclose(cc, cj, rtol=1e-5)
    np.testing.assert_allclose(cc, cx, rtol=1e-5)


def test_chain_linearity():
    tdk, _ = _kernels("rbf", 2)
    x, _ = seeded(200, 3, 1)
    rng = np.random.default_rng(2)
    u = torch.from_numpy(rng.normal(size=(200, 2)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(200, 2)).astype(np.float32))
    plan = t_lattice.build_plan_chain(torch.from_numpy(x), tdk.coeffs, tdk.variance)
    lhs = t_lattice.apply_plan_chain(plan, 2.0 * u - 3.0 * v, tdk.coeffs)
    rhs = 2.0 * t_lattice.apply_plan_chain(plan, u, tdk.coeffs) - 3.0 * t_lattice.apply_plan_chain(
        plan, v, tdk.coeffs)
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), rtol=1e-4, atol=1e-5)


def test_capacity_trim_exact_and_overflow_guard():
    """A sufficient capacity gives the untrimmed output bit for bit; one row short of the occupancy,
    every output is NaN and the occupancy is still reported (test_chain_plan.py:145)."""
    tdk, jdk = _kernels("rbf", 1)
    x, v = seeded(400, 5, 2, seed=7)
    full, out_full = _port_chain(x, v, tdk)
    n_lat = int(full.n_lattice)
    trimmed, out_trim = _port_chain(x, v, tdk, capacity=n_lat + 8)
    assert int(trimmed.n_lattice) == n_lat and trimmed.cnt.shape == (n_lat + 8,)
    np.testing.assert_array_equal(out_trim, out_full)
    jtrim = j_lattice.build_plan_chain(jnp.asarray(x), jdk.coeffs, jdk.variance, capacity=n_lat + 8)
    np.testing.assert_array_equal(trimmed.cnt.numpy(), np.asarray(jtrim.cnt))
    for cap in (n_lat - 1, max(8, n_lat // 2)):
        under, out_under = _port_chain(x, v, tdk, capacity=cap)
        assert int(under.n_lattice) == n_lat
        assert np.isnan(out_under).all()
        assert int(under.slice_idx.max()) < cap and int(under.gather.max()) < cap


@pytest.mark.parametrize("n,d,c,order,kind", [(100, 1, 1, 1, "rbf"), (150, 5, 3, 3, "matern"),
                                              (200, 17, 1, 1, "matern")])
def test_chain_matches_cpp_golden_model(n, d, c, order, kind):
    """The chain against the reference's C++ filter, as test_torch_lattice.py holds the join."""
    if not available():
        pytest.skip("g++ golden model unavailable")
    rng = np.random.default_rng(7)
    x = rng.normal(size=(n, d)).astype(np.float32)
    v = rng.normal(size=(n, c)).astype(np.float32)
    tdk, _ = _kernels(kind, order)
    _, ours = _port_chain(x, v, tdk)
    gold = filter_ref(v, x, np.asarray(tdk.coeffs), tdk.variance)
    # tests/test_cpu_ref.py's bound: f32 roundoff, other accumulation orders.
    np.testing.assert_allclose(ours, gold, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("order,capacity", [(1, None), (2, None), (2, 40)])
def test_chain_one_dimension(order, capacity):
    """d = 1: one transition (by the final positions) between the two axes (lattice.py:830-833)."""
    tdk, jdk = _kernels("rbf", order)
    x, v = seeded(300, 1, 2, seed=4)
    x = 3.0 * x
    jplan = j_lattice.build_plan_chain(jnp.asarray(x), jdk.coeffs, jdk.variance, capacity=capacity)
    jout = np.asarray(j_lattice.apply_plan_chain(jplan, jnp.asarray(v), jdk.coeffs))
    plan, out = _port_chain(x, v, tdk, capacity)
    assert plan.gather.shape[0] == 1 and plan.tapw.shape[:2] == (2, order)
    assert int(plan.n_lattice) == int(jplan.n_lattice)
    np.testing.assert_array_equal(plan.cnt.numpy(), np.asarray(jplan.cnt))
    assert rel_err(out, jout) < 2e-5


def test_two_builds_and_two_applies_are_bit_equal():
    """No atomics, fixed summation orders: a rebuilt plan and a repeated apply give the same bits."""
    tdk, _ = _kernels("matern", 1)
    x, v = seeded(500, 6, 11, seed=5)
    a = t_lattice.build_plan_chain(torch.from_numpy(x), tdk.coeffs, tdk.variance)
    b = t_lattice.build_plan_chain(torch.from_numpy(x), tdk.coeffs, tdk.variance)
    for f in t_lattice.ChainPlan._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    first = t_lattice.apply_plan_chain(a, torch.from_numpy(v), tdk.coeffs)
    assert torch.equal(first, t_lattice.apply_plan_chain(b, torch.from_numpy(v), tdk.coeffs))


def test_long_runs_are_summed_by_blocks():
    """Rows of more than PIECE contributions are summed in pieces, then the pieces; the operator holds."""
    tdk, _ = _kernels("rbf", 1)
    rng = np.random.default_rng(8)
    x = (0.02 * rng.normal(size=(3000, 2))).astype(np.float32)
    v = rng.normal(size=(3000, 3)).astype(np.float32)
    plan, out = _port_chain(x, v, tdk)
    lens = np.diff(np.concatenate([[0], plan.cnt.numpy()]))[: int(plan.n_lattice)]
    assert int(plan.n_long) == int((lens > t_chain.PIECE).sum()) > 0
    assert int(plan.n_pieces) == int(((lens[lens > t_chain.PIECE] + t_chain.PIECE - 1) // t_chain.PIECE).sum())
    join = t_lattice.build_plan_join(torch.from_numpy(x), tdk.coeffs, tdk.variance)
    assert rel_err(out, t_lattice.apply_plan_join(join, torch.from_numpy(v), tdk.coeffs).numpy()) < 2e-5
    table = t_chain.chain_splat_plain(plan, torch.from_numpy(v))
    rows = torch.repeat_interleave(torch.arange(plan.cnt.shape[0]), torch.from_numpy(np.diff(
        np.concatenate([[0], plan.cnt.numpy()]))))
    direct = torch.zeros_like(table, dtype=torch.float64).index_add_(
        0, rows, (plan.splat_weights[:, None] * torch.from_numpy(v)[plan.splat_points.long()]).double())
    assert rel_err(table.numpy(), direct.numpy()) < 1e-6


def _nlml_case(n, d, kind, order):
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, size=(n, d)).astype(np.float32)
    y = (np.sin(3 * x[:, 0]) + 0.1 * rng.normal(size=n)).astype(np.float32)
    probes = np.random.default_rng(42).choice([-1.0, 1.0], size=(n, 8)).astype(np.float32)
    values = {"inv_ell": np.linspace(0.8, 1.5, d).astype(np.float32), "outputscale": np.float32(0.8),
              "noise": np.float32(0.1), "mean": np.float32(0.05)}
    return x, y, probes, values


@pytest.mark.parametrize("n,d,kind,order,grad_mode", [(300, 3, "matern", 1, "exact"), (400, 5, "rbf", 1, "exact"),
                                                      (300, 3, "matern", 1, "deriv_filter")])
def test_nlml_on_the_chain_plan_matches_jax(n, d, kind, order, grad_mode):
    """The NLML engine with the chain as its CG plan against JAX's lattice_nlml, same probes."""
    x, y, probes, values = _nlml_case(n, d, kind, order)
    tdk, jdk = _kernels(kind, order)
    kw = dict(cg_tolerance=1e-3, max_cg_iterations=300, max_lanczos_iterations=40, num_probes=8,
              precond_rank=20, grad_mode=grad_mode)
    j_val, j_grad = jax.value_and_grad(
        lambda p: j_mll.lattice_nlml(jdk, j_mll.BBMMConfig(**kw), p, jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(probes)))({k: jnp.asarray(v) for k, v in values.items()})
    params = {k: torch.tensor(v, requires_grad=True) for k, v in values.items()}
    stats = {}
    loss = t_mll.lattice_nlml(tdk, t_mll.BBMMConfig(**kw), params, torch.from_numpy(x), torch.from_numpy(y),
                              torch.from_numpy(probes), stats=stats)
    loss.backward()
    assert stats["cg_iters"] >= 10
    assert abs(float(loss.detach()) - float(j_val)) <= 1e-5
    for k in values:
        assert rel_err(params[k].grad.numpy(), np.asarray(j_grad[k])) <= 2e-3, k


class _Spy:
    """Records the calls of module functions, passing them through."""

    def __init__(self, monkeypatch, module, *names):
        self.calls = {name: [] for name in names}
        for name in names:
            fn = getattr(module, name)

            def wrapped(*args, _fn=fn, _name=name, **kwargs):
                out = _fn(*args, **kwargs)
                self.calls[_name].append((args, kwargs, out))
                return out

            monkeypatch.setattr(module, name, wrapped)


def test_engine_runs_its_cg_on_the_chain_and_its_backward_on_a_join_plan(monkeypatch):
    """_solve_system's CG applies a ChainPlan only; the exact backward reuses that plan, saved by the forward:
    it builds no join plan (build_wide_plan_join) and runs no K9 (apply_plan_rows) or K3, but the chain
    apply with its final-order table and the transposed chain apply with its table, each once, on the CG's
    plan (the sort chain's reverse mode, JAX's autodiff through apply_plan_chain, lattice.py:943)."""
    x, y, probes, values = _nlml_case(300, 3, "matern", 1)
    tdk, _ = _kernels("matern", 1)
    spy = _Spy(monkeypatch, t_filter, "build_plan", "apply_plan_chain", "apply_plan_join", "build_wide_plan_join",
               "apply_plan_rows")
    cfg = t_mll.BBMMConfig(cg_tolerance=1.0, num_probes=8, precond_rank=20, plan_capacity=1024)
    params = {k: torch.tensor(v, requires_grad=True) for k, v in values.items()}
    loss = t_mll.lattice_nlml(tdk, cfg, params, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(probes))
    (plan_call,) = spy.calls["build_plan"]
    assert isinstance(plan_call[2], t_lattice.ChainPlan) and plan_call[2].cnt.shape == (1024,)
    assert len(spy.calls["apply_plan_chain"]) >= 10
    assert all(call[0][0] is plan_call[2] for call in spy.calls["apply_plan_chain"])
    assert not spy.calls["apply_plan_join"] and not spy.calls["build_wide_plan_join"]
    forward_applies = len(spy.calls["apply_plan_chain"])
    loss.backward()
    assert not spy.calls["build_wide_plan_join"] and not spy.calls["apply_plan_join"]
    assert not spy.calls["apply_plan_rows"] and len(spy.calls["build_plan"]) == 1
    applies = spy.calls["apply_plan_chain"][forward_applies:]  # forward with its table, then transposed
    assert [call[0][3:] for call in applies] == [(False, True), (True, True)]
    assert all(call[0][0].slice_idx.data_ptr() == plan_call[2].slice_idx.data_ptr() for call in applies)
    assert all(len(call[2]) == 2 and call[2][1].shape == (1024, call[0][1].shape[1]) for call in applies)


def test_posterior_cache_runs_its_cg_on_the_chain_and_matches_jax(monkeypatch):
    """posterior_cache against JAX's with JAX's omega fed in; its eval CG applies the ChainPlan, its
    two sketch MVMs a join plan of their own (make_wide_filter, exact_gp.py:339) through that plan's row
    lists (apply_plan_cols, K9's row-order splat), not K3."""
    rng = np.random.default_rng(21)
    n, d = 600, 3
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (np.sin(2 * x[:, 0]) + 0.3 * rng.normal(size=n)).astype(np.float32)
    xt = rng.normal(size=(64, d)).astype(np.float32)
    kw = dict(num_dims=d, kernel="matern", nu=1.5, order=1, min_noise=0.1)
    raw = {k: np.asarray(v) for k, v in J.SimplexGP(**kw).init_params(lengthscale=1.0).items()}
    raw["raw_lengthscale"] = np.log(np.expm1(np.array([0.7, 1.2, 2.0], np.float32))).astype(np.float32)
    raw["raw_noise"] = np.float32(-2.0)
    jm = J.SimplexGP(**kw, eval_cg_tolerance=1e-5)
    key = jax.random.PRNGKey(0)
    jraw = {k: jnp.asarray(v) for k, v in raw.items()}
    jc = jm.posterior_cache(jraw, jnp.asarray(x), jnp.asarray(y), key)
    jmean, jvar = map(np.asarray, jm.predict_from_cache(jc, jnp.asarray(x), jnp.asarray(xt)))
    omega = np.array(jax.random.normal(key, (n, min(jm.bbmm.max_lanczos_iterations, n)), jnp.float32))

    spy = _Spy(monkeypatch, t_filter, "build_plan", "apply_plan_chain", "build_wide_plan_join", "apply_plan_join",
               "apply_plan_cols")
    tm = T.SimplexGP(**kw, eval_cg_tolerance=1e-5).load_raw(raw)
    tc = tm.posterior_cache(torch.from_numpy(x), torch.from_numpy(y), omega=torch.from_numpy(omega))
    (plan_call,) = spy.calls["build_plan"]
    assert isinstance(plan_call[2], t_lattice.ChainPlan)
    assert len(spy.calls["apply_plan_chain"]) == tc["cg_iters"] >= 10  # one MVM per iteration
    (join_call,) = spy.calls["build_wide_plan_join"]
    assert not spy.calls["apply_plan_join"] and len(spy.calls["apply_plan_cols"]) == 2
    assert all(call[0][0].seg_ids is join_call[2].seg_ids for call in spy.calls["apply_plan_cols"])
    tmean, tvar = tm.predict_from_cache(tc, torch.from_numpy(x), torch.from_numpy(xt))
    assert rel_err(tc["alpha"].numpy(), np.asarray(jc["alpha"])) < 1e-4
    np.testing.assert_allclose(tmean.numpy(), jmean, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tvar.numpy(), jvar, rtol=1e-4)


def _xor_butterfly(lanes):
    """(32, c) lane values -> lane 0 after the warp's xor shuffles at offsets 16 .. 1."""
    idx = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[idx ^ off]
    return lanes[0]


def _warp_run(vals):
    """A warp's sum of vals (L, c), L <= PIECE: lane l adds rows l, l + 32, ... in turn, then the butterfly."""
    lanes = torch.zeros((32, vals.shape[1]), dtype=torch.float32)
    for k in range(0, vals.shape[0], 32):
        chunk = vals[k:k + 32]
        lanes[:chunk.shape[0]] = lanes[:chunk.shape[0]] + chunk
    return _xor_butterfly(lanes)


def _group_fold(vals):
    """A short run (L <= SHORT): lanes 0 + w v, padded with +0 to the smallest power of two g >= L, folded
    in halves (the butterfly over a group of g lanes)."""
    L = vals.shape[0]
    g = 1
    while g < L:
        g *= 2
    x = torch.zeros((g, vals.shape[1]), dtype=torch.float32)
    x[:L] = 0.0 + vals
    while g > 1:
        g //= 2
        x = x[:g] + x[g:2 * g]
    return x[0]


def _splat_by_class(plan, v):
    """The kernel's per-class order, row by row: the group fold for runs of at most SHORT, one warp run
    for runs of at most PIECE, and for longer runs a warp run per piece of PIECE, then a warp run over the
    pieces' sums."""
    cnt = plan.cnt.tolist()
    live = min(int(plan.n_lattice), len(cnt))
    contrib = plan.splat_weights[:, None] * v[plan.splat_points.long()]
    rows = []
    for g in range(live):
        start = cnt[g - 1] if g else 0
        vals = contrib[start:cnt[g]]
        if vals.shape[0] <= t_chain.SHORT:
            rows.append(_group_fold(vals))
        elif vals.shape[0] <= t_chain.PIECE:
            rows.append(_warp_run(vals))
        else:
            parts = torch.stack([_warp_run(vals[k:k + t_chain.PIECE])
                                 for k in range(0, vals.shape[0], t_chain.PIECE)])
            rows.append(_warp_run(parts))
    return torch.stack(rows)


@pytest.mark.parametrize("c", [1, 11, 17])
def test_splat_order_by_class_equals_the_warp_order(c):
    """The kernel's per-class order (thread-per-column fold of short runs, one-pass warp runs beyond) is
    the plain version's warp order bit for bit, at every run length class and across column tiles."""
    plan = synthetic_chain_plan(RUN_LENGTHS, 700, seed=c)
    v = torch.from_numpy(np.random.default_rng(100 + c).normal(size=(700, c)).astype(np.float32))
    live = len(RUN_LENGTHS)
    table = t_chain.chain_splat_plain(plan, v)
    assert torch.equal(_splat_by_class(plan, v), table[:live])
    # Against a float64 sum of each run: the warp order is a sum, not just a fixed order.
    direct = torch.stack([(plan.splat_weights[s:e, None].double() * v[plan.splat_points[s:e].long()].double()).sum(0)
                          for s, e in zip([0] + plan.cnt[:live - 1].tolist(), plan.cnt[:live].tolist())])
    assert rel_err(table[:live].numpy(), direct.numpy()) < 1e-6


def test_run_lists_match_their_definition():
    """The plan's work lists: long rows (> PIECE) with their pieces of PIECE, mid rows (SHORT+1 .. PIECE),
    ascending, each padded to its bound; rows past the live count are in none."""
    plan = synthetic_chain_plan(RUN_LENGTHS, 700, seed=0)
    lens = np.array(RUN_LENGTHS)
    nl, nm, npc = int(plan.n_long), int(plan.n_mid), int(plan.n_pieces)
    np.testing.assert_array_equal(plan.long_rows[:nl].numpy(), np.nonzero(lens > t_chain.PIECE)[0])
    np.testing.assert_array_equal(plan.mid_rows[:nm].numpy(),
                                  np.nonzero((lens > t_chain.SHORT) & (lens <= t_chain.PIECE))[0])
    pieces = -(-lens[lens > t_chain.PIECE] // t_chain.PIECE)
    assert npc == pieces.sum()
    np.testing.assert_array_equal(plan.long_first[:nl + 1].numpy(), np.concatenate([[0], np.cumsum(pieces)]))
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    want = np.concatenate([starts[g] + t_chain.PIECE * np.arange(k)
                           for g, k in zip(np.nonzero(lens > t_chain.PIECE)[0], pieces)])
    np.testing.assert_array_equal(plan.piece_start[:npc].numpy(), want)
    N, Mc = int(lens.sum()), plan.cnt.shape[0]
    assert plan.long_rows.shape[0] == min(Mc, N // (t_chain.PIECE + 1))
    assert plan.piece_row.shape[0] == N // t_chain.PIECE + plan.long_rows.shape[0]
    assert plan.mid_rows.shape[0] == min(Mc, N // (t_chain.SHORT + 1))


@pytest.mark.parametrize("capacity", [None, "trim", "over"])
def test_built_plan_buckets_and_splat_order(capacity):
    """A plan built from positions with runs of every class (clustered and spread points): its mid and long
    lists against their definition over the live rows, and its splat in the per-class order, untrimmed,
    trimmed and past the capacity (the first Mc rows)."""
    tdk, _ = _kernels("rbf", 1)
    x = chain_class_positions()
    v = torch.from_numpy(np.random.default_rng(9).normal(size=(x.shape[0], 11)).astype(np.float32))
    occ = int(t_lattice.count_lattice_points(torch.from_numpy(x), tdk.variance))
    cap = {None: None, "trim": occ + 3, "over": occ - 5}[capacity]
    plan = t_lattice.build_plan_chain(torch.from_numpy(x), tdk.coeffs, tdk.variance, cap)
    live = min(int(plan.n_lattice), plan.cnt.shape[0])
    lens = np.diff(np.concatenate([[0], plan.cnt.numpy()]))[:live]
    assert (lens <= t_chain.SHORT).any() and ((lens > t_chain.SHORT) & (lens <= t_chain.PIECE)).any()
    assert (lens > t_chain.PIECE).any()
    np.testing.assert_array_equal(plan.mid_rows[:int(plan.n_mid)].numpy(),
                                  np.nonzero((lens > t_chain.SHORT) & (lens <= t_chain.PIECE))[0])
    np.testing.assert_array_equal(plan.long_rows[:int(plan.n_long)].numpy(), np.nonzero(lens > t_chain.PIECE)[0])
    assert torch.equal(_splat_by_class(plan, v), t_chain.chain_splat_plain(plan, v)[:live])
