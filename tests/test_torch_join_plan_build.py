"""K2 and the join plan's row build by the card's route, and the one-call wide plan.

On the card K2 (``csrc/dedup.cu``) numbers the rows in the order in which
its inserts win their slots, and the row build (``csrc/join_rows.cu``)
sorts the seg ids stably over their low ``rows_key_bits(J M)`` bits only,
finds the runs and their classes by ``join_rows_kernel``'s rules and places
the lists from three scans.  ``join_fixtures.py`` holds that route in
plain PyTorch, stage by stage (``dedup_staged``, ``rows_staged``,
``plan_rows_staged``); here it is held ``torch.equal`` to the plain plan
and rows (``dedup_neighbors_plain``, ``join_rows_plain``) once both are
renumbered to sorted-hash order: at d = 1, 3, 11 and 18, untrimmed, at
capacity = occupancy and one below it, with one point repeated (runs in
pieces), for a J = 3 stacked mixture plan and for a sharded rank's sparse
rows; and the key-bits rule at J M = 2^k - 1, 2^k and 2^k + 1.  The
one-call builder ``build_wide_plan_join`` equals ``wide_plan(build_plan_join)``
field for field; K9's plain apply on it and the exact NLML gradient through
it meet JAX within the join tolerances of test_torch_wide_filter.py (rel
2e-5) and test_torch_exact_backward.py (value 1e-5, gradients rel 2e-3).
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from chain_fixtures import chain_class_positions
from join_fixtures import plan_rows_staged, rows_staged
from torch_parity import rel_err

from simplex_gp_torch.kernels import build
from simplex_gp_torch.kernels import chain as KC
from simplex_gp_torch.kernels import lattice as K
from simplex_gp_torch.linalg import mll as t_mll
from simplex_gp_torch.ops import filter as t_filter
from simplex_gp_torch.ops import kernels as t_kernels
from simplex_gp_torch.ops import lattice as t_lattice
from simplex_gp_tpu.linalg import mll as j_mll
from simplex_gp_tpu.ops import kernels as j_kernels
from simplex_gp_tpu.ops import lattice as j_lattice

CSRC = pathlib.Path(K.__file__).resolve().parents[1] / "csrc"


def _positions(case, seed=0):
    rng = np.random.default_rng(seed)
    if case == "repeated":  # one point 3,000 times: d+1 runs of 3,000, three pieces each
        return np.tile(rng.normal(size=(1, 1)), (3000, 1)).astype(np.float32)
    n = {1: 600, 3: 400, 11: 200, 18: 120}[case]
    return rng.normal(size=(n, case)).astype(np.float32)


def _geometry(x, dk):
    d = x.shape[1]
    E, a, oh1, oh2 = t_lattice._lattice_constants(d, dk.coeffs, dk.variance, "cpu")
    h1, h2, w = K.geometry_plain(torch.from_numpy(x), E, a)
    return h1, h2, w, oh1, oh2


def _capacity(kind, occupancy):
    return {"untrimmed": None, "occupancy": occupancy, "short": occupancy - 1}[kind]


def _renumber_rows(rows, sigma, live, N):
    """JoinRows whose row sigma[r] holds the run of row r of ``rows`` (r < live); the lists by definition."""
    cnt = rows.cnt.long()
    start = torch.cat([cnt.new_zeros(1), cnt[:-1]])
    order = torch.empty(live, dtype=torch.long)
    order[sigma] = torch.arange(live)  # the old row of each new row
    idx = torch.cat([torch.arange(int(start[r]), int(cnt[r])) for r in order.tolist()] or [torch.zeros(0).long()])
    new_cnt = torch.full_like(rows.cnt, N)
    new_cnt[:live] = torch.cumsum(cnt[order] - start[order], 0).to(torch.int32)
    return K.JoinRows(rows.splat_points[idx], rows.splat_weights[idx], new_cnt, *KC.run_lists(new_cnt, live, N),
                      rows.n_lattice)


def _assert_rows_equal(got, want):
    for name, a, b in zip(K.JoinRows._fields, got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def _assert_lists_by_definition(rows, live, N):
    """The lists the staged scans placed are run_lists' of the same run ends (their definition)."""
    _assert_rows_equal(K.JoinRows(rows.splat_points, rows.splat_weights, rows.cnt, *KC.run_lists(rows.cnt, live, N),
                                  rows.n_lattice), rows)


@pytest.mark.parametrize("capacity", ["untrimmed", "occupancy", "short"])
@pytest.mark.parametrize("case", [1, 3, 11, 18, "repeated"])
def test_staged_route_is_the_plain_plan_and_rows(case, capacity):
    """dedup in a seeded race order, the sort over the key bits only, the runs and the scans' lists:
    torch.equal to join_rows_plain(dedup_neighbors_plain(...)) once renumbered to sorted-hash order."""
    dk = t_kernels.matern_kernel(1.5, 1)
    x = _positions(case)
    h1, h2, w, oh1, oh2 = _geometry(x, dk)
    N = h1.shape[0]
    occ = int(torch.unique(K._pack(h1, h2)).numel())
    cap = _capacity(capacity, occ)
    seg, nb, nl = K.dedup_neighbors_plain(h1, h2, oh1, oh2, cap)
    seg = seg.reshape(w.shape)
    want = K.join_rows_plain(seg, w, nb, nl)
    for seed in (0, 1):
        sseg, snb, snl, srows = plan_rows_staged(h1, h2, w, oh1, oh2, cap, seed)
        M = snb.shape[1]
        assert int(snl) == int(nl) == occ and tuple(snb.shape) == tuple(nb.shape)
        live = min(occ, M)
        _assert_lists_by_definition(srows, live, N)
        if capacity == "short":  # past the capacity no row is numbered: every seg id 0, one run of all N
            assert torch.equal(sseg, seg) and torch.equal(snb, nb) and int(srows.cnt[0]) == N
            _assert_rows_equal(srows, want)
            continue
        sigma = torch.empty(occ, dtype=torch.long)
        sigma[sseg.reshape(-1).long()] = seg.reshape(-1).long()  # race row -> sorted row
        if occ > 8:  # the race numbers the rows otherwise than the sorted keys
            assert not torch.equal(sigma, torch.arange(occ))
        assert torch.equal(sigma[sseg.long()].to(torch.int32), seg)
        moved = torch.full_like(nb, M)
        hit = snb[:, :occ] < M
        moved[:, sigma] = torch.where(hit, sigma[snb[:, :occ].long().clamp(max=occ - 1)], M).to(torch.int32)
        assert torch.equal(moved, nb)
        _assert_rows_equal(_renumber_rows(srows, sigma, live, N), want)
    if case == "repeated":
        assert int(want.n_pieces) >= 3 * (x.shape[1] + 1)


def test_stacked_mixture_rows_staged_equal_the_plain_rows():
    """J = 3 components of M rows, each past its live count empty, every point reduced mod n."""
    x = torch.from_numpy(chain_class_positions())
    mdk = t_kernels.mixture_kernel(1.5, 1, 3)
    plan = t_lattice.build_plan_mixture(x, mdk.alphas, mdk.base.coeffs, mdk.base.variance)
    J, n, dp1 = plan.seg_ids.shape
    M = plan.neighbors.shape[1] // J
    assert J == 3 and bool((plan.live < M).all())
    got = rows_staged(plan.seg_ids, plan.weights, plan.live, M, n, plan.rows.n_lattice)
    _assert_rows_equal(got, plan.rows)
    assert int(got.n_long) > 0 and int(got.n_mid) > 0


@pytest.mark.parametrize("rank", [0, 1])
def test_sharded_rank_rows_staged_equal_the_plain_rows(rank):
    """A rank's contributions over the global plan's live rows (K11a numbers them first): a live row the rank
    does not reach holds an empty run, found by the binary search of the sparse rule."""
    dk = t_kernels.matern_kernel(1.5, 1)
    x = _positions(3, seed=4)
    h1, h2, w, oh1, oh2 = _geometry(x, dk)
    seg_all, nb, nl = K.dedup_ordered_plain(h1, h2, oh1, oh2)
    n_loc, dp1 = x.shape[0] // 2, x.shape[1] + 1
    seg = seg_all[rank * n_loc * dp1:(rank + 1) * n_loc * dp1].reshape(n_loc, dp1)
    wl = w[rank * n_loc:(rank + 1) * n_loc].contiguous()
    want = K.sharded_rows(seg, wl, nl)
    got = rows_staged(seg, wl, nl.reshape(1), int(nl), n_loc, nl, sparse=True)
    assert int(torch.unique(seg).numel()) < int(nl)  # some live rows hold no contribution of this rank
    _assert_rows_equal(got, want)


@pytest.mark.parametrize("k", [4, 10, 15])
@pytest.mark.parametrize("edge", [-1, 0, 1])
def test_key_bits_rule_at_the_power_of_two_edges(k, edge):
    """J M = 2^k - 1, 2^k, 2^k + 1: the sort looks at bit_length(J M - 1) bits, every one of which the
    highest row id needs; the staged rows with the highest row live equal the plain rows, and one bit
    fewer would merge rows.  Every row holds a contribution, as every live row of a built plan does."""
    Mt = (1 << k) + edge
    bits = K.rows_key_bits(Mt)
    assert (Mt - 1) >> bits == 0 and (Mt - 1) >> (bits - 1) == 1
    rng = np.random.default_rng(k)
    dp1 = 3
    extra = rng.integers(0, Mt, size=-Mt % dp1 + 3 * 40)  # every row live, some runs longer
    ids = np.concatenate([np.arange(Mt), extra]).astype(np.int32)
    seg = torch.from_numpy(rng.permutation(ids).reshape(-1, dp1))
    w = torch.from_numpy(rng.uniform(-1, 1, size=seg.shape).astype(np.float32))
    nl = torch.tensor(Mt, dtype=torch.int32)
    got = rows_staged(seg, w, nl.reshape(1), Mt, seg.shape[0], nl)
    _assert_rows_equal(got, K._rows_plain(seg, w, Mt, nl))
    short = torch.sort(seg.reshape(-1) & ((1 << (bits - 1)) - 1), stable=True).indices
    assert not torch.equal(short, torch.sort(seg.reshape(-1), stable=True).indices)


@pytest.mark.parametrize("capacity", ["untrimmed", "occupancy", "short"])
@pytest.mark.parametrize("d", [3, 11])
def test_one_call_builder_is_wide_plan_of_build_plan_join(d, capacity):
    dk = t_kernels.matern_kernel(1.5, 1)
    x = torch.from_numpy(_positions(d, seed=2))
    occ = int(t_lattice.count_lattice_points(x, dk.variance, dk.coeffs))
    cap = _capacity(capacity, occ)
    got = t_lattice.build_wide_plan_join(x, dk.coeffs, dk.variance, cap)
    want = t_lattice.wide_plan(t_lattice.build_plan_join(x, dk.coeffs, dk.variance, cap))
    assert isinstance(got, t_lattice.WidePlan)
    for name in t_lattice.LatticePlan._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    _assert_rows_equal(got.rows, want.rows)


@pytest.mark.parametrize("c", [1, 11, 20])
@pytest.mark.parametrize("order,kind", [(1, "matern"), (2, "rbf")])
def test_k9_through_the_one_call_builder_matches_jax(c, order, kind):
    """K9's plain apply on build_wide_plan_join against JAX's apply_plan_join(build_plan_join(...))."""
    rng = np.random.default_rng(c + 10 * order)
    x = rng.normal(size=(500, 4)).astype(np.float32)
    v = rng.normal(size=(500, c)).astype(np.float32)
    tdk, jdk = ((t_kernels.matern_kernel(1.5, order), j_kernels.matern_kernel(1.5, order)) if kind == "matern"
                else (t_kernels.rbf_kernel(order), j_kernels.rbf_kernel(order)))
    plan = t_lattice.build_wide_plan_join(torch.from_numpy(x), tdk.coeffs, tdk.variance)
    got = t_lattice.apply_plan_rows(plan, torch.from_numpy(v), tdk.coeffs).numpy()
    want = np.asarray(j_lattice.apply_plan_join(j_lattice.build_plan_join(jnp.asarray(x), jdk.coeffs, jdk.variance),
                                                jnp.asarray(v), jdk.coeffs))
    assert rel_err(got, want) < 2e-5


@pytest.mark.parametrize("capacity", [None, "occupancy"])
def test_exact_nlml_gradient_through_the_one_call_builder_matches_jax(monkeypatch, capacity):
    """The exact backward builds its plan and rows by build_wide_plan_join (once, at the CG plan's
    capacity); the NLML and its gradients within test_torch_exact_backward.py's bounds of JAX's."""
    calls = []
    real = t_filter.build_wide_plan_join
    monkeypatch.setattr(t_filter, "build_wide_plan_join", lambda *a, **k: calls.append(a[3:]) or real(*a, **k))
    rng = np.random.default_rng(0)
    n, d = 300, 3
    x = rng.uniform(-2, 2, size=(n, d)).astype(np.float32)
    y = (np.sin(3 * x[:, 0]) + 0.1 * rng.normal(size=n)).astype(np.float32)
    probes = np.random.default_rng(42).choice([-1.0, 1.0], size=(n, 8)).astype(np.float32)
    values = {"inv_ell": np.linspace(0.8, 1.5, d).astype(np.float32), "outputscale": np.float32(0.8),
              "noise": np.float32(0.1), "mean": np.float32(0.05)}
    tdk, jdk = t_kernels.matern_kernel(1.5, 1), j_kernels.matern_kernel(1.5, 1)
    cap = None
    if capacity == "occupancy":
        cap = int(t_lattice.count_lattice_points(torch.from_numpy(x * values["inv_ell"]), tdk.variance, tdk.coeffs))
    kw = dict(cg_tolerance=1.0, max_cg_iterations=300, max_lanczos_iterations=40, num_probes=8, precond_rank=30,
              plan_capacity=cap)
    j_val, j_grad = jax.value_and_grad(
        lambda p: j_mll.lattice_nlml(jdk, j_mll.BBMMConfig(**kw), p, jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(probes)))({k: jnp.asarray(v) for k, v in values.items()})
    params = {k: torch.tensor(v, requires_grad=True) for k, v in values.items()}
    loss = t_mll.lattice_nlml(tdk, t_mll.BBMMConfig(**kw), params, torch.from_numpy(x), torch.from_numpy(y),
                              torch.from_numpy(probes))
    assert calls == []  # the CG runs on the chain plan
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    assert calls == [(cap,)]
    assert abs(float(loss.detach()) - float(j_val)) <= 1e-5
    for k in values:
        assert rel_err(grads[k], j_grad[k]) <= 2e-3, k


def _c_definitions() -> dict:
    """Each ``extern "C"`` function defined (with a body) in csrc: name -> number of parameters."""
    found = {}
    for src in sorted(CSRC.glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)\s*\{', text):
            found[m.group(1)] = len([p for p in m.group(2).split(",") if p.strip()])
    return found


def test_every_bound_entry_point_is_defined_with_its_arity():
    """The ctypes table (kernels/build.py) against the C sources: every bound entry point, the new row
    build and one-call plan included, is defined once with as many parameters as it is given types."""
    defined = _c_definitions()
    for name, argtypes in build._SIGNATURES.items():
        assert defined.get(name) == len(argtypes), (name, defined.get(name), len(argtypes))
    for name in ("sgp_dedup", "sgp_rows_build", "sgp_plan_rows", "sgp_rows_sizes", "sgp_plan_rows_workspace"):
        assert name in build._SIGNATURES
    assert "sgp_join_rows" not in defined  # the rows come from the one row build only
