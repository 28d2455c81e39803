"""K12's row lists (``mixture_rows``) and its plain twin in the kernels' summation order, on the CPU.

The stacked mixture plan carries the row lists of its J M rows, built once
with the plan: every row's run of contributions in contribution order (a
row past its component's live count has an empty run), each contribution's
point reduced to its point of the n, and the splat's lists of mid rows and
long-row pieces.  They are checked here against that definition on
synthetic stacked runs of every class (1 .. 3,072 contributions, a
component with no live row) and on built plans, and one component's lists
against a join plan's.  The plain K12 sums in the kernels' order (K3'b's
splat of each stacked row, the blurs, the slice in vertex and component
order), so it is held within rel 1e-6 of the formula it replaces (an
``index_add_`` splat, torch's sums; float32 sums of the same terms in
another order) at c = 1, 11, 17 and 100, forward and transposed, with its
table; against JAX the existing parity tests hold it (test_torch_mixture.py).
"""

import numpy as np
import pytest
import torch
from chain_fixtures import RUN_LENGTHS, synthetic_mixture_plan
from torch_parity import rel_err

from simplex_gp_torch.kernels import chain as KC
from simplex_gp_torch.kernels import lattice as K
from simplex_gp_torch.kernels import mixture as KM
from simplex_gp_torch.linalg import mll as t_mll
from simplex_gp_torch.ops import filter as t_filter
from simplex_gp_torch.ops import kernels as t_kernels
from simplex_gp_torch.ops import lattice as t_lattice


def _index_add_formula(seg_ids, weights, neighbors, v, taps, slice_norm, mix_weights, transpose):
    """K12's formula before the row lists: an index_add_ splat into the stacked table, the d+1 blurs, torch's
    sum over the vertices, the weighted sum of the components."""
    J, n, dp1 = seg_ids.shape
    c = v.shape[-1]
    contrib = (v[None, :, None, :] * weights[..., None]).reshape(J * n * dp1, c)
    table = torch.zeros((neighbors.shape[1], c)).index_add_(0, seg_ids.reshape(-1).long(), contrib)
    table = K._blur_plain(table, KM._global_neighbors(neighbors, J), taps, transpose)
    per_comp = (table[seg_ids.long()] * weights[..., None]).sum(dim=2) * slice_norm
    return sum(w * per_comp[j] for j, w in enumerate(mix_weights)), table


def _check_against_definition(rows, seg_ids, weights):
    """Every field of a stacked plan's ``rows`` against its definition over all J M rows; returns the run
    lengths."""
    J, n, dp1 = seg_ids.shape
    seg, w = seg_ids.reshape(-1).numpy(), weights.reshape(-1).numpy()
    JM, N = rows.cnt.shape[0], seg.shape[0]
    order = np.argsort(seg, kind="stable")
    np.testing.assert_array_equal(rows.cnt.numpy(), np.searchsorted(seg[order], np.arange(JM), side="right"))
    np.testing.assert_array_equal(rows.splat_points.numpy(), order // dp1 % n)
    np.testing.assert_array_equal(rows.splat_weights.numpy(), w[order])
    lens = np.diff(np.concatenate([[0], rows.cnt.numpy()]))
    long_idx = np.nonzero(lens > KC.PIECE)[0]
    nl, nm, npc = int(rows.n_long), int(rows.n_mid), int(rows.n_pieces)
    np.testing.assert_array_equal(rows.long_rows[:nl].numpy(), long_idx)
    np.testing.assert_array_equal(rows.mid_rows[:nm].numpy(), np.nonzero((lens > KC.SHORT) & (lens <= KC.PIECE))[0])
    pieces = -(-lens[long_idx] // KC.PIECE)
    assert npc == pieces.sum()
    np.testing.assert_array_equal(rows.long_first[:nl + 1].numpy(), np.concatenate([[0], np.cumsum(pieces)]))
    starts = rows.cnt.numpy()[long_idx] - lens[long_idx]
    want = [s + KC.PIECE * np.arange(k) for s, k in zip(starts, pieces)]
    np.testing.assert_array_equal(rows.piece_start[:npc].numpy(), np.concatenate(want) if want else [])
    assert int(rows.n_lattice) == JM and rows.cnt[-1] == N
    return lens


# Component 1 has no live row; runs of every class in the others.
STACKED = [RUN_LENGTHS[:11], [], RUN_LENGTHS[11:]]


@pytest.mark.parametrize("dp1", [3, 12])
def test_stacked_rows_of_synthetic_runs_match_their_definition(dp1):
    """Runs of every class over three components, one of them without a live row."""
    seg, w, nb, live = synthetic_mixture_plan(STACKED, n=-(-sum(map(sum, STACKED)) // (3 * dp1)) + 2, dp1=dp1,
                                              seed=dp1)
    rows = KM.mixture_rows(seg, w, nb, live)
    lens = _check_against_definition(rows, seg, w)
    M = nb.shape[1] // 3
    assert (lens[M:2 * M] == 0).all() and int(live[1]) == 0
    assert (lens > KC.PIECE).any() and ((lens > KC.SHORT) & (lens <= KC.PIECE)).any() and (lens <= KC.SHORT).any()


def _positions(n, d, seed):
    """Clustered and spread points: at alpha = 0.25 the tight cluster puts runs past 1,024 into few rows."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([0.05 * rng.normal(size=(n // 2, d)), 2.0 * rng.normal(size=(n - n // 2, d))])
    return torch.from_numpy(x.astype(np.float32))


def test_stacked_rows_of_a_built_plan_match_their_definition():
    """The plan's own rows (built with it), on a J = 8 plan with runs of every class."""
    mk = t_kernels.mixture_kernel(1.5, 1, 8)
    plan = t_lattice.build_plan_mixture(_positions(2400, 2, 1), mk.alphas, mk.base.coeffs, mk.base.variance)
    lens = _check_against_definition(plan.rows, plan.seg_ids, plan.weights)
    assert (lens > KC.PIECE).any() and ((lens > KC.SHORT) & (lens <= KC.PIECE)).any() and (lens <= KC.SHORT).any()
    M = plan.neighbors.shape[1] // 8
    for j, lj in enumerate(plan.live.tolist()):  # a component's rows past its live count hold nothing
        assert (lens[j * M:j * M + lj] > 0).all() and (lens[j * M + lj:(j + 1) * M] == 0).all()


def test_one_component_rows_are_the_join_rows():
    """J = 1: the stacked rows are the join plan's row lists of that component, count aside."""
    mk = t_kernels.mixture_kernel(1.5, 1, 1)
    plan = t_lattice.build_plan_mixture(_positions(600, 3, 2), mk.alphas, mk.base.coeffs, mk.base.variance)
    comp = t_lattice.mixture_component(plan, 0)
    join = K.join_rows(*comp)
    for name in K.JoinRows._fields:
        if name != "n_lattice":
            assert torch.equal(getattr(plan.rows, name), getattr(join, name)), name
    assert int(plan.rows.n_lattice) == plan.neighbors.shape[1] and int(join.n_lattice) == int(plan.live[0])


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("c", [1, 11, 17, 100])
def test_plain_k12_is_near_the_index_add_formula(c, transpose):
    """The plain K12 in the kernels' order against the formula it replaced, output and stacked table."""
    mk = t_kernels.mixture_kernel(1.5, 1, 8)
    n, d = 1200, 3
    plan = t_lattice.build_plan_mixture(_positions(n, d, 3), mk.alphas, mk.base.coeffs, mk.base.variance)
    assert int(plan.rows.n_long) > 0 and int(plan.rows.n_mid) > 0
    v = torch.from_numpy(np.random.default_rng(c).normal(size=(n, c)).astype(np.float32))
    args = (plan.seg_ids, plan.weights, plan.neighbors, v, list(mk.base.coeffs), t_lattice.SLICE_NORM(d), mk.weights)
    out, table = KM.mixture_apply_plain(*args, transpose, True, plan.rows)
    want, want_table = _index_add_formula(*args, transpose)
    assert rel_err(out.numpy(), want.numpy()) < 1e-6
    assert rel_err(table.numpy(), want_table.numpy()) < 1e-6
    assert torch.equal(KM.mixture_apply_plain(*args, transpose, False), out)  # the rows built inside: the same


@pytest.mark.parametrize("c", [1, 11, 17])
def test_plain_k12_on_synthetic_runs_is_near_the_index_add_formula(c):
    """Synthetic stacked runs of every class, a component without a live row: the same operator."""
    seg, w, nb, live = synthetic_mixture_plan(STACKED, n=900, dp1=4, seed=c)
    v = torch.from_numpy(np.random.default_rng(c).normal(size=(900, c)).astype(np.float32))
    args = (seg, w, nb, v, [0.5, 1.0, 0.5], 0.7, (0.4, 1.3, 0.8))
    for transpose in (False, True):
        out, table = KM.lattice_mixture_apply(seg, w, nb, live, v, *args[4:], transpose, True)
        want, want_table = _index_add_formula(*args, transpose)
        assert rel_err(out.numpy(), want.numpy()) < 1e-6 and rel_err(table.numpy(), want_table.numpy()) < 1e-6


def test_two_cpu_applies_are_bit_equal():
    mk = t_kernels.mixture_kernel(1.5, 1, 8)
    plan = t_lattice.build_plan_mixture(_positions(500, 4, 4), mk.alphas, mk.base.coeffs, mk.base.variance)
    v = torch.from_numpy(np.random.default_rng(5).normal(size=(500, 11)).astype(np.float32))
    a = t_lattice.apply_plan_mixture(plan, v, mk.base.coeffs, mk.weights)
    assert torch.equal(a, t_lattice.apply_plan_mixture(plan, v, mk.base.coeffs, mk.weights))


def test_one_row_build_serves_the_nlml_and_its_gradient(monkeypatch):
    """The NLML's CG and its backward run on the CG's J chain plans, one a component, built once (their run
    lists built with them) and read by the CG's applies, the backward's forward applies with their tables
    and its transposed applies: no stacked plan and no stacked row lists are built."""
    rows_calls, chain_calls = [], []
    real_rows, real_chain = t_lattice.mixture_rows, t_filter.build_plan

    def spy(*args):
        rows_calls.append(args[0].shape)
        return real_rows(*args)

    monkeypatch.setattr(t_lattice, "mixture_rows", spy)
    monkeypatch.setattr(t_filter, "build_plan", lambda *a, **k: chain_calls.append(a[0].shape) or real_chain(*a, **k))
    n, d = 300, 4
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    y = torch.from_numpy(np.sin(x[:, 0].numpy()) + 0.1 * rng.normal(size=n).astype(np.float32))
    mk = t_kernels.mixture_kernel(1.5, 1, 6)
    params = {"inv_ell": torch.full((d,), 0.8, requires_grad=True), "outputscale": torch.tensor(1.0),
              "noise": torch.tensor(0.1)}
    probes = torch.from_numpy(rng.choice([-1.0, 1.0], size=(n, 8)).astype(np.float32))
    cfg = t_mll.BBMMConfig(cg_tolerance=1.0, num_probes=8, precond_rank=20)
    loss = t_mll.lattice_nlml(mk, cfg, params, x, y, probes)
    assert chain_calls == [(n, d)] * 6
    loss.backward()
    assert chain_calls == [(n, d)] * 6 and rows_calls == []
    assert torch.isfinite(params["inv_ell"].grad).all()
