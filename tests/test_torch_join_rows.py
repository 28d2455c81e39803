"""K9's and K7's row lists (``join_rows``) and their plain versions in the kernels' summation order.

A join plan's row lists hold each row's contributions in contribution
order, each row's run end and the splat's lists of mid rows and long-row
pieces, as the sort chain's plan does (test_torch_chain_plan.py).  They are
checked here against that definition on synthetic runs of 1 .. 3,072
contributions (tests/chain_fixtures.py's run lengths) and on built plans,
untrimmed, trimmed and past their capacity.  The plain K9 and K7 now sum
in the kernels' order (row-order splat, blurs, slice in vertex order):
K9 is the same at every column window, and both stay within rel 1e-6 of
the formulas they replace (K3's plain apply per column; the stacked
filter and four-term combine summed by torch), on the CPU.
"""

import numpy as np
import pytest
import torch
from chain_fixtures import RUN_LENGTHS, chain_class_positions
from torch_parity import rel_err

from simplex_gp_torch.kernels import chain as KC
from simplex_gp_torch.kernels import lattice as K
from simplex_gp_torch.ops import kernels as t_kernels
from simplex_gp_torch.ops import lattice as t_lattice


def _synthetic_plan(lengths, dp1, seed, dead=3):
    """(seg_ids (n, dp1), weights, neighbours (1, M, 2), n_lattice) whose live rows have the given run lengths,
    their contributions scattered over the points in a seeded order; ``dead`` rows past them."""
    rng = np.random.default_rng(seed)
    lengths = list(lengths) + [1] * (-sum(lengths) % dp1)
    seg = rng.permutation(np.repeat(np.arange(len(lengths)), lengths)).astype(np.int32)
    M = len(lengths) + dead
    weights = rng.uniform(-1.0, 1.0, size=seg.shape[0]).astype(np.float32)
    return (torch.from_numpy(seg.reshape(-1, dp1)), torch.from_numpy(weights.reshape(-1, dp1)),
            torch.full((1, M, 2), M, dtype=torch.int32), torch.tensor(len(lengths), dtype=torch.int32))


def _check_against_definition(rows, seg_ids, weights, M, live):
    """Every field of ``rows`` against its definition over the ``live`` rows of a plan of M rows."""
    seg = seg_ids.reshape(-1).numpy()
    w = weights.reshape(-1).numpy()
    dp1, N = seg_ids.shape[1], seg.shape[0]
    cnt = rows.cnt.numpy()
    assert cnt.shape == (M,) and (cnt[live:] == N).all()
    start = 0
    lens = []
    for g in range(live):
        mine = np.nonzero(seg == g)[0]  # the row's contributions, in contribution order
        assert cnt[g] == start + mine.shape[0]
        np.testing.assert_array_equal(rows.splat_points[start:cnt[g]].numpy(), mine // dp1)
        np.testing.assert_array_equal(rows.splat_weights[start:cnt[g]].numpy(), w[mine])
        lens.append(mine.shape[0])
        start = cnt[g]
    assert start == N
    lens = np.array(lens)
    nl, nm, npc = int(rows.n_long), int(rows.n_mid), int(rows.n_pieces)
    long_idx = np.nonzero(lens > KC.PIECE)[0]
    np.testing.assert_array_equal(rows.long_rows[:nl].numpy(), long_idx)
    np.testing.assert_array_equal(rows.mid_rows[:nm].numpy(), np.nonzero((lens > KC.SHORT) & (lens <= KC.PIECE))[0])
    pieces = -(-lens[long_idx] // KC.PIECE)
    assert npc == pieces.sum()
    np.testing.assert_array_equal(rows.long_first[:nl + 1].numpy(), np.concatenate([[0], np.cumsum(pieces)]))
    starts = np.concatenate([[0], cnt[:live - 1]])
    want = [starts[g] + KC.PIECE * np.arange(k) for g, k in zip(long_idx, pieces)]
    np.testing.assert_array_equal(rows.piece_start[:npc].numpy(), np.concatenate(want) if want else [])
    np.testing.assert_array_equal(rows.piece_row[:npc].numpy(), np.repeat(long_idx, pieces))
    assert rows.long_rows.shape[0] == min(M, N // (KC.PIECE + 1))
    assert rows.piece_row.shape[0] == N // KC.PIECE + rows.long_rows.shape[0]
    assert rows.mid_rows.shape[0] == min(M, N // (KC.SHORT + 1))
    return lens


@pytest.mark.parametrize("dp1", [3, 12])
def test_rows_of_synthetic_runs_match_their_definition(dp1):
    """Runs of every class (short, mid, one to three pieces) scattered over the contributions."""
    seg, w, nb, nl = _synthetic_plan(RUN_LENGTHS, dp1, seed=dp1)
    rows = K.join_rows(seg, w, nb, nl)
    lens = _check_against_definition(rows, seg, w, nb.shape[1], int(nl))
    assert (lens > KC.PIECE).any() and ((lens > KC.SHORT) & (lens <= KC.PIECE)).any() and (lens <= KC.SHORT).any()
    assert rows.n_lattice is nl


@pytest.mark.parametrize("capacity", [None, "trim", "over"])
def test_rows_of_built_plans_match_their_definition(capacity):
    """A join plan of clustered and spread points (runs of every class), untrimmed, trimmed, and past its
    capacity (every seg id 0: row 0 holds every contribution, the other rows are empty)."""
    dk = t_kernels.rbf_kernel(1)
    x = torch.from_numpy(chain_class_positions())
    occ = int(t_lattice.count_lattice_points(x, dk.variance))
    cap = {None: None, "trim": occ + 3, "over": occ - 5}[capacity]
    plan = t_lattice.build_plan_join(x, dk.coeffs, dk.variance, cap)
    rows = K.join_rows(*plan)
    M = plan.neighbors.shape[1]
    live = min(int(plan.n_lattice), M)
    lens = _check_against_definition(rows, plan.seg_ids, plan.weights, M, live)
    if capacity == "over":
        assert int(plan.n_lattice) > M and lens[0] == plan.seg_ids.numel() and (lens[1:] == 0).all()
    else:
        assert live == occ and (lens > KC.PIECE).any() and ((lens > KC.SHORT) & (lens <= KC.PIECE)).any()


def test_row_order_splat_is_the_chain_splat_and_a_sum():
    """The splat of a join table in row order: K3'b's plain splat on the row lists, each row the float64 sum of
    its contributions to rel 1e-6, bit-equal between column windows."""
    seg, w, nb, nl = _synthetic_plan(RUN_LENGTHS, 4, seed=1)
    rows = K.join_rows(seg, w, nb, nl)
    v = torch.from_numpy(np.random.default_rng(2).normal(size=(seg.shape[0], 11)).astype(np.float32))
    table = KC.chain_splat_plain(rows, v)
    direct = torch.zeros((nb.shape[1], 11), dtype=torch.float64).index_add_(
        0, seg.reshape(-1).long(), (w[:, :, None].double() * v[:, None, :].double()).reshape(-1, 11))
    assert rel_err(table.numpy(), direct.numpy()) < 1e-6
    assert torch.equal(torch.cat([KC.chain_splat_plain(rows, v[:, :8]), KC.chain_splat_plain(rows, v[:, 8:])], 1),
                       table)


def _plan(n, d, kind, order, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=(n, d)) * (0.3 if d >= 9 else 1.0)).astype(np.float32))
    dk = t_kernels.rbf_kernel(order) if kind == "rbf" else t_kernels.matern_kernel(1.5, order)
    return x, dk, rng


@pytest.mark.parametrize("capacity", [None, "occupancy"])
@pytest.mark.parametrize("n,d,order,kind", [(600, 3, 1, "rbf"), (300, 5, 2, "matern"), (200, 17, 1, "rbf")])
def test_plain_k9_is_the_same_at_every_window_and_near_the_old_formula(n, d, order, kind, capacity):
    """The plain K9 at windows of 8, 16 and 32 columns, bit for bit, at c = 101; within rel 1e-6 of K3's plain
    apply (the formula the plain K9 used: JAX's per-block apply, the same per column), and given its row
    lists or not."""
    x, dk, rng = _plan(n, d, kind, order, seed=n + d)
    cap = None if capacity is None else int(t_lattice.count_lattice_points(x, dk.variance))
    plan = t_lattice.build_plan_join(x, dk.coeffs, dk.variance, cap)
    v = torch.from_numpy(rng.normal(size=(n, 101)).astype(np.float32))
    taps, norm = list(dk.coeffs), t_lattice.SLICE_NORM(d)
    rows = K.join_rows(*plan)
    outs = [K.apply_cols_plain(*plan, v, taps, norm, chunk, rows) for chunk in (8, 16, 32)]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    assert torch.equal(K.lattice_apply_cols(*plan, v, taps, norm, 8), outs[0])  # the CPU wrapper builds its rows
    old = K.apply_plain(plan.seg_ids, plan.weights, plan.neighbors, v, taps, norm, n_lattice=plan.n_lattice)
    assert rel_err(outs[0].numpy(), old.numpy()) < 1e-6


def test_plain_k9_guard_past_the_capacity():
    x, dk, rng = _plan(600, 3, "rbf", 1, seed=5)
    occ = int(t_lattice.count_lattice_points(x, dk.variance))
    plan = t_lattice.build_plan_join(x, dk.coeffs, dk.variance, occ - 1)
    out = K.apply_cols_plain(*plan, torch.from_numpy(rng.normal(size=(600, 20)).astype(np.float32)),
                             list(dk.coeffs), t_lattice.SLICE_NORM(3), 8)
    assert out.shape == (600, 20) and bool(torch.isnan(out).all())


def _old_deriv_grad(seg_ids, weights, neighbors, ref, src, g, taps, slice_norm, scale):
    """K7's plain formula before the row-order splat: K3's plain apply of the stack, the combine by torch."""
    n, L = src.shape
    d = ref.shape[1]
    gf = g[:, :, None] * ref[:, None, :]
    sf = src[:, :, None] * ref[:, None, :]
    stacked = torch.cat([g, gf.reshape(n, L * d), src, sf.reshape(n, L * d)], dim=-1)
    f = K.apply_plain(seg_ids, weights, neighbors, stacked, taps, slice_norm)
    wg, wgf = f[:, :L], f[:, L:L + L * d].reshape(n, L, d)
    ws, wsf = f[:, L + L * d:2 * L + L * d], f[:, 2 * L + L * d:].reshape(n, L, d)
    return scale * (sf * wg[:, :, None] - src[:, :, None] * wgf + gf * ws[:, :, None] - g[:, :, None] * wsf).sum(1)


@pytest.mark.parametrize("n,d,L,kind,order", [(300, 3, 2, "rbf", 1), (300, 5, 11, "matern", 1),
                                              (150, 9, 3, "matern", 2), (64, 17, 2, "rbf", 1)])
def test_plain_k7_is_near_the_old_formula(n, d, L, kind, order):
    """The plain K7 in the kernel's order within rel 1e-6 of its former formula; the CPU wrapper is it."""
    x, dk, rng = _plan(n, d, kind, order, seed=n * d)
    src, g = (torch.from_numpy(rng.normal(size=(n, L)).astype(np.float32)) for _ in range(2))
    plan = t_lattice.build_plan_join(x, dk.deriv_coeffs, dk.deriv_variance)
    args = (list(dk.deriv_coeffs), t_lattice.SLICE_NORM(d), 2.0 * dk.dk0)
    new = K.deriv_grad_plain(plan.seg_ids, plan.weights, plan.neighbors, x, src, g, *args)
    assert torch.equal(K.lattice_deriv_grad(*plan, x, src, g, *args), new)
    old = _old_deriv_grad(plan.seg_ids, plan.weights, plan.neighbors, x, src, g, *args)
    assert rel_err(new.numpy(), old.numpy()) < 1e-6
