"""Each hand-written CUDA kernel against its plain PyTorch version, on the card.

These tests need a CUDA device and the CUDA toolkit; without a card they
skip (decided at run time by the ``cuda_device`` fixture).  They import no
jax, so they run where the port runs:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda

Tolerances: K1 runs the plain version's IEEE operations in its order, so
hashes and weights are equal; K3's splat adds with atomics in a run-to-run
order (rel 1e-5), transposed or not; K5 sums its dots (a team of lanes and
an xor butterfly) and the E product in its plain version's order, so fed
the same tables the two are equal bit for bit, at both team widths and at
d+1 past 32; K6 sums d2 and L.l_piv in another order
than torch's reductions (rel 1e-5 for one step).  K4 is K3's operator with
the same atomic splat (rel 1e-5), and its occupancy and K8's count are
exact.  K9 and K7 run on a join plan's row lists (``join_rows``, built
bit for bit as their plain version builds them) with the sort chain's
row-order splat, no atomics, a blur over the live rows and a slice in
vertex order, each in its plain version's order: both equal their plain
versions and a second run bit for bit (K9 at windows of 8, 16 and 32
columns, against the unchunked K3 rel 1e-5).
The bounded K2 numbers its rows as it likes but gives the plain version's
occupancy, and K3 on it the plain operator (rel 1e-5); one row short of
the occupancy, every output is NaN and no launch leaves its table.  K2 and
its row lists from one host call (``lattice_plan_rows``): the rows equal
their plain build on the same plan bit for bit, and K9 on them equals K9's
plain version on the plain plan bit for bit (the numbering reaches no
output bit); the row build equals its plain version at J M = 2^k - 1, 2^k
and 2^k + 1, the edges of the bits its radix sort reads.
K11a numbers its rows as its plain version does, bit for bit; K11b is K3's
splat, blur and slice over column blocks (on one rank, it, its plain version
and K3 each within rel 2e-5 of the operator in float64; over two gloo ranks
sharing the card, rel 1e-5 against the plain version and K3); K6' with the pivot's rows passed in is K6's
arithmetic, bit for bit.  K12, the stacked mixture apply, runs on the
stacked plan's row lists (``mixture_rows``, bit for bit its plain build):
K3'b's row-order splat, the live-row blur of each component and the
weighted slice, each in its plain version's order, so it equals its plain
version and a second run bit for bit (forward and transposed, outputs and
the read rows of its table, at c = 1, 11 and 100, on built plans and on
synthetic runs of every class with a component without live rows), and two
mixture NLML gradients repeat bit for bit; the mixture position gradient
is K5 on the stacked problem (rel 1e-4).  The elevators-shaped
posterior_cache (its range sketch on K9's row lists, no K3) repeats bit
for bit.  K3', the sort chain, has no atomics in its arithmetic: its build
(a hash dedup of the contributions, a sort of the distinct points, a stable
sort of the ranks) is the plain build bit for bit, also on one point
repeated, duplicated rows, d = 1 and 18 and past the capacity, its
splat sums each row in the order its plain version does, and its axis
stencils and slice use the plain version's IEEE operations in their order,
so the applies are bit-equal too, and two builds or two applies repeat
bit for bit; against K3 it takes the chain-vs-join bound, rel 2e-5.  K3'b is
held bit for bit on runs of every length class (short, mid, long),
across column tiles, and on a plan past 4M contributions.  K8's count is exact on a hot key set, all keys
distinct, a ragged last block and d = 1, 11, 18.  The
Snelson gate (test_torch_snelson.py's prediction test) runs on the card
too, through the kernels.
K3'd, the slice, sums each point's vertices in its plain version's order
from slabs staged in shared memory: torch.equal to its twin and a second
call at the compiled d+1 (12, 19) and the generic path, off 16-byte
boundaries and inside chain_apply.  K13c sums over rows in stages and
chunks: rel 1e-5 to its plain version (float32 sums in another order) and
bit-equal to a second call at its stage and chunk edges.
Positions at d >= 9 are scaled by 0.3, so the kernel reaches between points
and the gradients are not roundoff.
"""

import types

import numpy as np
import pytest
import torch
from chain_fixtures import (RUN_LENGTHS, chain_class_positions, colliding_inputs, synthetic_chain_plan,
                            synthetic_mixture_plan)
from torch_parity import cuda_device, seeded  # noqa: F401 (fixture)

from simplex_gp_torch.kernels import chain as KC
from simplex_gp_torch.kernels import lattice as K
from simplex_gp_torch.kernels import mixture as KM
from simplex_gp_torch.kernels import pivot as KP
from simplex_gp_torch.kernels.pivot import pivot_column, pivot_column_plain
from simplex_gp_torch.ops import filter as t_filter
from simplex_gp_torch.ops import kernels as t_kernels
from simplex_gp_torch.ops import lattice as t_lattice

pytestmark = pytest.mark.cuda

GRID = [(200, 1, 1, "rbf"), (300, 3, 1, "rbf"), (257, 5, 2, "rbf"), (150, 2, 3, "matern"),
        (400, 9, 1, "matern"), (64, 17, 1, "rbf"), (16599, 17, 1, "rbf")]


# K11b (a fixed order) and K3 (float32 atomics) against the operator in float64.  Measured on an H100 at the
# widest case (16,599 x 17) by `simplex_gp_torch/kernel_times.py --sharded-f64`, 1,800 comparisons at
# c = 1: median 1.5e-6, 99th percentile 6.8e-6, max 1.13e-5; at c = 11 at most 3.5e-6.  Two of the
# splats compared with each other reached 1.19e-5 there.  The bound is the chain-vs-join bound that
# chip_smoke.py holds K3 to against the same float64 operator (LARGE_N_REL).
SHARDED_F64_REL = 2e-5

def _dk(kind, order):
    return t_kernels.rbf_kernel(order) if kind == "rbf" else t_kernels.matern_kernel(1.5, order)


@pytest.mark.parametrize("d", [1, 3, 11, 18, 40])
def test_geometry_team_kernel_equals_plain_and_the_per_thread_kernel(cuda_device, d):
    """K1's team of lanes a point: h1, h2, w and s torch.equal to the plain twin and to the first kernel, a
    thread a point, on 3,001 points (the last block short), in each of the three team shapes (d+1 <= 16, 32,
    64)."""
    x, _ = seeded(3001, d, 1)
    xg = torch.from_numpy(x).to(cuda_device) * 2.0
    a = torch.from_numpy(t_lattice._hash_vectors(d)).to(cuda_device)
    E = torch.from_numpy(t_lattice.build_rotation(d, 1.0)).to(cuda_device)
    team = K.lattice_geometry(xg, E, a, with_s=True)
    thread = K._geometry_per_thread(xg, E, a, with_s=True)
    plain = K.geometry_plain(xg, E, a, with_s=True)
    for u, v, w in zip(team, thread, plain):
        assert torch.equal(u.reshape(-1), v.reshape(-1)) and torch.equal(u.reshape(-1), w.reshape(-1))


@pytest.mark.parametrize("n,d,order,kind", GRID)
def test_kernels_match_plain(cuda_device, n, d, order, kind):
    x, _ = seeded(n, d, 1)
    dk = _dk(kind, order)
    xg = torch.from_numpy(x).to(cuda_device)
    a = torch.from_numpy(t_lattice._hash_vectors(d)).to(cuda_device)
    E = torch.from_numpy(t_lattice.build_rotation(d, dk.variance)).to(cuda_device)
    kh1, kh2, kw = K.lattice_geometry(xg, E, a)
    ph1, ph2, pw = K.geometry_plain(xg, E, a)
    assert torch.equal(kh1, ph1) and torch.equal(kh2, ph2)
    assert float((kw - pw).abs().max()) <= 1e-6

    oh1, oh2 = (torch.from_numpy(o).to(cuda_device)
                for o in t_lattice._offset_hashes(d, order, t_lattice._hash_vectors(d)))
    kseg, knb, knl = K.lattice_dedup_neighbors(kh1, kh2, oh1, oh2)
    pseg, pnb, pnl = K.dedup_neighbors_plain(ph1, ph2, oh1, oh2)
    assert int(knl) == int(pnl)
    for c in (1, 8, 101):
        v = torch.randn((n, c), generator=torch.Generator(device=cuda_device).manual_seed(c),
                        device=cuda_device)
        norm = t_lattice.SLICE_NORM(d)
        kout = K.lattice_apply(kseg.reshape(n, d + 1), kw, knb, knl, v, dk.coeffs, norm)
        pout = K.apply_plain(pseg.reshape(n, d + 1), pw, pnb, v, dk.coeffs, norm)
        torch.cuda.synchronize()
        assert float((kout - pout).norm() / pout.norm()) < 1e-5


@pytest.mark.parametrize("nu", [0.0, 0.5, 1.5, 2.5])
def test_pivot_column_matches_plain(cuda_device, nu):
    n, k = 3000, 40
    ref = torch.from_numpy(seeded(n, 5, 1, seed=3)[0]).to(cuda_device)
    s = torch.tensor(1.3, device=cuda_device)
    diag = s * torch.ones(n, device=cuda_device)
    d0 = diag.max()
    L = torch.zeros((n, k), device=cuda_device)
    piv = torch.zeros(k, dtype=torch.int64, device=cuda_device)
    for j in range(k - 1):  # the plain version builds the state before the last step
        diag = pivot_column_plain(ref, L, diag, torch.argmax(diag), j, s, d0, nu, piv)
    p = torch.argmax(diag)
    La, Lb, pa, pb = L.clone(), L.clone(), piv.clone(), piv.clone()
    da = pivot_column(ref, La, diag, p, k - 1, s, d0, nu, pa)
    db = pivot_column_plain(ref, Lb, diag, p, k - 1, s, d0, nu, pb)
    torch.cuda.synchronize()
    assert torch.equal(pa, pb)
    assert float((La - Lb).norm() / Lb.norm()) < 1e-5
    assert float((da - db).norm() / db.norm()) < 1e-5


def test_wrappers_refuse_wrong_inputs(cuda_device):
    x = torch.zeros((10, 3), dtype=torch.float64, device=cuda_device)
    E = torch.zeros((4, 3), device=cuda_device)
    a = torch.zeros((2, 3), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        K.lattice_geometry(x, E, a)
    ref = torch.zeros((10, 3), device=cuda_device)
    L = torch.zeros((10, 4), device=cuda_device)
    diag, s = torch.ones(10, device=cuda_device), torch.tensor(1.0, device=cuda_device)
    piv = torch.zeros(4, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        pivot_column(ref, L, diag, torch.argmax(diag), 0, s, s, 1.0, piv)


@pytest.mark.parametrize("c", [1, 11])
@pytest.mark.parametrize("n,d,order,kind", GRID)
def test_transposed_apply_and_filter_grad_match_plain(cuda_device, n, d, order, kind, c):
    x, _ = seeded(n, d, 1, seed=5)
    dk = _dk(kind, order)
    ref = torch.from_numpy(x).to(cuda_device)
    plan = t_lattice.build_plan_join(ref, dk.coeffs, dk.variance)
    gen = torch.Generator(device=cuda_device).manual_seed(c)
    v = torch.randn((n, c), generator=gen, device=cuda_device)
    g = torch.randn((n, c), generator=gen, device=cuda_device)
    seg, w, nb, nl = plan
    norm = t_lattice.SLICE_NORM(d)
    E = torch.from_numpy(t_lattice.build_rotation(d, dk.variance)).to(cuda_device)
    _, tf_k = K.lattice_apply(seg, w, nb, nl, v, dk.coeffs, norm, return_table=True)
    gs_k, tb_k = K.lattice_apply(seg, w, nb, nl, g, dk.coeffs, norm, transpose=True, return_table=True)
    _, tf_p = K.apply_plain(seg, w, nb, v, dk.coeffs, norm, return_table=True)
    gs_p, tb_p = K.apply_plain(seg, w, nb, g, dk.coeffs, norm, transpose=True, return_table=True)
    rows = seg.long()  # the rows that are read; rows past n_lattice are undefined in the kernel's table
    for a, b in ((tf_k[rows], tf_p[rows]), (tb_k[rows], tb_p[rows]), (gs_k, gs_p)):
        assert float((a - b).norm() / b.norm()) < 1e-5
    before = K.lattice_filter_grad.launches
    gr_k = K.lattice_filter_grad(ref, E, seg, v, g, tf_k, tb_k, norm)
    gr_p = K.lattice_filter_grad_plain(ref, E, seg, v, g, tf_k, tb_k, norm)
    torch.cuda.synchronize()
    assert K.lattice_filter_grad.launches == before + 1
    assert torch.equal(gr_k, gr_p)


def test_filter_grad_refuses_wrong_inputs(cuda_device):
    ref = torch.zeros((10, 3), device=cuda_device)
    E = torch.zeros((4, 3), device=cuda_device)
    seg = torch.zeros((10, 4), dtype=torch.int64, device=cuda_device)
    v = torch.zeros((10, 2), device=cuda_device)
    table = torch.zeros((40, 2), device=cuda_device)
    with pytest.raises(ValueError):
        K.lattice_filter_grad(ref, E, seg, v, v, table, table, 1.0)


def _positions(n, d, seed, device):
    x, _ = seeded(n, d, 1, seed=seed)
    return (torch.from_numpy(x) * (1.0 if d < 9 else 0.3)).to(device)


@pytest.mark.parametrize("c", [1, 11])
@pytest.mark.parametrize("n,d,order,kind", GRID)
def test_filter_once_and_count_match_plain(cuda_device, n, d, order, kind, c):
    dk = _dk(kind, order)
    x = _positions(n, d, 6, cuda_device)
    E, a, oh1, oh2 = t_lattice._lattice_constants(d, dk.coeffs, dk.variance, cuda_device)
    v = torch.randn((n, c), generator=torch.Generator(device=cuda_device).manual_seed(c), device=cuda_device)
    norm = t_lattice.SLICE_NORM(d)
    before = (K.lattice_filter_once.launches, K.lattice_count.launches)
    kout, knl = K.lattice_filter_once(x, E, a, oh1, oh2, v, dk.coeffs, norm, n * (d + 1))
    pout, pnl = K.filter_once_plain(x, E, a, oh1, oh2, v, dk.coeffs, norm, n * (d + 1))
    count = K.lattice_count(x, E, a)
    torch.cuda.synchronize()
    nl = int(pnl)
    assert int(knl) == nl and int(count) == nl and int(K.count_plain(x, E, a)) == nl
    assert torch.equal(kout, pout)  # no atomics, and the rows' numbering does not reach the output
    exact_fit, fit_nl = K.lattice_filter_once(x, E, a, oh1, oh2, v, dk.coeffs, norm, nl)
    assert int(fit_nl) == nl and torch.equal(exact_fit, pout)
    if nl >= 2:
        under, under_nl = K.lattice_filter_once(x, E, a, oh1, oh2, v, dk.coeffs, norm, nl - 1)
        torch.cuda.synchronize()
        assert bool(torch.isnan(under).all()) and int(under_nl) > nl - 1
    assert K.lattice_count.launches == before[1] + 1
    assert K.lattice_filter_once.launches == before[0] + (3 if nl >= 2 else 2)


@pytest.mark.parametrize("L", [1, 11])
@pytest.mark.parametrize("n,d,order,kind", GRID)
def test_deriv_grad_matches_plain(cuda_device, n, d, order, kind, L):
    dk = _dk(kind, order)
    ref = _positions(n, d, 7, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(L)
    src = torch.randn((n, L), generator=gen, device=cuda_device)
    g = torch.randn((n, L), generator=gen, device=cuda_device)
    plan = t_lattice.build_plan_join(ref, dk.deriv_coeffs, dk.deriv_variance)
    norm, scale = t_lattice.SLICE_NORM(d), 2.0 * dk.dk0
    before = K.lattice_deriv_grad.launches
    gk = K.lattice_deriv_grad(*plan, ref, src, g, dk.deriv_coeffs, norm, scale)
    again = K.lattice_deriv_grad(*plan, ref, src, g, dk.deriv_coeffs, norm, scale)
    gp = K.deriv_grad_plain(plan.seg_ids, plan.weights, plan.neighbors, ref, src, g, dk.deriv_coeffs, norm,
                            scale)
    torch.cuda.synchronize()
    assert K.lattice_deriv_grad.launches == before + 2
    assert float((gk - gp).norm() / gp.norm()) < 1e-4
    assert torch.equal(gk, gp) and torch.equal(again, gk)


def test_one_shot_wrappers_refuse_wrong_inputs(cuda_device):
    dk = _dk("rbf", 1)
    x = torch.zeros((10, 3), device=cuda_device)
    E, a, oh1, oh2 = t_lattice._lattice_constants(3, dk.coeffs, dk.variance, cuda_device)
    v = torch.zeros((10, 2), device=cuda_device)
    with pytest.raises(ValueError):
        K.lattice_filter_once(x, E, a, oh1, oh2, v, dk.coeffs, 1.0, 0)  # capacity below 1
    with pytest.raises(ValueError):
        K.lattice_filter_once(x, E, a, oh1, oh2, v.double(), dk.coeffs, 1.0, 40)
    with pytest.raises(ValueError):
        K.lattice_count(x.double(), E, a)
    plan = t_lattice.build_plan_join(x, dk.deriv_coeffs, dk.deriv_variance)
    with pytest.raises(ValueError):
        K.lattice_deriv_grad(plan.seg_ids.long(), *plan[1:], x, v, v, dk.deriv_coeffs, 1.0, -2.0)


@pytest.mark.parametrize("c", [8, 20, 101])
@pytest.mark.parametrize("n,d,order,kind", GRID)
def test_apply_cols_matches_plain_and_the_unchunked_apply(cuda_device, n, d, order, kind, c):
    dk = _dk(kind, order)
    x = _positions(n, d, 8, cuda_device)
    plan = t_lattice.build_plan_join(x, dk.coeffs, dk.variance)
    v = torch.randn((n, c), generator=torch.Generator(device=cuda_device).manual_seed(c), device=cuda_device)
    norm = t_lattice.SLICE_NORM(d)
    before = K.lattice_apply_cols.launches
    kout = K.lattice_apply_cols(*plan, v, dk.coeffs, norm, 8)
    pout = K.apply_cols_plain(*plan, v, dk.coeffs, norm, 8)
    whole = K.lattice_apply(*plan, v, dk.coeffs, norm)
    rows = K.join_rows(*plan)
    windows = [K.lattice_apply_cols(*plan, v, dk.coeffs, norm, chunk, rows) for chunk in (8, 16, 32)]
    torch.cuda.synchronize()
    assert K.lattice_apply_cols.launches == before + 4
    assert float((kout - pout).norm() / pout.norm()) < 1e-5
    assert float((kout - whole).norm() / whole.norm()) < 1e-5
    assert torch.equal(kout, pout) and all(torch.equal(w, kout) for w in windows)


@pytest.mark.parametrize("capacity", [None, "trim", "over"])
def test_join_rows_match_plain_bit_for_bit(cuda_device, capacity):
    """K9's and K7's row lists against their plain build, every field, on a join plan with runs of every class
    (untrimmed, trimmed, past the capacity) and on the run lengths 1 .. 3,072; two builds repeat."""
    dk = _dk("rbf", 1)
    x = torch.from_numpy(chain_class_positions()).to(cuda_device)
    occ = int(t_lattice.count_lattice_points(x, dk.variance))
    cap = {None: None, "trim": occ + 3, "over": occ - 5}[capacity]
    plan = t_lattice.build_plan_join(x, dk.coeffs, dk.variance, cap)
    rng = np.random.default_rng(7)
    seg = rng.permutation(np.repeat(np.arange(len(RUN_LENGTHS)), RUN_LENGTHS)).astype(np.int32)
    seg = np.concatenate([seg, np.arange(-len(seg) % 4, dtype=np.int32)])
    synth = (torch.from_numpy(seg.reshape(-1, 4)).to(cuda_device),
             torch.from_numpy(rng.uniform(-1, 1, size=(len(seg) // 4, 4)).astype(np.float32)).to(cuda_device),
             torch.full((1, len(RUN_LENGTHS) + 3, 2), len(RUN_LENGTHS) + 3, dtype=torch.int32, device=cuda_device),
             torch.tensor(len(RUN_LENGTHS), dtype=torch.int32, device=cuda_device))
    for p in (tuple(plan), synth):
        before = K.join_rows.launches
        got, again, want = K.join_rows(*p), K.join_rows(*p), K.join_rows_plain(*p)
        torch.cuda.synchronize()
        assert K.join_rows.launches == before + 2
        for name, a, b, c in zip(K.JoinRows._fields, got, again, want):
            assert torch.equal(a, b) and torch.equal(a, c), name
    assert int(got.n_long) > 0 and int(got.n_mid) > 0


@pytest.mark.parametrize("capacity", ["untrimmed", "occupancy", "short"])
@pytest.mark.parametrize("n,d,order,kind", GRID)
def test_one_call_plan_rows_match_plain(cuda_device, n, d, order, kind, capacity):
    """lattice_plan_rows: its n_lattice the occupancy, its rows bit for bit the plain build of its own plan,
    K9 on them bit for bit the plain version's on the plain plan, twice; counted as one K2 (bounded below
    n(d+1) rows) and one row build a call; one row short of the occupancy all NaN, no fault."""
    dk = _dk(kind, order)
    x = _positions(n, d, 3, cuda_device)
    E, a, oh1, oh2 = t_lattice._lattice_constants(d, dk.coeffs, dk.variance, cuda_device)
    h1, h2, w = K.lattice_geometry(x, E, a)
    occ = int(K.count_plain(x, E, a))
    cap = {"untrimmed": None, "occupancy": occ, "short": occ - 1}[capacity]
    bounded = cap is not None and cap < n * (d + 1)
    norm = t_lattice.SLICE_NORM(d)
    v = torch.randn((n, 11), generator=torch.Generator(device=cuda_device).manual_seed(n), device=cuda_device)
    pseg, pnb, pnl = K.dedup_neighbors_plain(h1, h2, oh1, oh2, cap)
    pout = K.apply_cols_plain(pseg.reshape(n, d + 1), w, pnb, pnl, v, dk.coeffs, norm, 11)
    outs = []
    for _ in range(2):
        before = (K.lattice_dedup_neighbors.launches, K.lattice_dedup_neighbors.bounded_launches,
                  K.join_rows.launches)
        seg, nb, nl, rows = K.lattice_plan_rows(h1, h2, w, oh1, oh2, cap)
        outs.append(K.lattice_apply_cols(seg, w, nb, nl, v, dk.coeffs, norm, 11, rows))
        want = K.join_rows_plain(seg, w, nb, nl)
        torch.cuda.synchronize()
        after = (K.lattice_dedup_neighbors.launches, K.lattice_dedup_neighbors.bounded_launches, K.join_rows.launches)
        assert tuple(b - a_ for a_, b in zip(before, after)) == ((0, 1, 1) if bounded else (1, 0, 1))
        assert tuple(nb.shape) == tuple(pnb.shape) and int(pnl) == occ
        for name, g, p in zip(K.JoinRows._fields, rows, want):
            assert g.dtype == p.dtype and torch.equal(g, p), name
        if capacity == "short":
            assert int(nl) > cap and int(seg.max()) == 0 and bool(torch.isnan(outs[-1]).all())
        else:
            assert int(nl) == occ and torch.equal(outs[-1], pout)
    assert torch.equal(outs[0], outs[1]) or capacity == "short"


@pytest.mark.parametrize("J", [1, 2])
@pytest.mark.parametrize("k", [10, 15])
@pytest.mark.parametrize("edge", [-1, 0, 1])
def test_row_build_matches_plain_at_the_key_bit_edges(cuda_device, J, k, edge):
    """join_rows_device over J components of M rows, J M = 2^k - 1, 2^k, 2^k + 1 (J = 2: M = 2^(k-1) + edge,
    so J M = 2^k - 2, 2^k, 2^k + 2): every row live and the highest one too, bit for bit the plain rows and
    a second build; the sort reads K.rows_key_bits(J M) bits, all of which the highest row id needs."""
    M = (1 << k) + edge if J == 1 else (1 << (k - 1)) + edge
    Mt = J * M
    bits = K.rows_key_bits(Mt)
    assert (Mt - 1) >> bits == 0 and (Mt - 1) >> (bits - 1) == 1
    rng = np.random.default_rng(k + edge)
    dp1 = 4
    ids = np.concatenate([np.arange(Mt), rng.integers(0, Mt, size=-Mt % dp1 + dp1 * 700)]).astype(np.int32)
    seg = torch.from_numpy(rng.permutation(ids).reshape(-1, dp1)).to(cuda_device)
    w = torch.from_numpy(rng.uniform(-1, 1, size=seg.shape).astype(np.float32)).to(cuda_device)
    n = seg.shape[0]
    count = torch.tensor(Mt, dtype=torch.int32, device=cuda_device)
    live = torch.full((J,), M, dtype=torch.int32, device=cuda_device)
    before = K.join_rows.launches
    got, again = (K.join_rows_device(seg, w, live, M, n, count) for _ in range(2))
    want = K._rows_plain(seg, w, Mt, count)
    torch.cuda.synchronize()
    assert K.join_rows.launches == before + 2
    for name, g, a_, p in zip(K.JoinRows._fields, got, again, want):
        assert torch.equal(g, a_) and torch.equal(g, p), name


@pytest.mark.parametrize("c", [20, 101])
def test_k9_in_a_cuda_graph_and_the_mixture_branch(cuda_device, monkeypatch, c):
    """One K9 apply captured in a CUDA graph (no host read on its path) replays its eager output bit for bit;
    the mixture's wide filter above _JOIN_MAX_ROWS (one untrimmed chunked chain a component, no K9, no K12)
    against K12 on the stacked plan of the same positions."""
    dk = _dk("matern", 1)
    x = _positions(2000, 5, 12, cuda_device)
    plan = t_lattice.build_plan_join(x, dk.coeffs, dk.variance)
    rows = K.join_rows(*plan)
    v = torch.randn((2000, c), generator=torch.Generator(device=cuda_device).manual_seed(c), device=cuda_device)
    norm = t_lattice.SLICE_NORM(5)
    eager = K.lattice_apply_cols(*plan, v, dk.coeffs, norm, 8, rows)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K.lattice_apply_cols(*plan, v, dk.coeffs, norm, 8, rows)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = K.lattice_apply_cols(*plan, v, dk.coeffs, norm, 8, rows)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, eager)
    mk = t_kernels.mixture_kernel(1.5, 1, 4)
    mplan = t_filter.build_wide_plan_any(x, mk)
    want = t_filter.apply_plan_wide(mplan, v, mk)  # K12
    before = K.lattice_apply_cols.launches, KM.lattice_mixture_apply.launches, KC.chain_splat.launches
    monkeypatch.setattr(t_filter, "_JOIN_MAX_ROWS", 1000)
    got = t_filter.make_wide_filter(x, mk)(v)
    torch.cuda.synchronize()
    blocks = 4 * -(-c // t_filter._WIDE_CHUNK)
    assert (K.lattice_apply_cols.launches, KM.lattice_mixture_apply.launches, KC.chain_splat.launches) == (
        before[0], before[1], before[2] + blocks)
    assert float((got - want).norm() / want.norm()) < 1e-5


@pytest.mark.parametrize("n,d,order,kind", GRID)
def test_bounded_dedup_and_guard_match_plain(cuda_device, n, d, order, kind):
    dk = _dk(kind, order)
    x = _positions(n, d, 9, cuda_device)
    E, a, oh1, oh2 = t_lattice._lattice_constants(d, dk.coeffs, dk.variance, cuda_device)
    h1, h2, w = K.lattice_geometry(x, E, a)
    occ = int(K.count_plain(x, E, a))
    norm = t_lattice.SLICE_NORM(d)
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    v = torch.randn((n, 11), generator=gen, device=cuda_device)
    wide = torch.randn((n, 20), generator=gen, device=cuda_device)
    full = K.lattice_apply(*t_lattice.build_plan_join(x, dk.coeffs, dk.variance), v, dk.coeffs, norm)
    before = K.lattice_dedup_neighbors.bounded_launches
    for cap in (occ + 5, occ, occ - 1):
        if cap < 1 or cap >= n * (d + 1):
            continue
        kseg, knb, knl = K.lattice_dedup_neighbors(h1, h2, oh1, oh2, cap)
        pseg, pnb, pnl = K.dedup_neighbors_plain(h1, h2, oh1, oh2, cap)
        kseg, pseg = kseg.reshape(n, d + 1), pseg.reshape(n, d + 1)
        kout = K.lattice_apply(kseg, w, knb, knl, v, dk.coeffs, norm)
        kcols = K.lattice_apply_cols(kseg, w, knb, knl, wide, dk.coeffs, norm, 8)
        pout = K.apply_plain(pseg, w, pnb, v, dk.coeffs, norm, n_lattice=pnl)
        torch.cuda.synchronize()
        assert tuple(knb.shape) == (d + 1, cap, 2 * order) and int(pnl) == occ
        if cap >= occ:
            assert int(knl) == occ
            for got in (kout, full):
                assert float((got - pout).norm() / pout.norm()) < 1e-5
            pcols = K.apply_cols_plain(pseg, w, pnb, pnl, wide, dk.coeffs, norm, 8)
            assert float((kcols - pcols).norm() / pcols.norm()) < 1e-5
            assert torch.equal(kcols, K.apply_cols_plain(kseg, w, knb, knl, wide, dk.coeffs, norm, 8))
        else:
            # Tripped: every launch stays in bounds (K5 reads the tables at the seg ids) and
            # every output is NaN.
            assert int(knl) > cap and int(kseg.max()) < cap
            _, tf = K.lattice_apply(kseg, w, knb, knl, v, dk.coeffs, norm, return_table=True)
            gr = K.lattice_filter_grad(x, E, kseg, kout, v, tf, tf, norm)
            torch.cuda.synchronize()
            assert bool(torch.isnan(kout).all() and torch.isnan(kcols).all() and torch.isnan(pout).all())
            assert bool(torch.isnan(gr).all())
    assert K.lattice_dedup_neighbors.bounded_launches > before


@pytest.mark.parametrize("tag", ["init", "fixed"])
def test_houseelectric_nlml_matches_the_jax_golden_file(cuda_device, tag):
    """NLML and raw gradients at --max-n 360,000, median init, the autotrimmed capacity (K1, bounded K2,
    K3, K5, K6), against tests/fixtures/houseelectric_golden.npz, with chip_smoke.py phase 4's bounds.
    "init": the training CG at tolerance 1.0, the NLML only -- whether it stops after 10, 11 or 12
    iterations turns on f32 noise at the tolerance; "fixed": the CG run for JAX's iteration count,
    NLML and gradients.  The outputscale and lengthscale gradients nearly cancel at this point, so
    each group's error is taken against the whole raw gradient's norm (chip_smoke.py, phase 6.3)."""
    import pathlib

    import numpy as np

    import simplex_gp_torch
    from simplex_gp_torch.linalg.mll import BBMMConfig
    from simplex_gp_torch.utils import data

    golden = np.load(pathlib.Path(__file__).resolve().parent / "fixtures" / "houseelectric_golden.npz")
    cut = int(golden["max_n"])
    ds = data.load_dataset("houseelectric", max_n=cut)
    tol, iters = (1.0, 500) if tag == "init" else (0.0, int(golden["cg_iters_fixed"]))
    cfg = BBMMConfig(cg_tolerance=tol, max_cg_iterations=iters, max_lanczos_iterations=100, precond_rank=100,
                     num_probes=10, plan_capacity=int(golden["cut_capacity"]))
    model = simplex_gp_torch.SimplexGP(num_dims=11, kernel="matern", nu=1.5, order=1, min_noise=0.1, bbmm=cfg,
                                       device=cuda_device)
    names = ("raw_lengthscale", "raw_outputscale", "raw_noise", "mean")
    model.load_raw({k: golden[f"init_{k}"] for k in names})
    z = np.random.default_rng(int(golden["seed"])).choice([-1.0, 1.0], size=(cut, 10)).astype(np.float32)
    x, y = (torch.from_numpy(a).to(cuda_device) for a in (ds.train_x, ds.train_y))
    stats = {}
    loss = model.nlml(x, y, probes=torch.from_numpy(z).to(cuda_device), stats=stats)
    loss.backward()
    assert abs(float(loss.detach()) - float(golden[f"loss_{tag}"])) <= 1e-3
    if tag == "init":
        return
    assert stats["cg_iters"] == int(golden["cg_iters_fixed"])
    ga = [getattr(model, k).grad.detach().cpu().numpy().astype(np.float64).ravel() for k in names]
    gb = [golden[f"grad_{tag}_{k}"].astype(np.float64).ravel() for k in names]
    scale = np.linalg.norm(np.concatenate(gb))
    for k, a, b in zip(names, ga, gb):
        assert float(np.linalg.norm(a - b) / scale) <= 2e-2, k
    whole_a, whole_b = np.concatenate(ga), np.concatenate(gb)
    assert float(whole_a @ whole_b / (np.linalg.norm(whole_a) * scale)) >= 0.999


@pytest.mark.parametrize("n,d,order,kind", GRID)
def test_ordered_dedup_matches_plain_bit_for_bit(cuda_device, n, d, order, kind):
    """K11a: seg ids and neighbours equal to the plain version's, in two builds; K2's occupancy and operator."""
    dk = _dk(kind, order)
    x = _positions(n, d, 10, cuda_device)
    E, a, oh1, oh2 = t_lattice._lattice_constants(d, dk.coeffs, dk.variance, cuda_device)
    h1, h2, w = K.lattice_geometry(x, E, a)
    before = K.lattice_dedup_ordered.launches
    kseg, knb, knl = K.lattice_dedup_ordered(h1, h2, oh1, oh2)
    again = K.lattice_dedup_ordered(h1, h2, oh1, oh2)
    pseg, pnb, pnl = K.dedup_ordered_plain(h1, h2, oh1, oh2)
    torch.cuda.synchronize()
    assert K.lattice_dedup_ordered.launches == before + 2
    assert torch.equal(kseg, pseg) and torch.equal(knb, pnb) and int(knl) == int(pnl)
    assert torch.equal(again[0], kseg) and torch.equal(again[1], knb)
    sseg, snb, snl = K.lattice_dedup_neighbors(h1, h2, oh1, oh2)
    assert int(snl) == int(knl)
    v = torch.randn((n, 11), generator=torch.Generator(device=cuda_device).manual_seed(n), device=cuda_device)
    norm = t_lattice.SLICE_NORM(d)
    ordered = K.lattice_apply(kseg.reshape(n, d + 1), w, knb, knl, v, dk.coeffs, norm)
    unordered = K.lattice_apply(sseg.reshape(n, d + 1), w, snb, snl, v, dk.coeffs, norm)
    assert float((ordered - unordered).norm() / unordered.norm()) < 1e-5


class _OneRank:
    """The collectives of a one-rank axis: a reduce-scatter or all-gather over one rank is the identity."""

    rank, size = 0, 1

    def psum_scatter(self, blocks):
        return blocks[0]

    def all_gather_blocks(self, t):
        return t[None]


@pytest.mark.parametrize("c", [1, 11])
@pytest.mark.parametrize("n,d,order,kind", GRID)
def test_sharded_apply_one_rank_matches_plain_and_k3(cuda_device, n, d, order, kind, c):
    """K11b on one rank, its plain version and K3, forward and transposed, outputs and tables, each held
    to the operator in float64 (K3's plain version on K11a's plan with v in float64; K3 is a float32
    atomic splat whose order changes from run to run, within SHARDED_F64_REL of the float64 operator,
    see its note).  K11b splats in row order: it is its plain version's bits, and a second call's."""
    dk = _dk(kind, order)
    x = _positions(n, d, 11, cuda_device)
    E, a, oh1, oh2 = t_lattice._lattice_constants(d, dk.coeffs, dk.variance, cuda_device)
    h1, h2, w = K.lattice_geometry(x, E, a)
    seg, nb, nl = K.lattice_dedup_ordered(h1, h2, oh1, oh2)
    seg = seg.reshape(n, d + 1)
    v = torch.randn((n, c), generator=torch.Generator(device=cuda_device).manual_seed(c), device=cuda_device)
    norm, axis = t_lattice.SLICE_NORM(d), _OneRank()
    before = K.lattice_apply_sharded.launches
    for transpose in (False, True):
        kout, ktab = K.lattice_apply_sharded(seg, w, nb, nl, v, dk.coeffs, norm, axis, transpose, True)
        again, atab = K.lattice_apply_sharded(seg, w, nb, nl, v, dk.coeffs, norm, axis, transpose, True)
        pout, ptab = K.apply_sharded_plain(seg, w, nb, nl, v, dk.coeffs, norm, axis, transpose, True)
        whole, wtab = K.lattice_apply(seg, w, nb, nl, v, dk.coeffs, norm, transpose, True)
        exact, etab = K.apply_plain(seg, w, nb, v.double(), dk.coeffs, norm, transpose, True)
        torch.cuda.synchronize()
        assert ktab.shape == (int(nl), c)  # the live rows only
        assert torch.equal(kout, pout) and torch.equal(ktab, ptab)
        assert torch.equal(again, kout) and torch.equal(atab, ktab)
        rows = seg.long()  # rows past n_lattice are undefined in K3's table
        for got, want in ((kout, exact), (pout, exact), (whole, exact),
                          (ktab[rows], etab[rows]), (ptab[rows], etab[rows]), (wtab[rows], etab[rows])):
            assert float((got.double() - want).norm() / want.norm()) < SHARDED_F64_REL
    assert K.lattice_apply_sharded.launches == before + 4


def test_sharded_apply_two_gloo_ranks_on_the_card(cuda_device):
    """K11b over two gloo ranks sharing the card, c = 5 (padded to 6) and 11: each rank bit-equal to its
    plain version, and the ranks' rows against K3 on one process (rel 1e-5); the same plan on both ranks.
    Beside it the sharded chain apply on the same rows: each rank's output and table bit-equal to its
    plain version, the ranks' rows against the one-process chain apply (rel 1e-5), the same transitions on
    both ranks, and each chain kernel's launches."""
    import numpy as np
    from torch_dist_bodies import card_sharded_apply

    from simplex_gp_torch.parallel import launch

    n, d = 600, 5
    x, _ = seeded(n, d, 1, seed=12)
    v = np.random.default_rng(13).normal(size=(n, 11)).astype(np.float32)
    ranks = launch(card_sharded_apply, 2, (x, v), backend="gloo", device="cuda", timeout=300)
    dk = _dk("rbf", 1)
    plan = t_lattice.build_plan_join(torch.from_numpy(x).to(cuda_device), dk.coeffs, dk.variance)
    for c in (5, 11):
        for transpose in (False, True):
            whole = K.lattice_apply(*plan, torch.from_numpy(v[:, :c]).to(cuda_device), dk.coeffs,
                                    t_lattice.SLICE_NORM(d), transpose).cpu().numpy()
            got = np.concatenate([r[(c, transpose)]["kernel"] for r in ranks])
            assert np.linalg.norm(got - whole) / np.linalg.norm(whole) < 1e-5
            for r in ranks:
                assert np.array_equal(r[(c, transpose)]["kernel"], r[(c, transpose)]["plain"])
    assert np.array_equal(ranks[0]["neighbors"], ranks[1]["neighbors"])
    assert all(r["launches"] == 4 for r in ranks)
    cplan = t_lattice.build_plan_chain(torch.from_numpy(x).to(cuda_device), dk.coeffs, dk.variance)
    for c in (5, 11):
        for transpose in (False, True):
            whole = t_lattice.apply_plan_chain(cplan, torch.from_numpy(v[:, :c]).to(cuda_device), dk.coeffs,
                                               transpose).cpu().numpy()
            got = np.concatenate([r[("chain", c, transpose)]["kernel"] for r in ranks])
            assert np.linalg.norm(got - whole) / np.linalg.norm(whole) < 1e-5
            for r in ranks:
                assert np.array_equal(r[("chain", c, transpose)]["kernel"], r[("chain", c, transpose)]["plain"])
                assert r[("chain", c, transpose)]["tables_equal"]
    assert np.array_equal(ranks[0]["chain_gather"], ranks[1]["chain_gather"])
    assert all(r["chain_launches"] == dict(chain_splat=4, chain_axes=2, chain_maps=2, chain_axes_transpose=2,
                                           chain_unblock=4, chain_slice=4) for r in ranks)


@pytest.mark.parametrize("nu", [0.0, 0.5, 1.5, 2.5])
def test_pivot_column_at_matches_plain_and_k6(cuda_device, nu):
    """K6' (K6 given the pivot's rows): with the pivot held here, K6 bit for bit (the same arithmetic
    on copies of the pivot's rows); on a rank without it (-1), the plain version (rel 1e-5), with -1
    recorded as the pivot."""
    n, k = 3000, 40
    ref = torch.from_numpy(seeded(n, 5, 1, seed=3)[0]).to(cuda_device)
    s = torch.tensor(1.3, device=cuda_device)
    diag = s * torch.ones(n, device=cuda_device)
    d0 = diag.max()
    L = torch.zeros((n, k), device=cuda_device)
    piv = torch.zeros(k, dtype=torch.int64, device=cuda_device)
    for j in range(k - 1):
        diag = pivot_column_plain(ref, L, diag, torch.argmax(diag), j, s, d0, nu, piv)
    p = torch.argmax(diag)
    row = (ref[p].clone(), L[p].clone(), diag[p].reshape(1).clone())
    La, Lb, pa, pb = L.clone(), L.clone(), piv.clone(), piv.clone()
    before, sharded = pivot_column.launches, pivot_column.sharded_launches
    da = pivot_column(ref, La, diag, p, k - 1, s, d0, nu, pa, row)
    db = pivot_column(ref, Lb, diag, p, k - 1, s, d0, nu, pb)
    torch.cuda.synchronize()
    assert pivot_column.launches == before + 2 and pivot_column.sharded_launches == sharded + 1
    assert torch.equal(La, Lb) and torch.equal(da, db) and torch.equal(pa, pb)
    away = torch.tensor(-1, dtype=torch.int64, device=cuda_device)
    Lc, Ld, pc, pd = L.clone(), L.clone(), piv.clone(), piv.clone()
    dc = pivot_column(ref, Lc, diag, away, k - 1, s, d0, nu, pc, row)
    dd = pivot_column_plain(ref, Ld, diag, away, k - 1, s, d0, nu, pd, row)
    torch.cuda.synchronize()
    assert float((Lc - Ld).norm() / Ld.norm()) < 1e-5 and float((dc - dd).norm() / dd.norm()) < 1e-5
    assert int(pc[k - 1]) == -1 and int(pd[k - 1]) == -1


@pytest.mark.parametrize("c", [1, 11])
@pytest.mark.parametrize("n,d,J", [(300, 3, 6), (400, 9, 8), (2000, 17, 8)])
def test_mixture_apply_and_grad_match_plain(cuda_device, n, d, J, c):
    """K12 forward and transposed, with its stacked table, bit for bit against its plain version, and the
    stacked K5 against its plain version."""
    mk = t_kernels.mixture_kernel(1.5, 1, J)
    ref = _positions(n, d, 11, cuda_device)
    plan = t_lattice.build_plan_mixture(ref, mk.alphas, mk.base.coeffs, mk.base.variance)
    gen = torch.Generator(device=cuda_device).manual_seed(c)
    v = torch.randn((n, c), generator=gen, device=cuda_device)
    g = torch.randn((n, c), generator=gen, device=cuda_device)
    args = (plan.seg_ids, plan.weights, plan.neighbors)
    norm, taps = t_lattice.SLICE_NORM(d), list(mk.base.coeffs)
    rows = plan.seg_ids.reshape(-1).long()  # the rows that are read; rows past a live count are undefined
    tables = []
    for u, transpose in ((v, False), (g, True)):
        before = KM.lattice_mixture_apply.launches
        k_out, k_tab = KM.lattice_mixture_apply(*args, plan.live, u, taps, norm, mk.weights, transpose, True,
                                                plan.rows)
        p_out, p_tab = KM.mixture_apply_plain(*args, u, taps, norm, mk.weights, transpose, True, plan.rows)
        torch.cuda.synchronize()
        assert KM.lattice_mixture_apply.launches == before + 1
        assert torch.equal(k_out, p_out) and torch.equal(k_tab[rows], p_tab[rows])
        tables.append(k_tab)
    gr_k = t_filter.mixture_position_grad(plan, ref, mk, v, g, *tables)
    cpu = [t.cpu() for t in (ref, v, g, *tables)]
    cplan = t_lattice.MixturePlan(*(t.cpu() for t in plan[:4]), K.JoinRows(*(t.cpu() for t in plan.rows)))
    gr_p = t_filter.mixture_position_grad(cplan, cpu[0], mk, *cpu[1:])
    torch.cuda.synchronize()
    assert float((gr_k.cpu() - gr_p).norm() / gr_p.norm()) < 1e-4


def _elevators_shaped(n=10623, d=18, seed=0, device="cuda"):
    """Seeded normal positions of the elevators training shape at about its median-init lengthscale."""
    return torch.from_numpy(np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32) / 4.2).to(device)


@pytest.mark.parametrize("case", ["elevators J=8", "synthetic"])
def test_mixture_rows_match_plain_bit_for_bit(cuda_device, case):
    """K12's row lists on the card against their plain build, field by field: an elevators-shaped J = 8 plan
    and synthetic stacked runs of every class with a component without live rows."""
    if case == "synthetic":
        stacked = [RUN_LENGTHS[:11], [], RUN_LENGTHS[11:]]
        seg, w, nb, live = synthetic_mixture_plan(stacked, n=900, dp1=4, seed=3, device=cuda_device)
    else:
        mk = t_kernels.mixture_kernel(1.5, 1, 8)
        plan = t_lattice.build_plan_mixture(_elevators_shaped(device=cuda_device), mk.alphas, mk.base.coeffs,
                                            mk.base.variance)
        seg, w, nb, live = plan[:4]
    before = K.join_rows.launches
    rows = KM.mixture_rows(seg, w, nb, live)
    plain = KM.mixture_rows_plain(seg, w, nb)
    torch.cuda.synchronize()
    assert K.join_rows.launches == before + 1
    for name in K.JoinRows._fields:
        assert torch.equal(getattr(rows, name), getattr(plain, name)), name
    if case == "synthetic":
        assert int(rows.n_long) > 0 and int(rows.n_mid) > 0


@pytest.mark.parametrize("c", [1, 11, 100])
@pytest.mark.parametrize("case", ["elevators J=8", "synthetic"])
def test_mixture_apply_bit_equal_to_plain_and_repeated(cuda_device, case, c):
    """K12 at the path's widths (the CG's c = 1 and 11, the range sketch's 100), forward and transposed: the
    output and the read rows of the table equal the plain version's and a second run's bit for bit."""
    if case == "synthetic":
        stacked = [RUN_LENGTHS[:11], [], RUN_LENGTHS[11:]]
        seg, w, nb, live = synthetic_mixture_plan(stacked, n=900, dp1=4, seed=c, device=cuda_device)
        rows, taps, norm, weights = KM.mixture_rows(seg, w, nb, live), [0.5, 1.0, 0.5], 0.7, (0.4, 1.3, 0.8)
    else:
        mk = t_kernels.mixture_kernel(1.5, 1, 8)
        plan = t_lattice.build_plan_mixture(_elevators_shaped(device=cuda_device), mk.alphas, mk.base.coeffs,
                                            mk.base.variance)
        seg, w, nb, live, rows = plan
        taps, norm, weights = list(mk.base.coeffs), t_lattice.SLICE_NORM(18), mk.weights
    n = seg.shape[1]
    v = torch.randn((n, c), generator=torch.Generator(device=cuda_device).manual_seed(c), device=cuda_device)
    read = seg.reshape(-1).long()
    for transpose in (False, True):
        k_out, k_tab = KM.lattice_mixture_apply(seg, w, nb, live, v, taps, norm, weights, transpose, True, rows)
        again, again_tab = KM.lattice_mixture_apply(seg, w, nb, live, v, taps, norm, weights, transpose, True, rows)
        p_out, p_tab = KM.mixture_apply_plain(seg, w, nb, v, taps, norm, weights, transpose, True, rows)
        torch.cuda.synchronize()
        assert torch.equal(k_out, p_out) and torch.equal(k_tab[read], p_tab[read])
        assert torch.equal(again, k_out) and torch.equal(again_tab[read], k_tab[read])


def test_mixture_nlml_gradients_repeat_bit_for_bit(cuda_device):
    """Two mixture NLML gradients at the same inputs are bit-equal: the CG and its backward run on the J chain
    plans (the chain apply and its transpose have no atomics), and launch no K12."""
    from simplex_gp_torch.linalg import mll as t_mll

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(4000, 6)).astype(np.float32)).to(cuda_device)
    y = torch.from_numpy(rng.normal(size=4000).astype(np.float32)).to(cuda_device)
    z = torch.from_numpy(rng.choice([-1.0, 1.0], size=(4000, 10)).astype(np.float32)).to(cuda_device)
    mk = t_kernels.mixture_kernel(1.5, 1, 8)
    launches = KM.lattice_mixture_apply.launches, KC.chain_axes_transpose.launches
    grads = []
    for _ in range(2):
        params = {k: torch.tensor(v, device=cuda_device, requires_grad=True) for k, v in
                  (("inv_ell", np.full(6, 0.8, np.float32)), ("outputscale", np.float32(1.0)),
                   ("noise", np.float32(0.2)), ("mean", np.float32(0.0)))}
        loss = t_mll.lattice_nlml(mk, t_mll.BBMMConfig(), params, x, y, z)
        grads.append(torch.autograd.grad(loss, list(params.values())) + (loss.detach(),))
    assert KM.lattice_mixture_apply.launches == launches[0]
    assert KC.chain_axes_transpose.launches == launches[1] + 2 * 8  # one a component a backward
    assert all(torch.equal(u, v) for u, v in zip(*grads))


def test_elevators_posterior_cache_repeats_bit_for_bit(cuda_device):
    """Two posterior_cache calls at the elevators training shape give the same alpha and root bits; the range
    sketch runs K9 on its plan's row lists and K3 not at all."""
    import simplex_gp_torch as T

    rng = np.random.default_rng(6)
    x = _elevators_shaped(seed=6, device=cuda_device) * 4.2
    y = torch.from_numpy(np.tanh(x[:, 0].cpu().numpy()) + 0.1 * rng.normal(size=x.shape[0]).astype(np.float32))
    model = T.SimplexGP(num_dims=18, kernel="matern", nu=1.5, order=1, min_noise=0.1, device=cuda_device,
                        bbmm=T.BBMMConfig(precond_rank=100, max_lanczos_iterations=100))
    y = y.to(cuda_device)
    k3, k9 = K.lattice_apply.launches, K.lattice_apply_cols.launches
    caches = [model.posterior_cache(x, y, generator=torch.Generator(device=cuda_device).manual_seed(0))
              for _ in range(2)]
    torch.cuda.synchronize()
    assert K.lattice_apply.launches == k3 and K.lattice_apply_cols.launches == k9 + 4
    assert torch.equal(caches[0]["alpha"], caches[1]["alpha"])
    assert torch.equal(caches[0]["root_inv"], caches[1]["root_inv"])


def test_mixture_apply_refuses_wrong_inputs(cuda_device):
    mk = t_kernels.mixture_kernel(1.5, 1, 4)
    ref = _positions(50, 3, 1, cuda_device)
    plan = t_lattice.build_plan_mixture(ref, mk.alphas, mk.base.coeffs, mk.base.variance)
    v = torch.zeros((50, 2), device=cuda_device)
    taps = list(mk.base.coeffs)
    with pytest.raises(ValueError):  # the live counts on the host
        KM.lattice_mixture_apply(plan.seg_ids, plan.weights, plan.neighbors, plan.live.cpu(), v, taps, 1.0,
                                 mk.weights)
    with pytest.raises(ValueError):  # one weight short
        KM.lattice_mixture_apply(plan.seg_ids, plan.weights, plan.neighbors, plan.live, v, taps, 1.0,
                                 mk.weights[:3])


def test_snelson_prediction_quality_on_the_card(cuda_device):
    """test_torch_snelson.py::test_snelson_prediction_quality on the card, through K1, K2, K9 (the range
    sketch and the predict filter on their join plans' row lists), K5 and K6."""
    import simplex_gp_torch as T
    from simplex_gp_torch.utils.data import load_snelson

    xs, ys = load_snelson()
    x, y = torch.from_numpy(xs).to(cuda_device), torch.from_numpy(ys).to(cuda_device)
    xt, yt, xe, ye = x[::2], y[::2], x[1::2], y[1::2]
    path = (K.lattice_geometry, K.lattice_dedup_neighbors, K.lattice_apply_cols, K.lattice_filter_grad, pivot_column)
    before = [fn.launches for fn in path]
    simplex = T.SimplexGP(num_dims=1, kernel="rbf", order=1, min_noise=1e-4, device=cuda_device,
                          bbmm=T.BBMMConfig(cg_tolerance=1e-4, max_lanczos_iterations=100))
    T.fit_adam(lambda g: simplex.nlml(xt, yt, generator=g), simplex.parameters(), epochs=60, lr=0.1)
    mean, var = simplex.predict(xt, yt, xe, generator=torch.Generator(device=cuda_device).manual_seed(0))
    assert all(fn.launches > b for fn, b in zip(path, before))
    assert float(torch.sqrt(((mean - ye) ** 2).mean())) < 0.35
    assert bool((var > 0).all())
    assert float((((mean - ye).abs() / torch.sqrt(var)) < 3).float().mean()) > 0.9


def _ski_inputs(n, r, k, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen).to(device) for s in ((n, r), (n, r), (r * r, k), (n, k))]


# K13b / K13d take 256 rows a block: its height -1, +0 and +1, ragged ranks and widths (r = 63, k = 1, k not a
# multiple of 4: the 4-byte copies), and r = k = 64 (the 16-byte copies).
@pytest.mark.parametrize("n,r,k", [(257, 5, 7), (1000, 64, 64), (70001, 64, 64), (255, 64, 64), (256, 64, 64),
                                   (257, 64, 64), (300, 63, 64), (300, 64, 1), (513, 64, 30), (600, 63, 63)])
def test_ski_kr_kernels_match_plain(cuda_device, n, r, k):
    """K13b, K13c (split over row chunks of whole 32-row stages, the chunks added in a second pass) and K13d,
    within rel 1e-5 of their plain versions.  A fixed order and no atomics: a second call of each gives the
    same bits."""
    from simplex_gp_torch.kernels import ski as KS

    R, F, W, G = _ski_inputs(n, r, k, cuda_device)
    before = [fn.launches for fn in (KS.ski_kr_matmul, KS.ski_kr_gram, KS.ski_kr_adjoint)]
    out, gram, (dR, dF) = KS.ski_kr_matmul(R, F, W), KS.ski_kr_gram(G, R, F), KS.ski_kr_adjoint(R, F, W, G)
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip((KS.ski_kr_matmul, KS.ski_kr_gram, KS.ski_kr_adjoint), before)] == [1] * 3
    pairs = [(out, KS.kr_matmul_plain(R, F, W)), (gram, KS.kr_gram_plain(G, R, F)),
             *zip((dR, dF), KS.kr_adjoint_plain(R, F, W, G))]
    for got, want in pairs:
        assert float((got - want).norm() / want.norm()) < 1e-5
    assert torch.equal(KS.ski_kr_gram(G, R, F), gram)
    assert torch.equal(KS.ski_kr_matmul(R, F, W), out)
    dR2, dF2 = KS.ski_kr_adjoint(R, F, W, G)
    assert torch.equal(dR2, dR) and torch.equal(dF2, dF)


def test_ski_kr_kernels_take_rows_off_16_byte_boundaries(cuda_device):
    """W and F one float past a 16-byte boundary (contiguous views at an offset): K13b and K13d take their
    4-byte copies and give the bits of aligned copies of the same values."""
    from simplex_gp_torch.kernels import ski as KS

    n, r, k = 600, 64, 64
    R, F, W, G = _ski_inputs(n, r, k, cuda_device, seed=1)
    Wo = torch.empty(W.numel() + 1, device=cuda_device)[1:].view(W.shape)
    Fo = torch.empty(F.numel() + 1, device=cuda_device)[1:].view(F.shape)
    Wo.copy_(W)
    Fo.copy_(F)
    assert Wo.data_ptr() % 16 and Fo.data_ptr() % 16 and Wo.is_contiguous() and Fo.is_contiguous()
    assert torch.equal(KS.ski_kr_matmul(R, Fo, Wo), KS.ski_kr_matmul(R, F, W))
    for got, want in zip(KS.ski_kr_adjoint(R, Fo, Wo, G), KS.ski_kr_adjoint(R, F, W, G)):
        assert torch.equal(got, want)


# K13c's stages of 32 rows and its chunks (kernels/ski.py::_gram_split): one stage -1 / 0 / +1 row, n below
# one stage, the edge where a chunk grows from one stage to two (511 / 512 / 513 rows at r = 64),
# ragged r and k (4-byte copies), k = 1, a joint-root height, and Q, R, F off 16-byte boundaries.
@pytest.mark.parametrize("n,r,k,offset", [(31, 64, 64, False), (32, 64, 64, False), (33, 64, 64, False),
                                          (5, 64, 64, False), (511, 64, 64, False), (512, 64, 64, False),
                                          (513, 64, 64, False), (4097, 63, 30, False), (1000, 64, 1, False),
                                          (2000, 7, 13, False), (65537, 64, 64, False), (3000, 64, 64, True),
                                          (3000, 62, 61, True)])
def test_ski_kr_gram_at_its_stage_and_chunk_edges(cuda_device, n, r, k, offset):
    """K13c within rel 1e-5 of its plain version and bit-equal to a second call; with Q, R and F one float
    past a 16-byte boundary it takes 4-byte copies and gives the bits of aligned copies of the same values."""
    from simplex_gp_torch.kernels import ski as KS

    R, F, _, Q = _ski_inputs(n, r, k, cuda_device, seed=n)
    before = KS.ski_kr_gram.launches
    got = KS.ski_kr_gram(Q, R, F)
    torch.cuda.synchronize()
    assert KS.ski_kr_gram.launches - before == 1 and got.shape == (k, r * r)
    want = KS.kr_gram_plain(Q, R, F)
    assert float((got - want).norm() / want.norm()) < 1e-5
    assert torch.equal(KS.ski_kr_gram(Q, R, F), got)
    if offset:
        moved = []
        for t in (Q, R, F):
            o = torch.empty(t.numel() + 1, device=cuda_device)[1:].view(t.shape)
            o.copy_(t)
            assert o.data_ptr() % 16 and o.is_contiguous()
            moved.append(o)
        assert torch.equal(KS.ski_kr_gram(*moved), got)


@pytest.mark.parametrize("n,g,r", [(3000, 100, 64), (517, 9, 5)])
def test_ski_interp_and_scatter_match_plain(cuda_device, n, g, r):
    """K13a (rel 1e-5 in F) and its backward scatter, bit-equal to its plain version and to a second call
    (a fixed order: sub-ranges, slices, blocks)."""
    from simplex_gp_torch.kernels import ski as KS

    gen = torch.Generator().manual_seed(3)
    x = torch.randn(n, generator=gen).to(cuda_device)
    U, dF = torch.randn((g, r), generator=gen).to(cuda_device), torch.randn((n, r), generator=gen).to(cuda_device)
    step = ((x.max() - x.min()) / (g - 5) + 1e-12).contiguous()
    gmin = (x.min() - 2 * step).contiguous()
    F = KS.ski_interp(x, gmin, step, U)
    dU = KS.ski_interp_backward(x, gmin, step, dF, g)
    torch.cuda.synchronize()
    assert float((F - KS.interp_plain(x, gmin, step, U)).abs().max()) < 1e-5
    want = KS.interp_backward_plain(x, gmin, step, dF, g)
    assert torch.equal(dU, want) and torch.equal(KS.ski_interp_backward(x, gmin, step, dF, g), dU)


def test_skip_root_and_nlml_through_k13(cuda_device):
    """SKIP's NLML and gradients on the card through K13 against the plain path on the CPU (rank 16: the kept
    eigenvalues are well separated, so cuSOLVER's and LAPACK's eigenvectors agree up to the fixed signs)."""
    from simplex_gp_torch.kernels import ski as KS
    from simplex_gp_torch.models.ski import SKIP

    gen = torch.Generator().manual_seed(4)
    x, y = torch.randn((4000, 3), generator=gen), torch.randn(4000, generator=gen)
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        m = SKIP(num_dims=3, grid_size=100, rank=16, kernel="matern", min_noise=0.1, device=dev)
        before = [fn.launches for fn in (KS.ski_interp, KS.ski_kr_matmul, KS.ski_kr_gram, KS.ski_kr_adjoint,
                                         KS.ski_interp_backward)]
        loss = m.nlml(x.to(dev), y.to(dev))
        loss.backward()
        if dev.type == "cuda":
            after = [fn.launches for fn in (KS.ski_interp, KS.ski_kr_matmul, KS.ski_kr_gram, KS.ski_kr_adjoint,
                                            KS.ski_interp_backward)]
            assert [a - b for a, b in zip(after, before)] == [3, 4, 2, 4, 3]
        out.append((float(loss.detach()), torch.cat([p.grad.reshape(-1).cpu() for p in m.parameters()])))
    (lk, gk), (lp, gp) = out
    assert abs(lk - lp) < 1e-5 and float((gk - gp).norm() / gp.norm()) < 1e-3


@pytest.mark.parametrize("n,d,order,kind", GRID + [(10623, 18, 1, "matern"), (3000, 2, 1, "rbf")])
def test_chain_build_and_apply_match_plain_bit_for_bit(cuda_device, n, d, order, kind):
    """K3'a-d against their plain versions at the grid and at elevators width (d = 18), trimmed and
    untrimmed; (3000, 2) at a small scale has rows past PIECE, summed in pieces."""
    dk = _dk(kind, order)
    x = _positions(n, d, 10, cuda_device)
    if n == 3000:
        x = 0.02 * x
    E = torch.from_numpy(t_lattice.build_rotation(d, dk.variance)).to(cuda_device)
    a = torch.from_numpy(t_lattice._hash_vectors(d)).to(cuda_device)
    h1, h2, w, s = K.lattice_geometry(x, E, a, with_s=True)
    ph1, ph2, pw, ps = K.geometry_plain(x, E, a, with_s=True)
    assert torch.equal(h1, ph1) and torch.equal(h2, ph2) and torch.equal(s, ps)
    consts = torch.from_numpy(t_lattice._chain_consts(d)).to(cuda_device)
    taps = [float(t) for t in dk.coeffs]
    occ = int(KC.chain_build_plain(h1, h2, s, w, consts, taps).n_lattice)
    join = t_lattice.build_plan_join(x, dk.coeffs, dk.variance)
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    for cap in (None, occ + 3, occ - 1):
        kplan = KC.chain_build(h1, h2, s, w, consts, taps, cap)
        pplan = KC.chain_build_plain(h1, h2, s, w, consts, taps, cap)
        again = KC.chain_build(h1, h2, s, w, consts, taps, cap)
        torch.cuda.synchronize()
        for f in KC.ChainPlan._fields:
            assert torch.equal(getattr(kplan, f), getattr(pplan, f)), f
            assert torch.equal(getattr(kplan, f), getattr(again, f)), f
        if n == 3000 and cap is None:
            assert int(kplan.n_long) > 0 and int(kplan.n_pieces) > int(kplan.n_long)
        for c in (1, 11):
            v = torch.randn((n, c), generator=gen, device=cuda_device)
            kout = t_lattice.apply_plan_chain(kplan, v, dk.coeffs)
            pout = KC.chain_apply_plain(pplan, v, taps, t_lattice.SLICE_NORM(d))
            torch.cuda.synchronize()
            if cap is not None and cap < occ:
                assert bool(torch.isnan(kout).all() and torch.isnan(pout).all())
                continue
            assert torch.equal(kout, pout)
            assert torch.equal(kout, t_lattice.apply_plan_chain(kplan, v, dk.coeffs))
            jout = t_lattice.apply_plan_join(join, v, dk.coeffs)
            assert float((kout - jout).norm() / jout.norm()) < 2e-5


def _slice_case(n, dp1, c, Mc, device, seed):
    """A plan's slice fields (slice_idx (n, d+1) into Mc rows, weights, n_lattice = Mc) and an (Mc, c) table,
    from one seed: what K3'd reads."""
    import types

    gen = torch.Generator().manual_seed(seed)
    plan = types.SimpleNamespace(
        slice_idx=torch.randint(0, Mc, (n, dp1), generator=gen, dtype=torch.int32).to(device),
        weights=torch.rand((n, dp1), generator=gen).to(device),
        n_lattice=torch.tensor(Mc, dtype=torch.int32, device=device))
    return plan, torch.randn((Mc, c), generator=gen).to(device)


# d+1 = 2, the compiled 12 and 19, 20 and 40 on the generic path (40: fewer points a block, its slabs capped);
# c = 1, 11, 17; n = 1, n not a multiple of a block's points, and a houseelectric-sized block count.
@pytest.mark.parametrize("c", [1, 11, 17])
@pytest.mark.parametrize("dp1", [2, 12, 19, 20, 40])
@pytest.mark.parametrize("n", [1, 1001, 70001])
def test_chain_slice_equals_plain_and_a_second_call(cuda_device, n, dp1, c):
    """K3'd (a block's slabs of slice_idx and weights in shared memory, c lanes a point, the vertices summed
    in order) torch.equal to chain_slice_plain and to a second call; past the capacity all NaN."""
    plan, table = _slice_case(n, dp1, c, 997, cuda_device, seed=n * 100 + dp1 + c)
    before = KC.chain_slice.launches
    got = KC.chain_slice(table, plan, 0.37)
    torch.cuda.synchronize()
    assert KC.chain_slice.launches - before == 1
    want = KC.chain_slice_plain(table, plan.slice_idx, plan.weights, plan.n_lattice, 0.37)
    assert torch.equal(got, want) and torch.equal(KC.chain_slice(table, plan, 0.37), got)
    plan.n_lattice.fill_(998)  # one point past the capacity
    assert bool(torch.isnan(KC.chain_slice(table, plan, 0.37)).all())


@pytest.mark.parametrize("dp1", [12, 19, 20])
def test_chain_slice_takes_slabs_off_16_byte_boundaries(cuda_device, dp1):
    """slice_idx and weights one word past a 16-byte boundary: K3'd takes 4-byte copies into its slabs and
    gives the bits of aligned copies of the same values."""
    import types

    plan, table = _slice_case(5003, dp1, 11, 4099, cuda_device, seed=dp1)
    moved = {}
    for f in ("slice_idx", "weights"):
        t = getattr(plan, f)
        o = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda_device)[1:].view(t.shape)
        o.copy_(t)
        assert o.data_ptr() % 16 and o.is_contiguous()
        moved[f] = o
    off = types.SimpleNamespace(n_lattice=plan.n_lattice, **moved)
    got = KC.chain_slice(table, off, 0.5)
    assert torch.equal(got, KC.chain_slice(table, plan, 0.5))
    assert torch.equal(got, KC.chain_slice_plain(table, plan.slice_idx, plan.weights, plan.n_lattice, 0.5))


@pytest.mark.parametrize("c", [1, 11, 17])
@pytest.mark.parametrize("d", [1, 11, 18, 19])
def test_chain_apply_slices_bit_for_bit_at_the_compiled_widths(cuda_device, d, c):
    """chain_apply (its slice inside sgp_chain_apply) on built plans at d+1 = 2, 12, 19 and 20, untrimmed and
    one row short of the occupancy: torch.equal to the plain apply and to a second apply, one K3'd launch
    counted an apply; past the capacity all NaN."""
    dk = _dk("matern", 1)
    x = _positions(3001, d, 13, cuda_device)
    occ = int(t_lattice.build_plan_chain(x, dk.coeffs, dk.variance).n_lattice)
    taps = [float(t) for t in dk.coeffs]
    v = torch.randn((3001, c), generator=torch.Generator(device=cuda_device).manual_seed(d), device=cuda_device)
    for cap in (None, occ - 1):
        plan = t_lattice.build_plan_chain(x, dk.coeffs, dk.variance, cap)
        before = KC.chain_slice.launches
        out = t_lattice.apply_plan_chain(plan, v, dk.coeffs)
        torch.cuda.synchronize()
        assert KC.chain_slice.launches - before == 1
        pout = KC.chain_apply_plain(plan, v, taps, t_lattice.SLICE_NORM(d))
        if cap is not None:
            assert bool(torch.isnan(out).all() and torch.isnan(pout).all())
            continue
        assert torch.equal(out, pout) and torch.equal(t_lattice.apply_plan_chain(plan, v, dk.coeffs), out)


def _chain_hard_positions(case, device):
    """tests/test_torch_chain_build.py's hard inputs, on the card."""
    rng = np.random.default_rng(11)
    x = {"d1": lambda: 3.0 * rng.normal(size=(300, 1)),
         "d18": lambda: rng.normal(size=(1500, 18)),
         "one point repeated": lambda: np.repeat(rng.normal(size=(1, 6)), 2000, axis=0),
         "duplicated rows": lambda: np.tile(rng.normal(size=(60, 4)), (5, 1)),
         "run classes": chain_class_positions}[case]()
    return torch.from_numpy(np.asarray(x, np.float32)).to(device)


@pytest.mark.parametrize("capacity", ["untrimmed", "trimmed", "overflowing", "half"])
@pytest.mark.parametrize("case", ["d1", "d18", "one point repeated", "duplicated rows", "run classes"])
def test_chain_build_matches_plain_on_hard_inputs(cuda_device, case, capacity):
    """K3'a's hash dedup against the plain build (two stable sorts of every contribution), every field bit
    for bit, and a second build: one point repeated (every contribution on d+1 points), duplicated rows,
    d = 1 and 18, runs past 1,024 contributions; untrimmed, trimmed, one row short and half the occupancy."""
    dk = _dk("matern" if case == "d18" else "rbf", 2 if case == "d1" else 1)
    x = _chain_hard_positions(case, cuda_device)
    d = x.shape[1]
    E = torch.from_numpy(t_lattice.build_rotation(d, dk.variance)).to(cuda_device)
    a = torch.from_numpy(t_lattice._hash_vectors(d)).to(cuda_device)
    args = (*K.lattice_geometry(x, E, a, with_s=True), torch.from_numpy(t_lattice._chain_consts(d)).to(cuda_device),
            [float(t) for t in dk.coeffs])
    h1, h2, w, s, consts, taps = args
    occ = int(KC.chain_build_plain(h1, h2, s, w, consts, taps).n_lattice)
    cap = {"untrimmed": None, "trimmed": occ + 3, "overflowing": occ - 1, "half": max(1, occ // 2)}[capacity]
    kplan = KC.chain_build(h1, h2, s, w, consts, taps, cap)
    pplan = KC.chain_build_plain(h1, h2, s, w, consts, taps, cap)
    again = KC.chain_build(h1, h2, s, w, consts, taps, cap)
    torch.cuda.synchronize()
    for f in KC.ChainPlan._fields:
        assert torch.equal(getattr(kplan, f), getattr(pplan, f)), f
        assert torch.equal(getattr(kplan, f), getattr(again, f)), f
    if cap is not None and cap < occ:
        v = torch.ones((x.shape[0], 2), device=cuda_device)
        assert bool(torch.isnan(t_lattice.apply_plan_chain(kplan, v, dk.coeffs)).all())


@pytest.mark.parametrize("case", ["one point repeated", "d18", "run classes"])
@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_chain_build_rank_window_matches_plain(cuda_device, case, ranks):
    """A sharded plan's rank part (chain_build with ``first``): every field bit for bit against the plain
    build's and a second build, for each rank of 1, 2 and 4 over the hard inputs' points; its apply on one
    rank (P = 1) torch.equal to the one-device apply.  And chain_unblock torch.equal to its twin."""
    dk = _dk("matern" if case == "d18" else "rbf", 1)
    x = _chain_hard_positions(case, cuda_device)
    n, d = x.shape
    n_loc = n // ranks
    x = x[:n_loc * ranks].contiguous()
    E = torch.from_numpy(t_lattice.build_rotation(d, dk.variance)).to(cuda_device)
    a = torch.from_numpy(t_lattice._hash_vectors(d)).to(cuda_device)
    h1, h2, w, s = K.lattice_geometry(x, E, a, with_s=True)
    consts, taps = torch.from_numpy(t_lattice._chain_consts(d)).to(cuda_device), [float(t) for t in dk.coeffs]
    for r in range(ranks):
        wr = w[r * n_loc:(r + 1) * n_loc].contiguous()
        first = r * n_loc * (d + 1)
        kplan = KC.chain_build(h1, h2, s, wr, consts, taps, None, first)
        pplan = KC.chain_build_plain(h1, h2, s, wr, consts, taps, None, first)
        again = KC.chain_build(h1, h2, s, wr, consts, taps, None, first)
        torch.cuda.synchronize()
        for f in KC.ChainPlan._fields:
            assert torch.equal(getattr(kplan, f), getattr(pplan, f)), f
            assert torch.equal(getattr(kplan, f), getattr(again, f)), f
    if ranks == 1:
        one = types.SimpleNamespace(size=1, psum_scatter=lambda t: t[0].clone(), all_gather_blocks=lambda t: t[None])
        v = torch.randn((n_loc, 11), generator=torch.Generator(device=cuda_device).manual_seed(0), device=cuda_device)
        whole = t_lattice.build_plan_chain(x, dk.coeffs, dk.variance)
        for transpose in (False, True):
            want = t_lattice.apply_plan_chain(whole, v, dk.coeffs, transpose)
            assert torch.equal(t_lattice.apply_plan_chain(kplan, v, dk.coeffs, transpose, axis=one), want)
    blocks = torch.randn((3, 1000, 4), generator=torch.Generator(device=cuda_device).manual_seed(1),
                         device=cuda_device)
    assert torch.equal(KC.chain_unblock(blocks, 11), KC.chain_unblock_plain(blocks, 11))


@pytest.mark.parametrize("capacity", ["untrimmed", "overflowing"])
def test_chain_build_orders_points_with_equal_keys_by_h2(cuda_device, capacity):
    """Distinct points that share their axis-0 key (chain_fixtures.colliding_inputs): the
    rank stage's runs of equal keys put in h2 order, every field bit for bit against the plain build."""
    h1, h2, s, w = (t.to(cuda_device) for t in colliding_inputs())
    consts = torch.from_numpy(t_lattice._chain_consts(w.shape[1] - 1)).to(cuda_device)
    taps = [float(t) for t in _dk("rbf", 1).coeffs]
    occ = int(KC.chain_build_plain(h1, h2, s, w, consts, taps).n_lattice)
    cap = None if capacity == "untrimmed" else occ - 1
    kplan = KC.chain_build(h1, h2, s, w, consts, taps, cap)
    pplan = KC.chain_build_plain(h1, h2, s, w, consts, taps, cap)
    torch.cuda.synchronize()
    for f in KC.ChainPlan._fields:
        assert torch.equal(getattr(kplan, f), getattr(pplan, f)), f


@pytest.mark.parametrize("c", [1, 11, 17, 33])
@pytest.mark.parametrize("d", [1, 11, 18, 31, 40])
def test_filter_grad_matches_its_twin_bit_for_bit(cuda_device, d, c):
    """K5's teams of 4 lanes with their columns in registers (c = 1, 11) and of 8 with a column loop (c = 17,
    33), d+1 up to 16, 32 and the wide path past 32, on random rows of random tables: equal to the plain
    twin and to a second run."""
    rng = np.random.default_rng(d * 100 + c)
    n, M = 3001, 5000
    ref = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(cuda_device)
    E = torch.from_numpy(t_lattice.build_rotation(d, 1.0)).to(cuda_device)
    seg = torch.from_numpy(rng.integers(0, M, size=(n, d + 1)).astype(np.int32)).to(cuda_device)
    v, g = (torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32)).to(cuda_device) for _ in range(2))
    tf, tb = (torch.from_numpy(rng.normal(size=(M, c)).astype(np.float32)).to(cuda_device) for _ in range(2))
    args = (ref, E, seg, v, g, tf, tb, t_lattice.SLICE_NORM(d))
    gk = K.lattice_filter_grad(*args)
    gp = K.lattice_filter_grad_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(gk, gp) and torch.equal(gk, K.lattice_filter_grad(*args))


def test_chain_wrappers_refuse_wrong_inputs(cuda_device):
    dk = _dk("rbf", 1)
    x = _positions(50, 3, 11, cuda_device)
    plan = t_lattice.build_plan_chain(x, dk.coeffs, dk.variance)
    with pytest.raises(ValueError):
        KC.chain_splat(plan, torch.zeros((49, 2), device=cuda_device))
    with pytest.raises(ValueError):
        KC.chain_splat(plan, torch.zeros((50, 2), dtype=torch.float64, device=cuda_device))
    table = KC.chain_splat(plan, torch.zeros((50, 2), device=cuda_device))
    with pytest.raises(ValueError):
        KC.chain_axis(table, plan.tapw[0], plan.gather[0], plan.n_lattice, [0.5, 1.0, 0.5, 0.1, 0.1])
    with pytest.raises(ValueError):
        KC.chain_build(plan.slice_idx.reshape(-1), plan.slice_idx.reshape(-1), plan.slice_idx.reshape(-1),
                       plan.weights, torch.zeros((3, 3), dtype=torch.int32, device=cuda_device), list(dk.coeffs))


def _count_positions(case, device):
    """K8's cases: a hot key set (2M identical points), all keys distinct at half the table's load, n
    not a multiple of the block, and normal positions at d = 1, 11 and 18."""
    rng = np.random.default_rng(12)
    if case == "hot":
        x = np.tile(rng.normal(size=(1, 11)).astype(np.float32), (2_000_000, 1))
    elif case == "distinct":  # 2^18 points 50 apart: 2^20 distinct keys in the 2^21 slots
        x = (50.0 * np.arange(2**18)[:, None] + rng.uniform(0, 1, size=(2**18, 3))).astype(np.float32)
    elif case == "ragged":
        x = rng.normal(size=(1037, 5)).astype(np.float32)
    else:
        d = int(case[1:])
        x = (rng.normal(size=(50_001, d)) * (1.0 if d < 9 else 0.3)).astype(np.float32)
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize("case", ["hot", "distinct", "ragged", "d1", "d11", "d18"])
def test_count_matches_plain_exactly(cuda_device, case):
    """K8 (each key's slot read with a plain load before any atomicCAS, one atomicAdd of a block's claims)
    gives its plain version's count exactly."""
    x = _count_positions(case, cuda_device)
    n, d = x.shape
    dk = _dk("rbf", 1)
    E, a, _, _ = t_lattice._lattice_constants(d, dk.coeffs, dk.variance, cuda_device)
    before = K.lattice_count.launches
    got = K.lattice_count(x, E, a)
    torch.cuda.synchronize()
    want = int(K.count_plain(x, E, a))
    assert int(got) == want and K.lattice_count.launches == before + 1
    if case == "hot":
        assert want == d + 1
    if case == "distinct":
        assert want == n * (d + 1)


@pytest.mark.parametrize("c", [1, 11, 16, 17])
@pytest.mark.parametrize("capacity", [None, "trim", "over"])
def test_chain_splat_matches_plain_on_every_run_class(cuda_device, c, capacity):
    """K3'b against its plain version bit for bit on a built plan with short, mid and long runs
    (untrimmed, trimmed, past the capacity: the first Mc rows), across column tiles of 16, and on a plan of
    the run lengths 1 .. 3,072."""
    dk = _dk("rbf", 1)
    x = torch.from_numpy(chain_class_positions()).to(cuda_device)
    occ = int(t_lattice.build_plan_chain(x, dk.coeffs, dk.variance).n_lattice)
    cap = {None: None, "trim": occ + 3, "over": occ - 5}[capacity]
    gen = torch.Generator(device=cuda_device).manual_seed(c)
    plan = t_lattice.build_plan_chain(x, dk.coeffs, dk.variance, cap)
    live = min(int(plan.n_lattice), plan.cnt.shape[0])
    assert int(plan.n_mid) > 0 and int(plan.n_long) > 0
    v = torch.randn((x.shape[0], c), generator=gen, device=cuda_device)
    before = KC.chain_splat.launches
    got = KC.chain_splat(plan, v)
    torch.cuda.synchronize()
    assert torch.equal(got[:live], KC.chain_splat_plain(plan, v)[:live])
    synth = synthetic_chain_plan(RUN_LENGTHS, 700, seed=c, device=cuda_device)
    v = torch.randn((700, c), generator=gen, device=cuda_device)
    got = KC.chain_splat(synth, v)
    torch.cuda.synchronize()
    assert torch.equal(got[:len(RUN_LENGTHS)], KC.chain_splat_plain(synth, v)[:len(RUN_LENGTHS)])
    assert KC.chain_splat.launches == before + 2


# A plan past 4M contributions, as houseelectric's (15.7M): two rows of ~2M in thousands of pieces each, so
# the long-row combine strides over many pieces a lane, beside runs of every other class.
LARGE_RUN_LENGTHS = [1, 33, 2_100_000, 32, 1025, 2_200_001, 3, 1024, 2]


@pytest.mark.parametrize("c", [1, 11, 16, 17])
def test_chain_splat_matches_plain_past_4m_contributions(cuda_device, c):
    """K3'b against its plain version bit for bit on a plan of 4.3M contributions, at one and two column
    tiles."""
    plan = synthetic_chain_plan(LARGE_RUN_LENGTHS, 100_000, seed=c, device=cuda_device)
    assert plan.splat_points.shape[0] > 4 * 2**20 and int(plan.n_pieces) > 4000
    v = torch.randn((100_000, c), generator=torch.Generator(device=cuda_device).manual_seed(c),
                    device=cuda_device)
    before = KC.chain_splat.launches
    got = KC.chain_splat(plan, v)
    torch.cuda.synchronize()
    live = len(LARGE_RUN_LENGTHS)
    assert torch.equal(got[:live], KC.chain_splat_plain(plan, v)[:live])
    assert KC.chain_splat.launches == before + 1


# ---- K10, the CG body, and the exact backward on the row lists -------------------------------------


def _cg_problem(dev, n, t, seed=0):
    """An SPD operator (dense), its Woodbury preconditioner and a right-hand side, on the card."""
    from simplex_gp_torch.linalg import pivoted_cholesky as t_pc

    rng = np.random.default_rng(seed)
    L = torch.from_numpy((rng.normal(size=(n, 20)) * np.geomspace(0.3, 0.01, 20)).astype(np.float32)).to(dev)
    B = torch.from_numpy(rng.normal(size=(n, 64)).astype(np.float32) / 8).to(dev)
    A = L @ L.T + B @ B.T + torch.eye(n, device=dev)
    P = t_pc.make_preconditioner(L, torch.tensor(1.0, device=dev), n)
    b = torch.from_numpy(rng.normal(size=(n, t)).astype(np.float32)).to(dev)
    return A, P, b


@pytest.mark.parametrize("n,t,m", [(3000, 1, 0), (3000, 11, 100), (70001, 11, 20)])
def test_cg_kernels_match_plain_bit_for_bit(cuda_device, n, t, m):
    """Each K10 kernel against its plain twin from one state three iterations into a solve, bit for bit
    (every dot sums in one fixed order; every multiply and add is round-to-nearest on both sides)."""
    from simplex_gp_torch.kernels import cg as K10
    from simplex_gp_torch.linalg import cg as t_cg

    A, P, b = _cg_problem(cuda_device, n, t)
    loop = t_cg.CGLoop(lambda V: A @ V, b, tol=1e-6, precond=P, tridiag_m=m,
                       shift=(torch.tensor(0.9, device=cuda_device), torch.tensor(0.1, device=cuda_device)))
    for _ in range(3):
        loop.iteration()
    kp = (A @ loop.p).contiguous()
    both = _kernel_and_twin
    ka = both(K10.cg_dot, K10.cg_dot_plain, [loop.p, kp, loop.part_pap, loop.scale, loop.noise, loop.ap], (2, 5))
    part_pap, ap = ka[2], ka[5]
    ka = both(K10.cg_step_x, K10.cg_step_x_plain, [part_pap, loop.x, loop.r, loop.p, ap, loop.fs, loop.is_,
                                                   loop.part_rr], (1, 2, 5, 6, 7))
    x, r, fs, is_, part_rr = ka[1], ka[2], ka[5], ka[6], ka[7]
    part_g = both(K10.cg_utr, K10.cg_utr_plain, [loop.U, r, loop.part_g], (2,))[2]
    G2 = both(K10.cg_fold, K10.cg_fold_plain, [part_g, loop.w, loop.G2], (2,))[2]
    ka = both(K10.cg_precond, K10.cg_precond_plain, [loop.U, G2, r, loop.p_noise, loop.z, loop.part_rz], (4, 5))
    z, part_rz = ka[4], ka[5]
    rec = [loop.A, loop.B, loop.TM] if m else [None, None, None]
    mutable = (4, 5, 6, 7, 8, 9, 10) if m else (4, 5, 6, 7)
    both(K10.cg_step_p, K10.cg_step_p_plain, [part_rz, part_rr, x, z, loop.p, loop.x_best, fs, is_, *rec,
                                              loop.rules], mutable)
    both(K10.cg_init, K10.cg_init_plain, [part_rr, part_rz, fs, is_, 500], (2, 3))


def _kernel_and_twin(kernel, plain, args, mutable):
    """``kernel`` and its plain twin on clones of the ``mutable`` arguments: those equal bit for bit after."""
    ka = [a.clone() if i in mutable else a for i, a in enumerate(args)]
    pa = [a.clone() if i in mutable else a for i, a in enumerate(args)]
    kernel(*ka)
    plain(*pa)
    torch.cuda.synchronize()
    for i in mutable:
        assert torch.equal(ka[i], pa[i]), (kernel.__name__, i)
    return ka


@pytest.mark.parametrize("P", [1, 2, 4])
def test_cg_reducing_kernels_fold_every_ranks_partials(cuda_device, P):
    """K10': cg_step_x, cg_step_p and cg_init given every rank's partials stacked (P, nb, t) -- two as views
    of one (P, 2, nb, t) gather, as the sharded loop passes them -- against their plain twins bit for bit,
    from a state three iterations into a solve; at P = 1 also against the (nb, t) call.  cg_fold given every
    rank's (P, nbu, k, t) U^T r partials and the ranks' (P, 1, k, t) G, against its twin bit for bit."""
    from simplex_gp_torch.kernels import cg as K10
    from simplex_gp_torch.linalg import cg as t_cg

    A, Pre, b = _cg_problem(cuda_device, 70001, 11)
    loop = t_cg.CGLoop(lambda V: A @ V, b, tol=1e-6, precond=Pre, tridiag_m=20)
    for _ in range(3):
        loop.iteration()
    nb = loop.part_pap.shape[0]
    gen = torch.Generator(device=cuda_device).manual_seed(P)
    rr, rz = (torch.rand((P, 2, nb, 11), generator=gen, device=cuda_device) + 0.5).transpose(0, 1)
    kp = (A @ loop.p).contiguous()
    calls = [(K10.cg_step_x, K10.cg_step_x_plain, lambda a, b_: [a, loop.x, loop.r, loop.p, kp, loop.fs, loop.is_,
                                                                 loop.part_rr], (1, 2, 5, 6, 7)),
             (K10.cg_step_p, K10.cg_step_p_plain, lambda a, b_: [b_, a, loop.x, loop.z, loop.p, loop.x_best, loop.fs,
                                                                 loop.is_, loop.A, loop.B, loop.TM, loop.rules],
              (4, 5, 6, 7, 8, 9, 10)),
             (K10.cg_init, K10.cg_init_plain, lambda a, b_: [a, b_, loop.fs, loop.is_, 500], (2, 3))]
    # cg_fold given every rank's U^T r partials, (P, nb, k, t), and the sharded loop's (P, 1, k, t) ranks' G.
    nbu, k = loop.part_g.shape[:2]
    pg = torch.rand((P, nbu, k, 11), generator=gen, device=cuda_device) - 0.5
    calls += [(K10.cg_fold, K10.cg_fold_plain, lambda a, b_: [pg, loop.w, loop.G2], (2,)),
              (K10.cg_fold, K10.cg_fold_plain, lambda a, b_: [pg[:, :1], loop.w, loop.G2], (2,))]
    for kernel, plain, args, mutable in calls:
        ka = _kernel_and_twin(kernel, plain, args(rr, rz), mutable)
        if P == 1 and kernel is not K10.cg_fold:
            k1 = [a.clone() if i in mutable else a for i, a in enumerate(args(rr[0].clone(), rz[0].clone()))]
            kernel(*k1)
            torch.cuda.synchronize()
            assert all(torch.equal(ka[i], k1[i]) for i in mutable), kernel.__name__


@pytest.mark.parametrize("t,m", [(1, 0), (11, 30)])
def test_cg_graph_solve_equals_the_eager_kernel_loop(cuda_device, t, m):
    """The CUDA-graph replay of one iteration gives the eager kernel loop's iterations and bits; two solves
    repeat bit for bit; the plain loop on the card agrees to f32 roundoff."""
    from simplex_gp_torch.linalg import cg as t_cg

    A, P, b = _cg_problem(cuda_device, 5000, t, seed=1)
    kw = dict(tol=1e-5, max_iters=300, precond=P, tridiag_m=m)
    eager = t_cg.cg_solve(lambda V: A @ V, b, **kw)
    replays = t_cg.cg_solve.graph_replays
    graph = t_cg.cg_solve(lambda V: A @ V, b, graph=True, **kw)
    assert t_cg.cg_solve.graph_replays - replays == eager.iterations - 1
    again = t_cg.cg_solve(lambda V: A @ V, b, graph=True, **kw)
    assert eager.iterations == graph.iterations == again.iterations >= 10
    for u, v, w in zip(eager, graph, again):
        if isinstance(u, torch.Tensor):
            assert torch.equal(u, v) and torch.equal(v, w)
    cpu = t_cg.cg_solve(lambda V: A.cpu() @ V, b.cpu(), tol=1e-5, max_iters=300, tridiag_m=m,
                        precond=t_pc_to_cpu(P))
    assert abs(cpu.iterations - eager.iterations) <= 1
    assert float((cpu.x - eager.x.cpu()).norm() / cpu.x.norm()) < 1e-4


def t_pc_to_cpu(P):
    return type(P)(*(t.cpu() for t in P))


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("capacity", [None, "trim", "over"])
def test_row_list_apply_with_its_table_matches_plain(cuda_device, capacity, transpose):
    """K9 over one window with transpose and return_table (the exact backward's applies): the output and the
    live rows of the table bit for bit against the plain K9; past the capacity the output is NaN."""
    x = torch.from_numpy(chain_class_positions()).to(cuda_device)
    dk = t_kernels.matern_kernel(1.5, 1)
    occ = int(t_lattice.count_lattice_points(x, dk.variance, dk.coeffs))
    cap = {None: None, "trim": occ + 3, "over": occ - 5}[capacity]
    plan = t_lattice.wide_plan(t_lattice.build_plan_join(x, dk.coeffs, dk.variance, cap))
    v = torch.randn((x.shape[0], 11), generator=torch.Generator(device=cuda_device).manual_seed(3),
                    device=cuda_device)
    out, table = t_lattice.apply_plan_rows(plan, v, dk.coeffs, transpose, return_table=True)
    pout, ptable = K.apply_cols_plain(*plan[:4], v, list(dk.coeffs), t_lattice.SLICE_NORM(x.shape[1]), 11,
                                      plan.rows, transpose, True)
    torch.cuda.synchronize()
    if capacity == "over":
        assert bool(torch.isnan(out).all() and torch.isnan(pout).all() and torch.isfinite(table).all())
        return
    live = int(plan.n_lattice)
    assert torch.equal(out, pout) and torch.equal(table[:live], ptable[:live])
    again = t_lattice.apply_plan_rows(plan, v, dk.coeffs, transpose, return_table=True)
    assert torch.equal(again[0], out) and torch.equal(again[1][:live], table[:live])


def test_exact_backward_repeats_bit_for_bit_on_the_card(cuda_device):
    """Two NLML gradients at the same inputs are bit-equal: the backward's applies have no atomics."""
    from simplex_gp_torch.linalg import mll as t_mll

    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(4000, 6)).astype(np.float32)).to(cuda_device)
    y = torch.from_numpy(rng.normal(size=4000).astype(np.float32)).to(cuda_device)
    z = torch.from_numpy(rng.choice([-1.0, 1.0], size=(4000, 10)).astype(np.float32)).to(cuda_device)
    dk = t_kernels.matern_kernel(1.5, 1)
    launches = K.lattice_apply.launches
    grads = []
    for _ in range(2):
        params = {k: torch.tensor(v, device=cuda_device, requires_grad=True) for k, v in
                  (("inv_ell", np.full(6, 0.8, np.float32)), ("outputscale", np.float32(1.0)),
                   ("noise", np.float32(0.2)), ("mean", np.float32(0.0)))}
        loss = t_mll.lattice_nlml(dk, t_mll.BBMMConfig(), params, x, y, z)
        grads.append(torch.autograd.grad(loss, list(params.values())) + (loss.detach(),))
    assert K.lattice_apply.launches == launches
    assert all(torch.equal(u, v) for u, v in zip(*grads))


# K6's one-step tolerance (chip_smoke.py's K6_STEP_REL): the plain step sums d2 and L.l_piv in torch's order.
K6_STEP_REL = 1e-5


def _k6_case(n, dim, nu, device):
    ref = torch.from_numpy(seeded(n, dim, 1, seed=7)[0] * (1.0 if dim < 9 else 0.4)).to(device)
    s = torch.tensor(1.3, device=device)
    return ref, s * torch.ones(n, device=device), s


@pytest.mark.parametrize("n,dim,k,nu", [(3000, 5, 40, 0.0), (3000, 5, 40, 1.5), (70001, 11, 100, 2.5)])
def test_pivot_factor_is_its_steps_and_the_row_major_loop(cuda_device, n, dim, k, nu):
    """The device factor (column-major L, the argmax fused into each step, k launches from one host call)
    equals the loop of its one-step kernel and the same kernel's loop over a row-major L with torch.argmax
    a pivot, bit for bit; each step, from the kernel's own state, is within K6_STEP_REL of the plain step,
    whose argmax is the kernel's next pivot."""
    ref, diag, s = _k6_case(n, dim, nu, cuda_device)
    refc = KP.column_major(ref)
    launches = pivot_column.launches
    L, pivots = KP.pivot_factor(ref, diag, s, nu, k)
    torch.cuda.synchronize()
    assert L.T.is_contiguous()
    assert pivot_column.launches - launches == k
    Ls, ps = torch.zeros((k, n), device=cuda_device).T, torch.zeros(k, dtype=torch.int64, device=cuda_device)
    Lr, pr = torch.zeros((n, k), device=cuda_device), torch.zeros(k, dtype=torch.int64, device=cuda_device)
    d, dr, d0 = diag.clone(), diag.clone(), diag.max()
    piv, nxt = torch.argmax(d), torch.zeros((), dtype=torch.int64, device=cuda_device)
    worst = 0.0
    for j in range(k):
        Lp, pp = Ls.clone(), ps.clone()
        dp = pivot_column_plain(refc, Lp, d, piv, j, s, d0, nu, pp)
        d = pivot_column(refc, Ls, d, piv, j, s, d0, nu, ps, next_piv=nxt)
        dr = pivot_column(ref, Lr, dr, torch.argmax(dr), j, s, d0, nu, pr)
        worst = max(worst, float((Ls[:, j] - Lp[:, j]).norm() / Lp[:, j].norm().clamp_min(1e-30)),
                    float((d - dp).norm() / dp.norm().clamp_min(1e-30)))
        assert int(torch.argmax(dp)) == int(nxt), j
        piv = nxt.clone()
    assert worst <= K6_STEP_REL
    assert torch.equal(L, Ls) and torch.equal(pivots, ps)
    assert torch.equal(L, Lr) and torch.equal(pivots, pr)


def test_pivot_factor_makes_no_host_sync(cuda_device):
    """The whole factor, and pivoted_cholesky_features around it, under set_sync_debug_mode("error")."""
    from simplex_gp_torch.linalg.pivoted_cholesky import pivoted_cholesky_features

    ref, diag, s = _k6_case(20000, 11, 1.5, cuda_device)
    KP.pivot_factor(ref, diag, s, 1.5, 8)  # the build, outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        L, pivots = KP.pivot_factor(ref, diag, s, 1.5, 100)
        pc = pivoted_cholesky_features(ref, diag, 1.5, s, 100)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(pc.L, L) and torch.equal(pc.pivots, pivots)


@pytest.mark.parametrize("nu", [0.0, 1.5])
def test_pivot_column_at_column_major_with_the_fused_argmax(cuda_device, nu):
    """K6' on the factor's layout: given the pivot's rows (a row of ref, a column of L^T) it is K6 bit for bit,
    the next local argmax included; on a rank without the pivot (-1) it is the plain step."""
    n, k = 3000, 40
    ref, diag, s = _k6_case(n, 5, nu, cuda_device)
    ref = KP.column_major(ref)
    L = torch.zeros((k, n), device=cuda_device).T
    piv = torch.zeros(k, dtype=torch.int64, device=cuda_device)
    d0 = diag.max()
    for j in range(k - 1):
        diag = pivot_column_plain(ref, L, diag, torch.argmax(diag), j, s, d0, nu, piv)
    p = torch.argmax(diag)
    row = (ref[p].contiguous(), L[p].contiguous(), diag[p].reshape(1).clone())
    na, nb = (torch.zeros((), dtype=torch.int64, device=cuda_device) for _ in range(2))
    La, Lb, pa, pb = L.T.clone().T, L.T.clone().T, piv.clone(), piv.clone()
    da = pivot_column(ref, La, diag, p, k - 1, s, d0, nu, pa, row, next_piv=na)
    db = pivot_column(ref, Lb, diag, p, k - 1, s, d0, nu, pb, next_piv=nb)
    torch.cuda.synchronize()
    assert torch.equal(La, Lb) and torch.equal(da, db) and torch.equal(pa, pb) and int(na) == int(nb)
    assert int(na) == int(torch.argmax(da))
    away = torch.tensor(-1, dtype=torch.int64, device=cuda_device)
    Lc, Ld, pc, pd = L.T.clone().T, L.T.clone().T, piv.clone(), piv.clone()
    dc = pivot_column(ref, Lc, diag, away, k - 1, s, d0, nu, pc, row, next_piv=na)
    dd = pivot_column_plain(ref, Ld, diag, away, k - 1, s, d0, nu, pd, row, next_piv=nb)
    torch.cuda.synchronize()
    assert float((Lc - Ld).norm() / Ld.norm()) < K6_STEP_REL and float((dc - dd).norm() / dd.norm()) < K6_STEP_REL
    assert int(pc[k - 1]) == -1 == int(pd[k - 1]) and int(na) == int(nb)


def _axes_loop(table, plan, taps):
    d = plan.gather.shape[0]
    for j in range(d + 1):
        table = KC.chain_axis(table, plan.tapw[j], plan.gather[j] if j < d else None, plan.n_lattice, taps)
    return table


@pytest.mark.parametrize("c", [1, 11, 17])
@pytest.mark.parametrize("case", ["synthetic", "synthetic order 3", "elevators", "trim", "over"])
def test_fused_chain_axes_match_plain_and_the_axis_launches(cuda_device, case, c):
    """K3'c fused (one launch, a grid barrier between axes; order 1 its own kernel, order 3 the generic
    one) equals its plain twin and the d+1 per-axis launches over the live rows, bit for bit; chain_apply
    counts one fused launch, no per-axis one, and a CUDA graph of the apply replays to the same bits."""
    order = 3 if case.endswith("order 3") else 1
    dk = _dk("matern", order)
    taps = [float(t) for t in dk.coeffs]
    if case.startswith("synthetic"):
        plan = synthetic_chain_plan(RUN_LENGTHS, 500, seed=c, device=cuda_device, axes=(7, order))
    else:
        x = _positions(10623, 18, 12, cuda_device) if case == "elevators" else \
            torch.from_numpy(chain_class_positions()).to(cuda_device)
        occ = int(t_lattice.build_plan_chain(x, dk.coeffs, dk.variance).n_lattice)
        cap = {"elevators": None, "trim": occ, "over": occ - 1}[case]
        plan = t_lattice.build_plan_chain(x, dk.coeffs, dk.variance, cap)
    live = min(int(plan.n_lattice), plan.cnt.shape[0])
    gen = torch.Generator(device=cuda_device).manual_seed(c)
    table = torch.randn((plan.cnt.shape[0], c), generator=gen, device=cuda_device)
    want = KC.chain_axes_plain(table, plan, taps)
    loop = _axes_loop(table, plan, taps)
    before = (KC.chain_axes.launches, KC.chain_axis.launches)
    got = KC.chain_axes(table.clone(), plan, taps)
    torch.cuda.synchronize()
    assert (KC.chain_axes.launches - before[0], KC.chain_axis.launches - before[1]) == (1, 0)
    assert torch.equal(got[:live], want[:live]) and torch.equal(got[:live], loop[:live])
    if case.startswith("synthetic"):
        return
    v = torch.randn((plan.weights.shape[0], c), generator=gen, device=cuda_device)
    before = (KC.chain_axes.launches, KC.chain_axis.launches)
    out = t_lattice.apply_plan_chain(plan, v, dk.coeffs)
    assert (KC.chain_axes.launches - before[0], KC.chain_axis.launches - before[1]) == (1, 0)
    pout = KC.chain_apply_plain(plan, v, taps, t_lattice.SLICE_NORM(plan.weights.shape[1] - 1))
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin()
        replayed = t_lattice.apply_plan_chain(plan, v, dk.coeffs)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    if case == "over":
        assert bool(torch.isnan(out).all() and torch.isnan(pout).all() and torch.isnan(replayed).all())
    else:
        assert torch.equal(out, pout) and torch.equal(replayed, out)


@pytest.mark.parametrize("c", [1, 11, 17])
@pytest.mark.parametrize("case", ["synthetic", "synthetic order 3", "elevators", "trim", "over"])
def test_transposed_chain_axes_and_apply_match_plain(cuda_device, case, c):
    """K3'c transposed (the fused axes' kernel run in reverse axis order over the inverse transitions) and
    its maps equal their plain twins bit for bit over the live rows; the transposed chain apply (maps, splat,
    transposed axes, slice from one host call) equals its plain version, output and final-order table, counts
    one transposed launch and no forward one, and replays from a CUDA graph to the same bits; past the
    capacity its output is all NaN."""
    order = 3 if case.endswith("order 3") else 1
    dk = _dk("matern", order)
    taps = [float(t) for t in dk.coeffs]
    if case.startswith("synthetic"):
        plan = synthetic_chain_plan(RUN_LENGTHS, 500, seed=c, device=cuda_device, axes=(7, order))
    else:
        x = _positions(10623, 18, 12, cuda_device) if case == "elevators" else \
            torch.from_numpy(chain_class_positions()).to(cuda_device)
        occ = int(t_lattice.build_plan_chain(x, dk.coeffs, dk.variance).n_lattice)
        cap = {"elevators": None, "trim": occ, "over": occ - 1}[case]
        plan = t_lattice.build_plan_chain(x, dk.coeffs, dk.variance, cap)
    live = min(int(plan.n_lattice), plan.cnt.shape[0])
    tmap = KC.chain_maps(plan)
    assert torch.equal(tmap, KC.chain_maps_plain(plan.gather))
    gen = torch.Generator(device=cuda_device).manual_seed(c)
    table = torch.randn((plan.cnt.shape[0], c), generator=gen, device=cuda_device)
    want = KC.chain_axes_transpose_plain(table, plan, taps, tmap)
    before = (KC.chain_axes_transpose.launches, KC.chain_axes.launches)
    got = KC.chain_axes_transpose(table.clone(), plan, taps, tmap)
    again = KC.chain_axes_transpose(table.clone(), plan, taps)
    torch.cuda.synchronize()
    assert (KC.chain_axes_transpose.launches - before[0], KC.chain_axes.launches - before[1]) == (2, 0)
    assert torch.equal(got[:live], want[:live]) and torch.equal(again[:live], got[:live])
    if case.startswith("synthetic"):
        return
    g = torch.randn((plan.weights.shape[0], c), generator=gen, device=cuda_device)
    norm = t_lattice.SLICE_NORM(plan.weights.shape[1] - 1)
    before = (KC.chain_axes_transpose.launches, KC.chain_axes.launches, KC.chain_maps.launches)
    out, tb = t_lattice.apply_plan_chain(plan, g, dk.coeffs, transpose=True, return_table=True)
    assert (KC.chain_axes_transpose.launches - before[0], KC.chain_axes.launches - before[1],
            KC.chain_maps.launches - before[2]) == (1, 0, 1)
    pout, ptb = KC.chain_apply_plain(plan, g, taps, norm, transpose=True, return_table=True)
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin()
        replayed = t_lattice.apply_plan_chain(plan, g, dk.coeffs, transpose=True)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(tb[:live], ptb[:live])
    if case == "over":
        assert bool(torch.isnan(out).all() and torch.isnan(pout).all() and torch.isnan(replayed).all())
    else:
        assert torch.equal(out, pout) and torch.equal(replayed, out)


def test_exact_backward_runs_on_the_cg_chain_plan(cuda_device):
    """The NLML's exact backward on the card: no join plan, K9 or K3; one forward chain apply with its table,
    one transposed (maps, K3'c transposed) and one K5 on the CG's chain plan, and the gradient bit for bit
    twice."""
    from simplex_gp_torch.linalg import mll as t_mll

    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(5000, 7)).astype(np.float32)).to(cuda_device)
    y = torch.from_numpy(rng.normal(size=5000).astype(np.float32)).to(cuda_device)
    z = torch.from_numpy(rng.choice([-1.0, 1.0], size=(5000, 10)).astype(np.float32)).to(cuda_device)
    dk = t_kernels.matern_kernel(1.5, 1)
    counters = (K.lattice_dedup_neighbors, K.join_rows, K.lattice_apply_cols, K.lattice_apply, KC.chain_build,
                KC.chain_maps, KC.chain_axes_transpose, K.lattice_filter_grad)
    grads = []
    for _ in range(2):
        params = {k: torch.tensor(v, device=cuda_device, requires_grad=True) for k, v in
                  (("inv_ell", np.full(7, 0.7, np.float32)), ("outputscale", np.float32(1.0)),
                   ("noise", np.float32(0.2)), ("mean", np.float32(0.0)))}
        loss = t_mll.lattice_nlml(dk, t_mll.BBMMConfig(plan_capacity=40000), params, x, y, z)
        before = [fn.launches for fn in counters]
        grads.append(torch.autograd.grad(loss, list(params.values())) + (loss.detach(),))
        torch.cuda.synchronize()
        assert [fn.launches - b for fn, b in zip(counters, before)] == [0, 0, 0, 0, 0, 1, 1, 1]
    assert all(torch.equal(u, v) for u, v in zip(*grads))


@pytest.mark.parametrize("n,g,r,offset", [(65536, 100, 64, 0), (65536, 100, 64, 1), (70001, 100, 32, 0),
                                          (517, 9, 5, 0), (300, 40, 3, 0)])
def test_ski_interp_team_kernel_matches_plain(cuda_device, n, g, r, offset):
    """K13a's team kernel (U staged once a block, a point's taps once, float4 columns; scalar loads and stores
    when U is off a 16-byte boundary or r is not a multiple of 4) within K13_REL = 1e-5 of interp_plain and
    bit for bit a second call."""
    from simplex_gp_torch.kernels import ski as KS

    gen = torch.Generator().manual_seed(n + r)
    x = torch.randn(n, generator=gen).to(cuda_device)
    buf = torch.randn(g * r + offset, generator=gen).to(cuda_device)
    U = buf[offset:].view(g, r)
    step = ((x.max() - x.min()) / (g - 5) + 1e-12).contiguous()
    gmin = (x.min() - 2 * step).contiguous()
    F = KS.ski_interp(x, gmin, step, U)
    want = KS.interp_plain(x, gmin, step, U)
    torch.cuda.synchronize()
    assert float((F - want).norm() / want.norm()) < 1e-5 and torch.equal(KS.ski_interp(x, gmin, step, U), F)


def _slq_close(diag, off, got):
    """K14's output against float64 eigh of the same band (test_torch_slq_quadrature.py's bound), plus the
    float32 rounding of the output (one ulp)."""
    from test_torch_slq_quadrature import _eigh64

    want, tol = _eigh64(diag.cpu().numpy(), off.cpu().numpy())
    ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    err = np.abs(got.cpu().numpy().astype(np.float64) - want)
    assert np.all(err <= tol + ulp), (err, tol + ulp)


@pytest.mark.parametrize("L", [1, 2, 22, 100])
def test_slq_quadrature_matches_float64_eigh_in_either_layout(cuda_device, L):
    """K14 on random SPD tridiagonals against float64 eigh; the step-major (m, p) band through its transposed
    view gives the same bits as the (p, m) rows, and a second call repeats them."""
    from test_torch_slq_quadrature import _random_band

    from simplex_gp_torch.kernels import slq as KQ

    diag, off = (torch.from_numpy(t).to(cuda_device) for t in _random_band(5, L, seed=L))
    got = KQ.slq_quadrature(diag, off)
    stepwise = KQ.slq_quadrature(diag.T.contiguous().T, off.T.contiguous().T)
    torch.cuda.synchronize()
    _slq_close(diag, off, got)
    assert torch.equal(got, stepwise) and torch.equal(got, KQ.slq_quadrature(diag, off))


def test_slq_quadrature_on_cg_records_no_worse_than_float32_eigh(cuda_device):
    """CG records with dead-step padding, a mask that is not a prefix, a zero coupling between live steps and
    a 100-step record with repeated Ritz values: K14 within the float64 bound, and per probe no further from
    float64 eigh than twice the float32 eigh path on the card, plus one float32 ulp."""
    from test_torch_slq_quadrature import _cg_band, _eigh64, _spd

    from simplex_gp_torch.kernels import slq as KQ

    bands = [_cg_band(_spd(96, 9, np.geomspace(1.0, 5.0, 96)), 6, 80, 17, tol=1e-6, max_iters=80)[:2],
             _cg_band(_spd(150, 2, np.geomspace(0.1, 30.0, 150)), 5, 100, 31, tol=1e-5, max_iters=100)[:2]]
    evals = np.concatenate([np.geomspace(1e-2, 1.0, 190), [50.0, 80.0, 100.0, 200.0, 400.0, 1e3, 1e3 + 1e-2, 2e3,
                                                            3e3, 4e3]])
    bands.append(_cg_band(_spd(200, 11, evals), 2, 100, 23, tol=1e-30, max_iters=100, min_iters=100)[:2])
    d, o = (t.copy() for t in bands[0])
    o[0, 3] = 0.0
    o[1, 6:9] = 0.0
    d[1, 7] = 1.0
    bands.append((d, o))
    for dn, on in bands:
        diag, off = torch.from_numpy(dn).to(cuda_device), torch.from_numpy(on).to(cuda_device)
        got = KQ.slq_quadrature(diag, off)
        f32 = KQ.slq_quadrature_plain(diag, off)
        torch.cuda.synchronize()
        _slq_close(diag, off, got)
        want, _ = _eigh64(dn, on)
        ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
        err = np.abs(got.cpu().numpy().astype(np.float64) - want)
        assert np.all(err <= 2.0 * np.abs(f32.cpu().numpy().astype(np.float64) - want) + ulp)


def test_slq_quadrature_cg_forms_the_band_bit_for_bit(cuda_device):
    """The record form (the band formed in the kernel) equals the band form on cg_band's band bit for bit, on
    CG records with padding, a mask that is not a prefix, a zero beta at a live step and a NaN beta at a dead
    one, read through the record's step-major layout."""
    from test_torch_slq_quadrature import _spd

    from simplex_gp_torch.kernels import slq as KQ
    from simplex_gp_torch.linalg import cg as t_cg

    A = torch.from_numpy(_spd(96, 9, np.geomspace(1.0, 50.0, 96)))
    z = torch.from_numpy(np.random.default_rng(3).choice([-1.0, 1.0], size=(96, 7)).astype(np.float32))
    res = t_cg.cg_solve(lambda v: A @ v, z, tol=1e-6, max_iters=60, tridiag_m=60)
    alphas, betas, tmask = res.alphas.clone(), res.betas.clone(), res.tmask.clone()
    assert not bool(tmask.all())
    tmask[5, 1] = False  # a hole
    betas[3, 2] = 0.0  # a zero coupling at a live step
    betas[-1, 0] = float("nan")  # a dead step's beta reaches no output
    rec = tuple(t.to(cuda_device) for t in (alphas, betas, tmask))
    got = KQ.slq_quadrature_cg(*rec)
    want = KQ.slq_quadrature(*KQ.cg_band(*rec))
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.equal(got, want)
    wide = tuple(torch.cat([t[:, :1], t], dim=1) for t in rec)  # the CG's y column first, as the NLML slices it
    assert torch.equal(KQ.slq_quadrature_cg(*(t[:, 1:] for t in wide)), got)


def test_slq_path_on_the_card_reads_nothing_back_and_counts_one_launch_a_span(cuda_device, monkeypatch):
    """logdet_from_cg_tridiag on a CUDA record: no host sync, no torch.linalg.eigh; an NLML under
    trace.recording(): one ``slq.kernel`` a ``slq`` span, and a NaN band gives NaN."""
    from simplex_gp_torch import trace
    from simplex_gp_torch.kernels import slq as KQ
    from simplex_gp_torch.linalg import lanczos as t_lz
    from simplex_gp_torch.linalg import mll as t_mll

    rng = np.random.default_rng(6)
    alphas = torch.from_numpy(rng.uniform(0.5, 2.0, size=(100, 10)).astype(np.float32)).to(cuda_device)
    betas = torch.from_numpy(rng.uniform(0.0, 0.5, size=(100, 10)).astype(np.float32)).to(cuda_device)
    tmask = torch.arange(100, device=cuda_device)[:, None] < torch.arange(20, 30, device=cuda_device)[None, :]
    z2 = torch.full((10,), 4000.0, device=cuda_device)
    t_lz.logdet_from_cg_tridiag(alphas, betas, tmask, z2)  # the build, outside the check

    def refuse(*args, **kwargs):
        raise AssertionError("torch.linalg.eigh called on the card path")

    monkeypatch.setattr(torch.linalg, "eigh", refuse)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = t_lz.logdet_from_cg_tridiag(alphas, betas, tmask, z2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    monkeypatch.undo()
    assert torch.isfinite(got) and torch.equal(got, t_lz.logdet_from_cg_tridiag(alphas, betas, tmask, z2))

    x = torch.from_numpy(rng.normal(size=(3000, 5)).astype(np.float32)).to(cuda_device)
    y = torch.from_numpy(rng.normal(size=3000).astype(np.float32)).to(cuda_device)
    z = torch.from_numpy(rng.choice([-1.0, 1.0], size=(3000, 10)).astype(np.float32)).to(cuda_device)
    params = {k: torch.tensor(v, device=cuda_device, requires_grad=True) for k, v in
              (("inv_ell", np.full(5, 0.8, np.float32)), ("outputscale", np.float32(1.0)),
               ("noise", np.float32(0.2)), ("mean", np.float32(0.0)))}
    trace.clear()
    launches = KQ.slq_quadrature.launches
    with trace.recording():
        for _ in range(2):
            t_mll.lattice_nlml(t_kernels.matern_kernel(1.5, 1), t_mll.BBMMConfig(), params, x, y, z).backward()
    spans = sum(r["name"] == "slq" for r in trace.records())
    counted = trace.counters().get("slq.kernel")
    trace.clear()
    assert spans == 2 and counted == 2 and KQ.slq_quadrature.launches - launches == 2

    nan = KQ.slq_quadrature(alphas.T.contiguous().clone().fill_(float("nan")), betas.T[:, :99].contiguous())
    assert torch.isnan(nan).all()


def test_slq_quadrature_refuses_wrong_inputs(cuda_device):
    from simplex_gp_torch.kernels import slq as KQ

    diag, off = torch.ones((4, 10), device=cuda_device), torch.zeros((4, 9), device=cuda_device)
    for bad in ((diag.double(), off), (diag, off[:, :8]), (diag[0], off[0]), (diag, off.cpu()),
                (torch.ones((1, KQ.MAX_M + 1), device=cuda_device), torch.zeros((1, KQ.MAX_M), device=cuda_device))):
        with pytest.raises(ValueError):
            KQ.slq_quadrature(*bad)
    assert torch.equal(KQ.slq_quadrature(diag, off), torch.zeros(4, device=cuda_device))
    a, b, live = diag.T.contiguous(), off.T.contiguous(), torch.ones((10, 4), dtype=torch.bool, device=cuda_device)
    for bad in ((a, b, live), (a, a, live.int()), (a, a, live[:9]), (a, a.cpu(), live)):
        with pytest.raises(ValueError):
            KQ.slq_quadrature_cg(*bad)
