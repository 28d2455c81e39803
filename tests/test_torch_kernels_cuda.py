"""Each hand-written CUDA kernel against its plain PyTorch version, on the card.

These tests need a CUDA device and the CUDA toolkit; without a card they
skip (decided at run time by the ``cuda_device`` fixture).  They import no
jax, so they run where the port runs:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda

Tolerances: K1 runs the plain version's IEEE operations in its order, so
hashes and weights are equal; K3's splat adds with atomics in a run-to-run
order (rel 1e-5), transposed or not; K5 fed the plain version's tables sums
its dots and the E product in another order (rel 1e-4, with cancellation in
the weight-gradient differences); K6 sums d2 and L.l_piv in another order
than torch's reductions (rel 1e-5 for one step).  K4 is K3's operator with
the same atomic splat (rel 1e-5), and its occupancy and K8's count are
exact; K7's atomic splat of 2L(1+d) columns feeds a four-term difference
with cancellation (rel 1e-4).  K9 is K3 per column window with the same
atomic splat (rel 1e-5, against its plain version and the unchunked K3).
The bounded K2 numbers its rows as it likes but gives the plain version's
occupancy, and K3 on it the plain operator (rel 1e-5); one row short of
the occupancy, every output is NaN and no launch leaves its table.
K11a numbers its rows as its plain version does, bit for bit; K11b is K3's
splat, blur and slice over column blocks (on one rank, it, its plain version
and K3 each within rel 2e-5 of the operator in float64; over two gloo ranks
sharing the card, rel 1e-5 against the plain version and K3); K6' with the pivot's rows passed in is K6's
arithmetic, bit for bit.  K12, the stacked mixture apply, is K3's splat,
blur and slice over J stacked component tables, with the weighted sum over
components in the slice (rel 1e-5, forward and transposed, outputs and the
read rows of its table); the mixture position gradient is K5 on the stacked
problem (rel 1e-4).  K3', the sort chain, has no atomics: its build is the
plain build bit for bit (the same torch.sort calls on the same keys), its
splat sums each row in the order its plain version does, and its axis
stencils and slice use the plain version's IEEE operations in their order,
so the applies are bit-equal too, and two builds or two applies repeat
bit for bit; against K3 it takes the chain-vs-join bound, rel 2e-5.  K3'b is
held bit for bit on runs of every length class (short, mid, long),
across column tiles, and on a plan past 4M contributions.  K8's count is exact on a hot key set, all keys
distinct, a ragged last block and d = 1, 11, 18.  The
Snelson gate (test_torch_snelson.py's prediction test) runs on the card
too, through the kernels.
Positions at d >= 9 are scaled by 0.3, so the kernel reaches between points
and the gradients are not roundoff.
"""

import numpy as np
import pytest
import torch
from chain_fixtures import RUN_LENGTHS, chain_class_positions, synthetic_chain_plan
from torch_parity import cuda_device, seeded  # noqa: F401 (fixture)

from simplex_gp_torch.kernels import chain as KC
from simplex_gp_torch.kernels import lattice as K
from simplex_gp_torch.kernels import mixture as KM
from simplex_gp_torch.kernels.pivot import pivot_column, pivot_column_plain
from simplex_gp_torch.ops import filter as t_filter
from simplex_gp_torch.ops import kernels as t_kernels
from simplex_gp_torch.ops import lattice as t_lattice

pytestmark = pytest.mark.cuda

GRID = [(200, 1, 1, "rbf"), (300, 3, 1, "rbf"), (257, 5, 2, "rbf"), (150, 2, 3, "matern"),
        (400, 9, 1, "matern"), (64, 17, 1, "rbf"), (16599, 17, 1, "rbf")]


# K11b and K3 (float32 atomic splats) against the operator in float64.  Measured on an H100 at the
# widest case (16,599 x 17) by `simplex_gp_torch/kernel_times.py --sharded-f64`, 1,800 comparisons at
# c = 1: median 1.5e-6, 99th percentile 6.8e-6, max 1.13e-5; at c = 11 at most 3.5e-6.  Two of the
# splats compared with each other reached 1.19e-5 there.  The bound is the chain-vs-join bound that
# chip_smoke.py holds K3 to against the same float64 operator (LARGE_N_REL).
SHARDED_F64_REL = 2e-5

def _dk(kind, order):
    return t_kernels.rbf_kernel(order) if kind == "rbf" else t_kernels.matern_kernel(1.5, order)


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
    assert float((gr_k - gr_p).norm() / gr_p.norm()) < 1e-4


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
    assert float((kout - pout).norm() / pout.norm()) < 1e-5
    exact_fit, fit_nl = K.lattice_filter_once(x, E, a, oh1, oh2, v, dk.coeffs, norm, nl)
    assert int(fit_nl) == nl and float((exact_fit - pout).norm() / pout.norm()) < 1e-5
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
    gp = K.deriv_grad_plain(plan.seg_ids, plan.weights, plan.neighbors, ref, src, g, dk.deriv_coeffs, norm,
                            scale)
    torch.cuda.synchronize()
    assert K.lattice_deriv_grad.launches == before + 1
    assert float((gk - gp).norm() / gp.norm()) < 1e-4


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
    torch.cuda.synchronize()
    assert K.lattice_apply_cols.launches == before + 1
    assert float((kout - pout).norm() / pout.norm()) < 1e-5
    assert float((kout - whole).norm() / whole.norm()) < 1e-5


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
    to the operator in float64 (K3's plain version on K11a's plan with v in float64).  K11b and K3 are
    float32 atomic splats whose order changes from run to run, each within SHARDED_F64_REL of the
    float64 operator (see its note); held to each other at rel 1e-5, two of them failed once in 136
    runs."""
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
        pout, ptab = K.apply_sharded_plain(seg, w, nb, v, dk.coeffs, norm, axis, transpose, True)
        whole, wtab = K.lattice_apply(seg, w, nb, nl, v, dk.coeffs, norm, transpose, True)
        exact, etab = K.apply_plain(seg, w, nb, v.double(), dk.coeffs, norm, transpose, True)
        torch.cuda.synchronize()
        rows = seg.long()  # rows past n_lattice are undefined in the kernels' tables
        for got, want in ((kout, exact), (pout, exact), (whole, exact),
                          (ktab[rows], etab[rows]), (ptab[rows], etab[rows]), (wtab[rows], etab[rows])):
            assert float((got.double() - want).norm() / want.norm()) < SHARDED_F64_REL
    assert K.lattice_apply_sharded.launches == before + 2


def test_sharded_apply_two_gloo_ranks_on_the_card(cuda_device):
    """K11b over two gloo ranks sharing the card, c = 5 (padded to 6) and 11: each rank against its plain
    version, and the ranks' rows against K3 on one process (rel 1e-5); the same plan on both ranks."""
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
                k, p = r[(c, transpose)]["kernel"], r[(c, transpose)]["plain"]
                assert np.linalg.norm(k - p) / np.linalg.norm(p) < 1e-5
    assert np.array_equal(ranks[0]["neighbors"], ranks[1]["neighbors"])
    assert all(r["launches"] == 4 for r in ranks)


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
    """K12 forward and transposed, with its stacked table, and the stacked K5, against the plain versions."""
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
        k_out, k_tab = KM.lattice_mixture_apply(*args, plan.live, u, taps, norm, mk.weights, transpose, True)
        p_out, p_tab = KM.mixture_apply_plain(*args, u, taps, norm, mk.weights, transpose, True)
        torch.cuda.synchronize()
        assert KM.lattice_mixture_apply.launches == before + 1
        assert float((k_out - p_out).norm() / p_out.norm()) < 1e-5
        assert float((k_tab[rows] - p_tab[rows]).norm() / p_tab[rows].norm()) < 1e-5
        tables.append(k_tab)
    gr_k = t_filter.mixture_position_grad(plan, ref, mk, v, g, *tables)
    cpu = [t.cpu() for t in (ref, v, g, *tables)]
    gr_p = t_filter.mixture_position_grad(t_lattice.MixturePlan(*(t.cpu() for t in plan)), cpu[0], mk, *cpu[1:])
    torch.cuda.synchronize()
    assert float((gr_k.cpu() - gr_p).norm() / gr_p.norm()) < 1e-4


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
    """test_torch_snelson.py::test_snelson_prediction_quality on the card, through K1-K3, K5 and K6."""
    import simplex_gp_torch as T
    from simplex_gp_torch.utils.data import load_snelson

    xs, ys = load_snelson()
    x, y = torch.from_numpy(xs).to(cuda_device), torch.from_numpy(ys).to(cuda_device)
    xt, yt, xe, ye = x[::2], y[::2], x[1::2], y[1::2]
    path = (K.lattice_geometry, K.lattice_dedup_neighbors, K.lattice_apply, K.lattice_filter_grad, pivot_column)
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


@pytest.mark.parametrize("n,r,k", [(257, 5, 7), (1000, 64, 64), (70001, 64, 64)])
def test_ski_kr_kernels_match_plain(cuda_device, n, r, k):
    """K13b, K13c (split over row chunks at n > 1,024, the chunks added in a second pass) and K13d."""
    from simplex_gp_torch.kernels import ski as KS

    R, F, W, G = _ski_inputs(n, r, k, cuda_device)
    before = [fn.launches for fn in (KS.ski_kr_matmul, KS.ski_kr_gram, KS.ski_kr_adjoint)]
    pairs = [(KS.ski_kr_matmul(R, F, W), KS.kr_matmul_plain(R, F, W)),
             (KS.ski_kr_gram(G, R, F), KS.kr_gram_plain(G, R, F)),
             *zip(KS.ski_kr_adjoint(R, F, W, G), KS.kr_adjoint_plain(R, F, W, G))]
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip((KS.ski_kr_matmul, KS.ski_kr_gram, KS.ski_kr_adjoint), before)] == [1] * 3
    for got, want in pairs:
        assert float((got - want).norm() / want.norm()) < 1e-5
    assert torch.equal(KS.ski_kr_gram(G, R, F), pairs[1][0])  # no atomics: bit for bit


@pytest.mark.parametrize("n,g,r", [(3000, 100, 64), (517, 9, 5)])
def test_ski_interp_and_scatter_match_plain(cuda_device, n, g, r):
    """K13a and its backward scatter (shared-memory tables, then global atomics: rel 1e-5)."""
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
    assert float((dU - want).norm() / want.norm()) < 1e-5


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
