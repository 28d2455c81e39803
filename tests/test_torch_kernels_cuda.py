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
with cancellation (rel 1e-4).  Positions at d >= 9 are scaled by 0.3, so
the kernel reaches between points and the gradients are not roundoff.
"""

import pytest
import torch
from torch_parity import cuda_device, seeded  # noqa: F401 (fixture)

from simplex_gp_torch.kernels import lattice as K
from simplex_gp_torch.kernels.pivot import pivot_column, pivot_column_plain
from simplex_gp_torch.ops import kernels as t_kernels
from simplex_gp_torch.ops import lattice as t_lattice

pytestmark = pytest.mark.cuda

GRID = [(200, 1, 1, "rbf"), (300, 3, 1, "rbf"), (257, 5, 2, "rbf"), (150, 2, 3, "matern"),
        (400, 9, 1, "matern"), (64, 17, 1, "rbf"), (16599, 17, 1, "rbf")]


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
