"""Each hand-written CUDA kernel against its plain PyTorch version, on the card.

These tests need a CUDA device and the CUDA toolkit; without a card they
skip (decided at run time by the ``cuda_device`` fixture).  They import no
jax, so they run where the port runs:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda

Tolerances: K1 runs the plain version's IEEE operations in its order, so
hashes and weights are equal; K3's splat adds with atomics in a run-to-run
order (rel 1e-5); K6 sums d2 and L.l_piv in another order than torch's
reductions (rel 1e-5 for one step).
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
