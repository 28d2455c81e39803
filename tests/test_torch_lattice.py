"""The port's lattice filter (plain twin, CPU) held against the JAX join engine.

Same numpy inputs go through ``simplex_gp_tpu`` (JAX on the CPU) and
``simplex_gp_torch`` (its plain PyTorch versions: the tensors lie on the
CPU).  Tolerances:
  * hashes exactly equal: the twin's elevation sums in another order than
    XLA's dot, which could move a point lying within an ulp of a rounding
    boundary to another simplex, but no such point occurs at these seeds;
  * weights within 1e-6 (a few f32 ulps of the elevated coordinates);
  * operator output rel < 2e-5 with equal n_lattice, the bound the JAX
    package holds its own two engines to (test_chain_plan.py).
The ports of tests/test_lattice.py's accuracy and operator tests run on
the port alone, with the JAX tests' bounds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel_err, seeded

from simplex_gp_torch.kernels import lattice as t_kernels_lattice
from simplex_gp_torch.ops import filter as t_filter
from simplex_gp_torch.ops import kernels as t_kernels
from simplex_gp_torch.ops import lattice as t_lattice
from simplex_gp_tpu.ops import filter as j_filter
from simplex_gp_tpu.ops import kernels as j_kernels
from simplex_gp_tpu.ops import lattice as j_lattice
from simplex_gp_tpu.ops.cpu_ref import available, filter_ref

# The grid of test_chain_plan.py::test_chain_matches_join: d in {1,2,3,5,9,17},
# orders 1-3, rbf and matern.
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


@pytest.mark.parametrize("n,d,order,kind", GRID)
def test_geometry_matches_jax(n, d, order, kind):
    x, _ = seeded(n, d, 1)
    _, jdk = _kernels(kind, order)
    E = j_lattice.build_rotation(d, jdk.variance)
    a = j_lattice._hash_vectors(d)
    jh1, jh2, jw = map(np.asarray, j_lattice._point_hashes(jnp.asarray(x), jnp.asarray(E), a))
    th1, th2, tw = t_kernels_lattice.geometry_plain(torch.from_numpy(x), torch.from_numpy(E),
                                                    torch.from_numpy(a))
    np.testing.assert_array_equal(th1.numpy(), jh1)
    np.testing.assert_array_equal(th2.numpy(), jh2)
    np.testing.assert_allclose(tw.numpy(), jw, rtol=0, atol=1e-6)
    jkeys, _ = j_lattice.lattice_simplex(jnp.asarray(x), jnp.asarray(E))
    tkeys, _ = t_lattice.lattice_simplex(torch.from_numpy(x), torch.from_numpy(E))
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys))


@pytest.mark.parametrize("d", [1, 3, 11, 18])
def test_point_hashes_and_sums_match_jax(d):
    """K1's plain twin (the team kernel's and the per-thread kernel's bits on the card) against JAX's
    _point_hashes and _geometry_hs at d = 1, 3 and the main path's widths, houseelectric's 11 and elevators'
    18: hashes and coordinate sums equal; weights within four float32 spacings of the largest elevated
    coordinate over d + 1 (a weight is a difference of elevated coordinates over d + 1, and XLA's dot sums
    the elevation in another order than the twin's sequential sum)."""
    x, _ = seeded(700, d, 1, seed=d)
    x *= 1.7
    E = j_lattice.build_rotation(d, 1.0)
    a = j_lattice._hash_vectors(d)
    jh1, jh2, js, jw = map(np.asarray, j_lattice._geometry_hs(jnp.asarray(x), jnp.asarray(E), a))
    ph1, ph2, pw = map(np.asarray, j_lattice._point_hashes(jnp.asarray(x), jnp.asarray(E), a))
    th1, th2, tw, ts = t_kernels_lattice.geometry_plain(torch.from_numpy(x), torch.from_numpy(E),
                                                        torch.from_numpy(a), with_s=True)
    for want in ((jh1, jh2), (ph1, ph2)):
        np.testing.assert_array_equal(th1.numpy(), want[0])
        np.testing.assert_array_equal(th2.numpy(), want[1])
    np.testing.assert_array_equal(ts.numpy(), js)
    atol = 4 * float(np.spacing(np.abs(x @ E.T).max().astype(np.float32))) / (d + 1)
    np.testing.assert_allclose(tw.numpy(), jw, rtol=0, atol=atol)
    np.testing.assert_allclose(tw.numpy(), pw, rtol=0, atol=atol)


@pytest.mark.parametrize("n,d,order,kind", GRID)
def test_filter_matches_jax_join(n, d, order, kind):
    x, v = seeded(n, d, 1)
    tdk, jdk = _kernels(kind, order)
    jplan = j_lattice.build_plan_join(jnp.asarray(x), jdk.coeffs, jdk.variance)
    jout = np.asarray(j_lattice.apply_plan_join(jplan, jnp.asarray(v), jdk.coeffs))
    tplan = t_lattice.build_plan_join(torch.from_numpy(x), tdk.coeffs, tdk.variance)
    tout = t_lattice.apply_plan_join(tplan, torch.from_numpy(v), tdk.coeffs).numpy()
    assert int(tplan.n_lattice) == int(jplan.n_lattice)
    assert rel_err(tout, jout) < 2e-5
    once = t_lattice.filter_once(torch.from_numpy(v), torch.from_numpy(x), tdk.coeffs, tdk.variance)
    np.testing.assert_array_equal(once.numpy(), tout)


@pytest.mark.parametrize("n,d,order,kind,c", [(300, 3, 1, "rbf", 8), (400, 9, 1, "matern", 101),
                                              (150, 2, 3, "matern", 101)])
def test_wide_filter_matches_jax_join(n, d, order, kind, c):
    x, v = seeded(n, d, c, seed=1)
    tdk, jdk = _kernels(kind, order)
    jplan = j_lattice.build_plan_join(jnp.asarray(x), jdk.coeffs, jdk.variance)
    jout = np.asarray(j_lattice.apply_plan_join(jplan, jnp.asarray(v), jdk.coeffs))
    tout = t_filter.lattice_filter_any(torch.from_numpy(v), torch.from_numpy(x), tdk).numpy()
    assert rel_err(tout, jout) < 2e-5


def test_plan_rows_and_neighbors_are_consistent():
    """Every live row has a key, neighbours are live rows or M, dead rows M."""
    x, _ = seeded(300, 3, 1, seed=2)
    tdk, _ = _kernels("rbf", 2)
    plan = t_lattice.build_plan_join(torch.from_numpy(x), tdk.coeffs, tdk.variance)
    nl = int(plan.n_lattice)
    M = plan.neighbors.shape[1]
    assert M == 300 * 4 and plan.neighbors.shape == (4, M, 4)
    assert set(plan.seg_ids.unique().tolist()) == set(range(nl))
    live = plan.neighbors[:, :nl]
    assert bool(((live >= 0) & (live < nl) | (live == M)).all())
    assert bool((plan.neighbors[:, nl:] == M).all())
    assert bool((live != M).any())


def test_lattice_filter_rect_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(200, 3)).astype(np.float32)
    xt = rng.normal(size=(40, 3)).astype(np.float32)
    v = rng.normal(size=(200, 3)).astype(np.float32)
    tdk, jdk = _kernels("matern", 1)
    jout = np.asarray(j_filter.lattice_filter_rect(jnp.asarray(v), jnp.asarray(x), jnp.asarray(xt), jdk))
    tout = t_filter.lattice_filter_rect(torch.from_numpy(v), torch.from_numpy(x), torch.from_numpy(xt), tdk)
    assert tout.shape == (40, 3)
    assert rel_err(tout.numpy(), jout) < 2e-5


@pytest.mark.parametrize("n,d,c,order,kind", [(100, 1, 1, 1, "rbf"), (150, 5, 3, 3, "matern"),
                                              (200, 17, 1, 1, "matern")])
def test_filter_matches_cpp_golden_model(n, d, c, order, kind):
    if not available():
        pytest.skip("g++ golden model unavailable")
    rng = np.random.default_rng(7)
    x = rng.normal(size=(n, d)).astype(np.float32)
    v = rng.normal(size=(n, c)).astype(np.float32)
    tdk, _ = _kernels(kind, order)
    ours = t_lattice.filter_once(torch.from_numpy(v), torch.from_numpy(x), tdk.coeffs, tdk.variance)
    gold = filter_ref(v, x, np.asarray(tdk.coeffs), tdk.variance)
    # Same bound as tests/test_cpu_ref.py: f32 roundoff, other accumulation orders.
    np.testing.assert_allclose(ours.numpy(), gold, rtol=2e-4, atol=2e-4)


def _dense_mvm(x, v, kind):
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    if kind == "rbf":
        kmat = np.exp(-d2)
    else:
        d = np.sqrt(d2)
        kmat = (1 + np.sqrt(3) * d) * np.exp(-np.sqrt(3) * d)
    return kmat @ v


@pytest.mark.parametrize("n,d,kind,order,tol_rel,tol_cos", [
    (50, 1, "rbf", 1, 0.2, 0.98),
    (50, 1, "rbf", 2, 0.2, 0.98),
    (200, 3, "rbf", 2, 0.45, 0.90),
    (50, 1, "matern", 3, 0.1, 0.99),
    (200, 3, "matern", 3, 0.25, 0.97),
    (400, 9, "rbf", 1, 0.30, 0.95),
    (400, 9, "matern", 1, 0.60, 0.80),
    (300, 17, "matern", 1, 0.25, 0.97),
])
def test_mvm_accuracy(n, d, kind, order, tol_rel, tol_cos):
    """Port of test_lattice.py::test_mvm_accuracy: the one-shot filter against the dense kernel product."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, d)).astype(np.float32)
    v = rng.normal(size=(n, 2)).astype(np.float32)
    dk = _kernels(kind, order)[0]
    out = t_lattice.filter_once(torch.from_numpy(v), torch.from_numpy(x), dk.coeffs, dk.variance).numpy()
    exact = _dense_mvm(x, v, kind)
    scale = (out * exact).sum() / (out * out).sum()  # mvm_err.py:94's global scale correction
    rel = np.linalg.norm(scale * out - exact) / np.linalg.norm(exact)
    cos = (out * exact).sum() / (np.linalg.norm(out) * np.linalg.norm(exact))
    assert rel < tol_rel, f"rel err {rel}"
    assert cos > tol_cos, f"cos {cos}"


def test_operator_linear_and_symmetric():
    """Port of test_lattice.py::test_operator_linear_and_symmetric on the join plan.

    u^T K v = v^T K u up to the commutator error of the per-axis blurs
    (rtol 2e-2, as the JAX test); K is linear in v (1e-4).
    """
    rng = np.random.default_rng(1)
    n, d = 80, 2
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    dk = t_kernels.rbf_kernel(1)
    plan = t_lattice.build_plan_join(x, dk.coeffs, dk.variance)
    u = torch.from_numpy(rng.normal(size=(n, 1)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(n, 1)).astype(np.float32))
    Ku = t_lattice.apply_plan_join(plan, u, dk.coeffs)
    Kv = t_lattice.apply_plan_join(plan, v, dk.coeffs)
    np.testing.assert_allclose(float((u * Kv).sum()), float((v * Ku).sum()), rtol=2e-2)
    Kuv = t_lattice.apply_plan_join(plan, 2.0 * u + v, dk.coeffs)
    np.testing.assert_allclose(Kuv.numpy(), (2.0 * Ku + Kv).numpy(), rtol=1e-4, atol=1e-4)
