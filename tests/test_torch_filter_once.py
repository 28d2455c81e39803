"""The one-shot filter (K4) and the occupancy count (K8) against the JAX package.

Same numpy inputs on both sides; the port on the CPU (plain kernel versions).
JAX's filter_once is filter_fused, the sort-chain operator; the port's is
the join operator (K1 + K2 plain, then the apply in the kernel's order: the
row-order splat, the d+1 blurs, the slice).  The two agree up to 64-bit hash
collisions, the bound of test_chain_plan.py::test_chain_matches_join: rel
< 2e-5 with equal n_lattice (measured <= 1e-6 on the CPU).  The count is exact on
both sides.  Against the C++ golden model, the bound of test_cpu_ref.py
(rtol 2e-4: another accumulation order and point-to-vertex order).  The
kernel numbers its rows in the order its threads win their inserts; the
plain version under two seeded random row numberings gives the same bits,
so the output does not depend on that race.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel_err

from simplex_gp_torch.kernels import lattice as K
from simplex_gp_torch.ops import kernels as t_kernels
from simplex_gp_torch.ops import lattice as t_lattice
from simplex_gp_tpu.ops import kernels as j_kernels
from simplex_gp_tpu.ops import lattice as j_lattice
from simplex_gp_tpu.ops.cpu_ref import available, filter_ref


def _data(n, d, c=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype(np.float32), rng.normal(size=(n, c)).astype(np.float32)


def _once(v, x, dk, capacity=None):
    return t_lattice.filter_once(torch.from_numpy(v), torch.from_numpy(x), dk.coeffs, dk.variance,
                                 capacity).numpy()


@pytest.mark.parametrize("n,d,order,c", [(300, 3, 1, 1), (257, 5, 2, 3), (64, 17, 1, 2), (200, 1, 1, 1)])
def test_filter_once_matches_jax_and_guards_capacity(n, d, order, c):
    """Port of test_chain_plan.py::test_fused_filter_matches_plan_path (:204-228)."""
    x, v = _data(n, d, c=c)
    tdk, jdk = t_kernels.rbf_kernel(order), j_kernels.rbf_kernel(order)
    want = np.asarray(j_lattice.filter_once(jnp.asarray(v), jnp.asarray(x), jdk.coeffs, jdk.variance))
    got = _once(v, x, tdk)
    assert rel_err(got, want) < 2e-5
    nl = int(j_lattice.build_plan_chain(jnp.asarray(x), jdk.coeffs, jdk.variance).n_lattice)
    assert int(t_lattice.count_lattice_points(torch.from_numpy(x), tdk.variance, tdk.coeffs)) == nl
    np.testing.assert_array_equal(_once(v, x, tdk, capacity=nl + 8), got)
    np.testing.assert_array_equal(_once(v, x, tdk, capacity=nl), got)
    assert np.isnan(_once(v, x, tdk, capacity=nl - 1)).all()


@pytest.mark.parametrize("d", [1, 2, 3, 5, 9, 17])
def test_count_matches_jax_and_the_plan(d):
    x, _ = _data(300, d, seed=d)
    dk = t_kernels.rbf_kernel(1)
    got = t_lattice.count_lattice_points(torch.from_numpy(x), dk.variance)
    assert got.dtype == torch.int32 and got.shape == ()
    assert int(got) == int(j_lattice.count_lattice_points(jnp.asarray(x), dk.variance))
    assert int(got) == int(t_lattice.build_plan_join(torch.from_numpy(x), dk.coeffs, dk.variance).n_lattice)


def test_capacity_trim_exact_and_overflow_guard():
    """Port of test_chain_plan.py::test_capacity_trim_exact_and_overflow_guard (:145) for the one-shot filter."""
    dk = t_kernels.rbf_kernel(1)
    x, v = _data(400, 5, c=2, seed=7)
    full = _once(v, x, dk)
    n_lat = int(t_lattice.count_lattice_points(torch.from_numpy(x), dk.variance))
    np.testing.assert_allclose(_once(v, x, dk, capacity=n_lat + 8), full, rtol=1e-6, atol=1e-6)
    under = max(8, n_lat // 2)
    assert np.isnan(_once(v, x, dk, capacity=under)).all()
    jdk = j_kernels.rbf_kernel(1)
    assert np.isnan(np.asarray(j_lattice.filter_once(jnp.asarray(v), jnp.asarray(x), jdk.coeffs,
                                                     jdk.variance, under))).all()
    # The plain version reports the true occupancy even when the capacity is short.
    E, a, oh1, oh2 = t_lattice._lattice_constants(5, dk.coeffs, dk.variance, "cpu")
    _, nl = K.lattice_filter_once(torch.from_numpy(x), E, a, oh1, oh2, torch.from_numpy(v),
                                  list(dk.coeffs), t_lattice.SLICE_NORM(5), under)
    assert int(nl) == n_lat


def test_plan_reuse_matches_filter_once():
    """Port of test_lattice.py::test_plan_reuse_matches_filter_once, also held to JAX's filter_once."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(60, 2)).astype(np.float32)
    v = rng.normal(size=(60, 3)).astype(np.float32)
    dk = t_kernels.rbf_kernel(2)
    plan = t_lattice.build_plan_join(torch.from_numpy(x), dk.coeffs, dk.variance)
    reused = t_lattice.apply_plan_join(plan, torch.from_numpy(v), dk.coeffs).numpy()
    once = _once(v, x, dk)
    np.testing.assert_allclose(reused, once, rtol=1e-5, atol=1e-5)
    jdk = j_kernels.rbf_kernel(2)
    want = np.asarray(j_lattice.filter_once(jnp.asarray(v), jnp.asarray(x), jdk.coeffs, jdk.variance))
    assert rel_err(once, want) < 2e-5


def test_duplicate_points_sum():
    """Port of test_lattice.py::test_duplicate_points_sum: identical points accumulate."""
    x = np.array([[0.0], [0.0], [5.0]], dtype=np.float32)
    out = _once(np.eye(3, dtype=np.float32), x, t_kernels.rbf_kernel(1))
    np.testing.assert_allclose(out[0], out[1], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out[0, 1], out[0, 0], rtol=1e-4, atol=1e-4)


@pytest.mark.skipif(not available(), reason="g++ golden model unavailable")
@pytest.mark.parametrize("n,d,c,order,kind", [
    (100, 1, 1, 1, "rbf"),
    (200, 3, 2, 2, "rbf"),
    (150, 5, 3, 3, "matern"),
    (300, 9, 2, 1, "matern"),
    (200, 17, 1, 1, "matern"),
])
def test_filter_once_matches_cpp_golden_model(n, d, c, order, kind):
    """Port of tests/test_cpu_ref.py::test_differential_vs_golden."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(n, d)).astype(np.float32)
    v = rng.normal(size=(n, c)).astype(np.float32)
    dk = t_kernels.rbf_kernel(order) if kind == "rbf" else t_kernels.matern_kernel(1.5, order)
    gold = filter_ref(v, x, np.asarray(dk.coeffs), dk.variance)
    np.testing.assert_allclose(_once(v, x, dk), gold, rtol=2e-4, atol=2e-4)


def test_filter_once_refuses_asymmetric_taps():
    x, v = _data(20, 2)
    with pytest.raises(ValueError, match="symmetric"):
        t_lattice.filter_once(torch.from_numpy(v), torch.from_numpy(x), (0.2, 1.0, 0.5), 1.0)


def test_cpu_tensors_take_the_plain_versions():
    x, v = _data(50, 3)
    dk = t_kernels.rbf_kernel(1)
    before = (K.lattice_filter_once.launches, K.lattice_count.launches)
    _once(v, x, dk)
    t_lattice.count_lattice_points(torch.from_numpy(x), dk.variance)
    assert (K.lattice_filter_once.launches, K.lattice_count.launches) == before


def _adversarial(case):
    """Positions that stress an occupancy count: one hot key set, all keys distinct, one point, d = 1,
    duplicated rows."""
    rng = np.random.default_rng(11)
    if case == "identical":
        return np.tile(rng.normal(size=(1, 6)).astype(np.float32), (500, 1))
    if case == "distinct":  # 50 apart in every coordinate: no two points share a lattice point
        return (50.0 * np.arange(200)[:, None] + rng.uniform(0, 1, size=(200, 4))).astype(np.float32)
    if case == "single":
        return rng.normal(size=(1, 7)).astype(np.float32)
    if case == "one_dim":
        return rng.normal(size=(300, 1)).astype(np.float32)
    x0 = rng.normal(size=(120, 3)).astype(np.float32)
    return np.concatenate([x0, x0[::-1], x0[:50], x0[:1]])


@pytest.mark.parametrize("case", ["identical", "distinct", "single", "one_dim", "duplicated"])
def test_count_on_adversarial_inputs_matches_jax(case):
    """K8's plain version against JAX's count_lattice_points where the keys repeat, never repeat, or are
    few; the counts the cases imply hold exactly."""
    x = _adversarial(case)
    n, d = x.shape
    dk = t_kernels.rbf_kernel(1)
    got = int(t_lattice.count_lattice_points(torch.from_numpy(x), dk.variance))
    assert got == int(j_lattice.count_lattice_points(jnp.asarray(x), dk.variance))
    if case in ("identical", "single"):
        assert got == d + 1
    elif case == "distinct":
        assert got == n * (d + 1)
    elif case == "duplicated":
        assert got == int(t_lattice.count_lattice_points(torch.from_numpy(x[:120]), dk.variance))


def _twin_args(x, v, dk, capacity=None):
    n, d = x.shape
    E, a, oh1, oh2 = t_lattice._lattice_constants(d, dk.coeffs, dk.variance, "cpu")
    return (torch.from_numpy(x), E, a, oh1, oh2, torch.from_numpy(v), list(dk.coeffs), t_lattice.SLICE_NORM(d),
            n * (d + 1) if capacity is None else capacity)


def _numberings(args):
    """The plain K4 in sorted key order and under two seeded random row numberings."""
    base, nl = K.filter_once_plain(*args)
    others = [K.filter_once_plain(*args, numbering=torch.Generator().manual_seed(s))[0] for s in (1, 2)]
    return base, nl, others


@pytest.mark.parametrize("n,d,order,c", [(300, 3, 1, 1), (257, 5, 2, 3), (64, 17, 1, 2), (200, 1, 1, 1)])
def test_filter_once_twin_does_not_depend_on_the_row_numbering(n, d, order, c):
    """The grid of test_filter_once_matches_jax_and_guards_capacity: the same bits under three row
    numberings, JAX's filter_fused to rel 2e-5, and at capacity = occupancy - 1 all NaN under each."""
    x, v = _data(n, d, c=c)
    dk, jdk = t_kernels.rbf_kernel(order), j_kernels.rbf_kernel(order)
    base, nl, others = _numberings(_twin_args(x, v, dk))
    assert all(torch.equal(o, base) for o in others)
    want = np.asarray(j_lattice.filter_once(jnp.asarray(v), jnp.asarray(x), jdk.coeffs, jdk.variance))
    assert rel_err(base.numpy(), want) < 2e-5
    seg, nb, _ = K.dedup_neighbors_plain(*K.geometry_plain(torch.from_numpy(x), *_twin_args(x, v, dk)[1:3])[:2],
                                         *_twin_args(x, v, dk)[3:5])
    moved, _ = K._renumber(seg, nb, nl, torch.Generator().manual_seed(1))
    assert int(nl) < 3 or not torch.equal(moved, seg)  # the numbering did change
    under = _twin_args(x, v, dk, int(nl) - 1)
    if int(nl) > 1:
        assert all(bool(torch.isnan(o).all()) for o in (K.filter_once_plain(*under)[0],
                                                         *_numberings(under)[2]))


@pytest.mark.parametrize("case", ["identical", "duplicated", "single", "one_dim"])
def test_filter_once_twin_ignores_the_numbering_on_adversarial_inputs(case):
    """Duplicate points, one point repeated, one point and d = 1: the same bits under three row
    numberings and JAX's filter_fused to rel 2e-5.  (All keys distinct, 50 apart, is left out: there
    JAX's sort chain merges chains by its 43-bit words, ROADMAP's reference behaviours.)"""
    x = _adversarial(case)
    v = np.random.default_rng(3).normal(size=(x.shape[0], 2)).astype(np.float32)
    dk, jdk = t_kernels.rbf_kernel(1), j_kernels.rbf_kernel(1)
    base, _, others = _numberings(_twin_args(x, v, dk))
    assert all(torch.equal(o, base) for o in others)
    want = np.asarray(j_lattice.filter_once(jnp.asarray(v), jnp.asarray(x), jdk.coeffs, jdk.variance))
    assert rel_err(base.numpy(), want) < 2e-5
