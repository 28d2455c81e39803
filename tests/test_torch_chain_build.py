"""K3'a's stages (the sort chain's plan build by hash dedup) held against the plain build and JAX's.

``chain_build_staged`` runs, in plain PyTorch on the CPU, the stages the
card's build runs: dedup of the N contributions on their lattice point
(axis-0 key, h2), in an order standing for the hash table's race; a sort of
the distinct points only; the stable placement of each row's contributions
in index order; the rows, and the overflow rule past the capacity.  It must
give ``chain_build_plain``'s plan (JAX's operator, two stable sorts of all
N contributions) bit for bit, in every field, whatever the race's order:
torch.equal, no tolerance.  Against JAX's ``build_plan_chain``, as
test_torch_chain_plan.py holds the plain build: n_lattice and cnt equal
(both order the rows by the same keys), the operator rel < 2e-5 (JAX
differences a running sum where the port sums each row).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from chain_fixtures import chain_class_positions, colliding_inputs
from torch_parity import rel_err, seeded

from simplex_gp_torch.kernels import chain as t_chain
from simplex_gp_torch.kernels import lattice as K
from simplex_gp_torch.ops import kernels as t_kernels
from simplex_gp_torch.ops import lattice as t_lattice
from simplex_gp_tpu.ops import kernels as j_kernels
from simplex_gp_tpu.ops import lattice as j_lattice

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


def _inputs(x, dk):
    """K1's outputs at positions x (plain), the chain constants and the taps."""
    d = x.shape[1]
    E = torch.from_numpy(t_lattice.build_rotation(d, dk.variance))
    a = torch.from_numpy(t_lattice._hash_vectors(d))
    h1, h2, w, s = K.lattice_geometry(torch.from_numpy(x), E, a, with_s=True)
    return h1, h2, s, w, torch.from_numpy(t_lattice._chain_consts(d)), [float(t) for t in dk.coeffs]


def _capacity(which, occ):
    return {"untrimmed": None, "trimmed": occ + 3, "overflowing": occ - 1, "half": max(1, occ // 2)}[which]


def _assert_same_plan(a, b):
    differ = [f for f in t_chain.ChainPlan._fields if not torch.equal(getattr(a, f), getattr(b, f))]
    assert not differ, differ


def _positions(case):
    rng = np.random.default_rng(11)
    if case == "d1":
        return 3.0 * rng.normal(size=(300, 1)).astype(np.float32)
    if case == "d18":
        return rng.normal(size=(150, 18)).astype(np.float32)
    if case == "one point repeated":
        return np.repeat(rng.normal(size=(1, 6)).astype(np.float32), 200, axis=0)
    if case == "duplicated rows":
        x = rng.normal(size=(60, 4)).astype(np.float32)
        return np.concatenate([x, x[::-1], x[:20]])
    return chain_class_positions()  # runs of every class, past PIECE = 1,024 contributions


@pytest.mark.parametrize("capacity", ["untrimmed", "trimmed", "overflowing"])
@pytest.mark.parametrize("n,d,order,kind", GRID)
def test_staged_build_equals_the_plain_build_on_the_grid(n, d, order, kind, capacity):
    x, _ = seeded(n, d, 1, seed=3)
    dk, _ = _kernels(kind, order)
    args = _inputs(x, dk)
    occ = int(t_chain.chain_build_plain(*args).n_lattice)
    cap = _capacity(capacity, occ)
    _assert_same_plan(t_chain.chain_build_staged(*args, cap), t_chain.chain_build_plain(*args, cap))


@pytest.mark.parametrize("capacity", ["untrimmed", "trimmed", "overflowing", "half"])
@pytest.mark.parametrize("case", ["d1", "d18", "one point repeated", "duplicated rows", "run classes"])
def test_staged_build_equals_the_plain_build_on_hard_inputs(case, capacity):
    """d = 1 and 18, every vertex of one point shared by all points, duplicated rows, runs past 1,024
    contributions; untrimmed, trimmed, one row short of the occupancy and half of it."""
    dk, _ = _kernels("matern" if case == "d18" else "rbf", 2 if case == "d1" else 1)
    x = _positions(case)
    args = _inputs(x, dk)
    plain = t_chain.chain_build_plain(*args)
    occ = int(plain.n_lattice)
    cap = _capacity(capacity, occ)
    staged = t_chain.chain_build_staged(*args, cap)
    _assert_same_plan(staged, t_chain.chain_build_plain(*args, cap))
    if case == "run classes" and capacity == "untrimmed":
        assert int(staged.n_long) > 0 and int(staged.n_mid) > 0
    if case == "one point repeated":
        assert occ == x.shape[1] + 1  # the d+1 vertices of one simplex


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_staged_build_does_not_depend_on_the_dedup_order(seed):
    """The race decides the unique list's order; the plan is read only through sorts of distinct keys."""
    dk, _ = _kernels("rbf", 1)
    args = _inputs(chain_class_positions(), dk)
    for cap in (None, 150):
        _assert_same_plan(t_chain.chain_build_staged(*args, cap, seed=seed), t_chain.chain_build_staged(*args, cap))


@pytest.mark.parametrize("capacity", [None, "trimmed"])
@pytest.mark.parametrize("n,d,order,kind", [GRID[1], GRID[3], GRID[5]])
def test_staged_build_matches_jax(n, d, order, kind, capacity):
    x, v = seeded(n, d, 2, seed=3)
    tdk, jdk = _kernels(kind, order)
    args = _inputs(x, tdk)
    occ = int(t_chain.chain_build_plain(*args).n_lattice)
    cap = None if capacity is None else occ + 3
    plan = t_chain.chain_build_staged(*args, cap)
    jplan = j_lattice.build_plan_chain(jnp.asarray(x), jdk.coeffs, jdk.variance, capacity=cap)
    assert int(plan.n_lattice) == int(jplan.n_lattice)
    np.testing.assert_array_equal(plan.cnt.numpy(), np.asarray(jplan.cnt))
    out = t_lattice.apply_plan_chain(plan, torch.from_numpy(v), tdk.coeffs).numpy()
    jout = np.asarray(j_lattice.apply_plan_chain(jplan, jnp.asarray(v), jdk.coeffs))
    assert rel_err(out, jout) < 2e-5


def test_overflowing_staged_plan_keeps_the_first_points_and_guards():
    """Past the capacity: the first Mc points in (key, h2) order, the last live row's run to N, every index
    inside the table, n_lattice the true occupancy, and the apply all NaN."""
    dk, _ = _kernels("rbf", 1)
    x = _positions("run classes")
    args = _inputs(x, dk)
    full = t_chain.chain_build_staged(*args)
    occ = int(full.n_lattice)
    cap = occ // 3
    plan = t_chain.chain_build_staged(*args, cap)
    assert int(plan.n_lattice) == occ
    np.testing.assert_array_equal(plan.cnt[:cap - 1].numpy(), full.cnt[:cap - 1].numpy())
    assert int(plan.cnt[cap - 1]) == x.shape[0] * 3
    assert int(plan.slice_idx.max()) < cap and int(plan.gather.max()) < cap
    v = torch.from_numpy(np.random.default_rng(2).normal(size=(x.shape[0], 3)).astype(np.float32))
    assert torch.isnan(t_lattice.apply_plan_chain(plan, v, dk.coeffs)).all()


@pytest.mark.parametrize("capacity", ["untrimmed", "overflowing"])
def test_staged_build_orders_points_with_equal_keys_by_h2(capacity):
    """Points whose axis-0 keys are equal and whose h2 differ: rows in (key, h2) order, as the plain build's
    two stable sorts give."""
    h1, h2, s, w = colliding_inputs()
    d = w.shape[1] - 1
    dk, _ = _kernels("rbf", 1)
    args = (h1, h2, s, w, torch.from_numpy(t_lattice._chain_consts(d)), [float(t) for t in dk.coeffs])
    plain = t_chain.chain_build_plain(*args)
    key = t_chain._key(h1.long() - s.long() * args[4][0, 0].long(), h2.long() - s.long() * args[4][1, 0].long(),
                       s.long())
    pairs = torch.unique(torch.stack([key, h2.long()], 1), dim=0)
    assert torch.unique(pairs[:, 0]).numel() < pairs.shape[0]  # some keys are shared by several points
    cap = None if capacity == "untrimmed" else int(plain.n_lattice) - 1
    _assert_same_plan(t_chain.chain_build_staged(*args, cap), t_chain.chain_build_plain(*args, cap))


def test_carved_workspace_views_are_aligned_and_disjoint():
    """The build's one workspace: each view of its size and type, 256-byte aligned, none overlapping."""
    parts = dict(a=(torch.int32, 5), b=(torch.int64, 3), c=(torch.int16, 7), d=(torch.float32, 1))
    ws = t_chain._carve(torch.device("cpu"), parts)
    spans = []
    for name, (dtype, numel) in parts.items():
        t = ws[name]
        assert t.dtype == dtype and t.numel() == numel and t.is_contiguous()
        assert t.data_ptr() % 256 == ws["a"].data_ptr() % 256
        spans.append((t.data_ptr(), t.data_ptr() + numel * dtype.itemsize))
    spans.sort()
    assert all(hi <= lo for (_, hi), (lo, _) in zip(spans, spans[1:]))
