"""The filter's exact gradient (K5 + transposed K3) held against autograd and JAX.

Same numpy (x, v, g) on both sides, PyTorch on the CPU (plain kernel
versions).  Tolerances, each with its reason:
  * plain K5 against torch autograd through geometry_plain + apply_plain:
    the same f32 formulas summed in another order, rel 1e-5 (measured
    <= 5e-7);
  * plain K5, which sums in the kernel's order (a dot's columns by a team
    of lanes and its xor butterfly, each output coordinate over j in turn),
    against the formula it replaced (torch's row sums and a matmul): rel
    1e-6, f32 roundoff of the two orders (measured <= 1.3e-7);
  * the port's LatticeFilterExactGrad against jax.vjp of JAX's join engine
    (build_plan_join + apply_plan_join): the same operator, f32 roundoff of
    the reduction orders, rel 1e-5 on grad_src and 2e-5 on grad_ref
    (measured <= 4e-7 / 1.4e-6);
  * against JAX's public lattice_filter_exact_grad, whose forward is the
    sort-chain engine: the standard of JAX's own chain-vs-join gradient
    test (test_chain_plan.py:113-114), rtol 1e-3 / atol 1e-4 (measured rel
    <= 5e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel_err

from simplex_gp_torch.kernels import lattice as K
from simplex_gp_torch.ops import filter as t_filter
from simplex_gp_torch.ops import kernels as t_kernels
from simplex_gp_torch.ops import lattice as t_lattice
from simplex_gp_torch.ops.filter import LatticeFilterExactGrad, lattice_filter_exact_grad
from simplex_gp_tpu.ops import kernels as j_kernels
from simplex_gp_tpu.ops import lattice as j_lattice
from simplex_gp_tpu.ops.filter import lattice_filter_exact_grad as j_filter_exact_grad

# The grid of test_chain_plan.py::test_chain_matches_join: d in {1,2,3,5,9,17},
# orders 1-3, rbf and matern.
GRID = [(200, 1, 1, "rbf"), (300, 3, 1, "rbf"), (257, 5, 2, "rbf"), (150, 2, 3, "matern"),
        (400, 9, 1, "matern"), (64, 17, 1, "rbf")]


def _dks(kind, order):
    if kind == "rbf":
        return t_kernels.rbf_kernel(order), j_kernels.rbf_kernel(order)
    return t_kernels.matern_kernel(1.5, order), j_kernels.matern_kernel(1.5, order)


def _inputs(n, d, c, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x, rng.normal(size=(n, c)).astype(np.float32), rng.normal(size=(n, c)).astype(np.float32)


def _plain_plan(ref, d, dk):
    E = torch.from_numpy(t_lattice.build_rotation(d, dk.variance))
    a = torch.from_numpy(t_lattice._hash_vectors(d))
    h1, h2, w = K.geometry_plain(ref, E, a)
    oh1, oh2 = (torch.from_numpy(o) for o in t_lattice._offset_hashes(d, dk.order, t_lattice._hash_vectors(d)))
    seg, nb, _ = K.dedup_neighbors_plain(h1, h2, oh1, oh2)
    return E, seg.reshape(ref.shape[0], d + 1), w, nb


@pytest.mark.parametrize("c", [1, 11])
@pytest.mark.parametrize("n,d,order,kind", GRID)
def test_plain_k5_matches_torch_autograd(n, d, order, kind, c):
    x, v, g = _inputs(n, d, c)
    dk, _ = _dks(kind, order)
    norm = t_lattice.SLICE_NORM(d)
    ref = torch.from_numpy(x).requires_grad_(True)
    vt = torch.from_numpy(v).requires_grad_(True)
    gt = torch.from_numpy(g)
    E, seg, w, nb = _plain_plan(ref, d, dk)
    (gt * K.apply_plain(seg, w, nb, vt, dk.coeffs, norm)).sum().backward()
    with torch.no_grad():
        _, table_f = K.apply_plain(seg, w, nb, vt, dk.coeffs, norm, return_table=True)
        grad_src, table_b = K.apply_plain(seg, w, nb, gt, dk.coeffs, norm, transpose=True, return_table=True)
        grad_ref = K.lattice_filter_grad(ref, E, seg, vt, gt, table_f, table_b, norm)
    assert rel_err(grad_src, vt.grad) < 1e-5
    assert rel_err(grad_ref, ref.grad) < 1e-5


@pytest.mark.parametrize("c", [1, 11])
@pytest.mark.parametrize("n,d,order,kind", GRID)
def test_exact_grad_matches_jax_join_autodiff(n, d, order, kind, c):
    x, v, g = _inputs(n, d, c)
    tdk, jdk = _dks(kind, order)
    ref = torch.from_numpy(x).requires_grad_(True)
    src = torch.from_numpy(v).requires_grad_(True)
    out = lattice_filter_exact_grad(src, ref, tdk)
    (torch.from_numpy(g) * out).sum().backward()

    def join(s, r):
        return j_lattice.apply_plan_join(j_lattice.build_plan_join(r, jdk.coeffs, jdk.variance), s, jdk.coeffs)

    j_out, vjp = jax.vjp(join, jnp.asarray(v), jnp.asarray(x))
    j_src, j_ref = vjp(jnp.asarray(g))
    assert rel_err(out.detach(), j_out) < 1e-5
    assert rel_err(src.grad, j_src) < 1e-5
    assert rel_err(ref.grad, j_ref) < 2e-5


@pytest.mark.parametrize("n,d,order,kind", GRID)
def test_exact_grad_matches_jax_public_exact_grad(n, d, order, kind):
    x, v, g = _inputs(n, d, 11, seed=1)
    tdk, jdk = _dks(kind, order)
    ref = torch.from_numpy(x).requires_grad_(True)
    src = torch.from_numpy(v).requires_grad_(True)
    (torch.from_numpy(g) * LatticeFilterExactGrad.apply(src, ref, tdk)).sum().backward()
    _, vjp = jax.vjp(lambda s, r: j_filter_exact_grad(s, r, jdk), jnp.asarray(v), jnp.asarray(x))
    j_src, j_ref = vjp(jnp.asarray(g))
    np.testing.assert_allclose(src.grad.numpy(), np.asarray(j_src), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(ref.grad.numpy(), np.asarray(j_ref), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("n,d,order,kind", GRID[:4])
def test_transposed_apply_is_the_adjoint(n, d, order, kind):
    """<g, K v> = <K^T g, v> (f32 sums of O(1) terms: 1e-5 of |g| |K v|)."""
    x, v, g = _inputs(n, d, 3, seed=2)
    dk, _ = _dks(kind, order)
    plan = t_lattice.build_plan_join(torch.from_numpy(x), dk.coeffs, dk.variance)
    vt, gt = torch.from_numpy(v), torch.from_numpy(g)
    kv = t_lattice.apply_plan_join(plan, vt, dk.coeffs)
    ktg = t_lattice.apply_plan_join(plan, gt, dk.coeffs, transpose=True)
    lhs, rhs = float((gt * kv).sum()), float((ktg * vt).sum())
    assert abs(lhs - rhs) <= 1e-5 * (gt.norm() * kv.norm())
    out, table = t_lattice.apply_plan_join(plan, vt, dk.coeffs, return_table=True)
    assert table.shape == (plan.neighbors.shape[1], 3) and torch.equal(out, kv)


def _dense_quad(x, s, g, kind):
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    if kind == "rbf":
        km = torch.exp(-d2)
    else:
        dd = torch.sqrt(d2 + 1e-12)
        km = (1 + 3.0**0.5 * dd) * torch.exp(-(3.0**0.5) * dd)
    return (g * (km @ s)).sum()


def _cos(a, b):
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    return (a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30)


@pytest.mark.parametrize("kind,order", [("rbf", 2), ("matern", 3)])
def test_grad_reference_matches_dense_analytic(kind, order):
    """Port of test_filter_grad.py::test_grad_reference_matches_dense_analytic for the exact path.

    The exact gradient of the lattice operator against the analytic gradient
    of the dense kernel: direction cos > 0.85 and the scale within the
    filter's own MVM error band, as the JAX test bounds its gradient.
    """
    rng = np.random.default_rng(3)
    n, d, L = 80, 2, 2
    x = rng.normal(size=(n, d)).astype(np.float32)
    s = torch.from_numpy(rng.normal(size=(n, L)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(n, L)).astype(np.float32))
    dk = t_kernels.rbf_kernel(order) if kind == "rbf" else t_kernels.matern_kernel(1.5, order)
    xl = torch.from_numpy(x).requires_grad_(True)
    (g * lattice_filter_exact_grad(s, xl, dk)).sum().backward()
    xd = torch.from_numpy(x).to(torch.float64).requires_grad_(True)
    _dense_quad(xd, s.double(), g.double(), kind).backward()
    grad_x, exact = xl.grad.numpy(), xd.grad.numpy()
    assert _cos(grad_x, exact) > 0.85
    scale = float((grad_x * exact).sum() / (grad_x**2).sum())
    lo, hi = (0.6, 1.67) if kind == "rbf" else (0.25, 2.5)
    assert lo < scale < hi, scale


def test_value_and_grad_through_lengthscale():
    """Port of test_filter_grad.py::test_value_and_grad_through_lengthscale (exact path)."""
    rng = np.random.default_rng(5)
    n, d = 50, 2
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(n, 1)).astype(np.float32))
    log_ell = torch.zeros(d, requires_grad=True)
    loss = (y * lattice_filter_exact_grad(y, x / torch.exp(log_ell), t_kernels.rbf_kernel(1))).sum()
    loss.backward()
    assert torch.isfinite(log_ell.grad).all()
    assert float(log_ell.grad.norm()) > 1e-6


def _old_k5(ref, E, seg_ids, v, g, table_f, table_b, slice_norm):
    """The position gradient in the order K5's plain version summed before it took the kernel's: each
    weight gradient by torch's row sums, the elevation's chain rule by one matmul."""
    n, d = ref.shape
    dp1, seg = d + 1, seg_ids.long()
    gw = slice_norm * ((g[:, None, :] * table_f[seg]).sum(-1) + (v[:, None, :] * table_b[seg]).sum(-1))
    _, rank = K._simplex_rank(K._elevate(ref, E), d)
    r = torch.arange(dp1)
    grad_t_by_rank = gw[:, d - r] - gw[:, (d + 1 - r) % dp1]
    return (grad_t_by_rank.gather(1, rank.long()) * (1.0 / dp1)) @ E


def _k5_problem(n, d, c, seed):
    """Positions, E, a join plan's seg ids and its two blurred tables (plain), and v, g."""
    x, v, g = _inputs(n, d, c, seed)
    dk = t_kernels.matern_kernel(1.5, 1)
    ref = torch.from_numpy(0.3 * x if d >= 9 else x)
    E, seg, w, nb = _plain_plan(ref, d, dk)
    vt, gt = torch.from_numpy(v), torch.from_numpy(g)
    norm = t_lattice.SLICE_NORM(d)
    _, table_f = K.apply_plain(seg, w, nb, vt, dk.coeffs, norm, return_table=True)
    _, table_b = K.apply_plain(seg, w, nb, gt, dk.coeffs, norm, transpose=True, return_table=True)
    return ref, E, seg, vt, gt, table_f, table_b, norm


@pytest.mark.parametrize("c", [1, 11, 17])
@pytest.mark.parametrize("d", [1, 11, 18, 31, 40])
def test_k5_twin_in_the_kernels_order_matches_the_old_formula(d, c):
    """d = 1, houseelectric's 11, elevators' 18, d+1 = 32 (the widest register path) and 41 (the wide
    path); c = 1, 11 (a team of 16 lanes, 11 busy) and 17 (a warp, columns past 32 none)."""
    args = _k5_problem(120 if d < 31 else 60, d, c, seed=d + c)
    new, old = K.lattice_filter_grad_plain(*args), _old_k5(*args)
    assert new.shape == old.shape == args[0].shape
    assert rel_err(new, old) < 1e-6


@pytest.mark.parametrize("c", [1, 11, 17])
def test_k5_twin_on_the_stacked_mixture_shape(c):
    """The mixture's stacked problem (J n points at ref * alpha_j, seg ids j M + row into the stacked
    tables): the new order against the old formula, each component's block."""
    n, d = 150, 5
    mk = t_kernels.mixture_kernel(1.5, 1, 4)
    x, v, g = _inputs(n, d, c, seed=c)
    ref = torch.from_numpy(x)
    plan = t_lattice.build_plan_mixture(ref, mk.alphas, mk.base.coeffs, mk.base.variance)
    J, _, dp1 = plan.seg_ids.shape
    rng = np.random.default_rng(c)
    rows = plan.neighbors.shape[1]
    table_f, table_b = (torch.from_numpy(rng.normal(size=(rows, c)).astype(np.float32)) for _ in range(2))
    E = torch.from_numpy(t_lattice.build_rotation(d, mk.base.variance))
    args = (t_lattice.mixture_positions(ref, mk.alphas), E, plan.seg_ids.reshape(J * n, dp1),
            torch.from_numpy(v).repeat(J, 1), torch.from_numpy(g).repeat(J, 1), table_f, table_b,
            t_lattice.SLICE_NORM(d))
    assert rel_err(K.lattice_filter_grad_plain(*args), _old_k5(*args)) < 1e-6
    grad = t_filter.mixture_position_grad(plan, ref, mk, torch.from_numpy(v), torch.from_numpy(g), table_f, table_b)
    assert grad.shape == (n, d) and torch.isfinite(grad).all()


@pytest.mark.parametrize("c", [11, 17])
@pytest.mark.parametrize("n,d", [(300, 11), (150, 18)])
def test_k5_twin_matches_jax_autodiff_at_the_main_widths(n, d, c):
    """The exact gradient at houseelectric's and elevators' d, c = 11 and 17, against jax.vjp of JAX's join
    engine with this file's bound on grad_ref (rel 2e-5)."""
    x, v, g = _inputs(n, d, c, seed=4)
    x = 0.3 * x
    tdk, jdk = _dks("matern", 1)
    ref = torch.from_numpy(x).requires_grad_(True)
    (torch.from_numpy(g) * lattice_filter_exact_grad(torch.from_numpy(v), ref, tdk)).sum().backward()

    def join(s, r):
        return j_lattice.apply_plan_join(j_lattice.build_plan_join(r, jdk.coeffs, jdk.variance), s, jdk.coeffs)

    _, vjp = jax.vjp(join, jnp.asarray(v), jnp.asarray(x))
    _, j_ref = vjp(jnp.asarray(g))
    assert rel_err(ref.grad, j_ref) < 2e-5
