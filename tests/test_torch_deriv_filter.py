"""The reference-parity filter ``lattice_filter`` and its derivative-tap gradient (K7).

Ports of the three ``lattice_filter`` tests of tests/test_filter_grad.py (the
same data, bounds and bands, on the port), and the port's gradients against
``jax.vjp`` of JAX's ``lattice_filter`` on the same numpy (x, s, g).  Both
sides run the derivative-tap filter on a join plan; the forward filters
differ (JAX's one-shot is the sort chain, the port's the join operator) and
grad_src is one more forward filter, so it carries their rel 2e-5 bound
(test_chain_plan.py).  grad_ref's four-term difference is summed in another
order on each side: rel 2e-5 as well (measured <= 3e-7 on the CPU).
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
from simplex_gp_torch.ops.filter import lattice_filter
from simplex_gp_tpu.ops import kernels as j_kernels
from simplex_gp_tpu.ops.filter import lattice_filter as j_lattice_filter


def _dks(kind, order):
    if kind == "rbf":
        return t_kernels.rbf_kernel(order), j_kernels.rbf_kernel(order)
    return t_kernels.matern_kernel(1.5, order), j_kernels.matern_kernel(1.5, order)


def _draws(seed, n, d, L):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32), rng.normal(size=(n, L)).astype(np.float32),
            rng.normal(size=(n, L)).astype(np.float32))


def _vjp(s, x, g, dk):
    """(grad_src, grad_ref) of <g, lattice_filter(s, x)> by torch autograd."""
    st = torch.from_numpy(s).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    (torch.from_numpy(g) * lattice_filter(st, xt, dk)).sum().backward()
    return st.grad.numpy(), xt.grad.numpy()


def _dense_quad(x, s, g, kind):
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    if kind == "rbf":
        Km = torch.exp(-d2)
    else:
        dd = torch.sqrt(d2 + 1e-12)
        Km = (1 + np.sqrt(3.0) * dd) * torch.exp(-np.sqrt(3.0) * dd)
    return (g * (Km @ s)).sum()


def test_grad_source_is_symmetric_filter():
    x, s, g = _draws(0, 60, 2, 3)
    dk = t_kernels.rbf_kernel(1)
    grad_s, _ = _vjp(s, x, g, dk)
    expected = lattice_filter(torch.from_numpy(g), torch.from_numpy(x), dk).numpy()
    np.testing.assert_allclose(grad_s, expected, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind,order", [("rbf", 2), ("matern", 3)])
def test_grad_reference_matches_dense_analytic(kind, order):
    """Cosine > 0.85 against the dense kernel's analytic gradient, with the scale bands of the JAX test."""
    x, s, g = _draws(3, 80, 2, 2)
    dk, _ = _dks(kind, order)
    _, grad_x = _vjp(s, x, g, dk)
    xt = torch.from_numpy(x).double().requires_grad_(True)
    _dense_quad(xt, torch.from_numpy(s).double(), torch.from_numpy(g).double(), kind).backward()
    exact = xt.grad.numpy()
    c = float((grad_x * exact).sum() / (np.linalg.norm(grad_x) * np.linalg.norm(exact)))
    assert c > 0.85, f"cosine(grad_lattice, grad_dense) = {c}"
    scale = float((grad_x * exact).sum() / (grad_x**2).sum())
    lo, hi = (0.6, 1.67) if kind == "rbf" else (0.25, 2.5)
    assert lo < scale < hi, f"gradient scale mismatch: {scale}"


def test_value_and_grad_through_lengthscale():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(50, 2)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(50, 1)).astype(np.float32))
    log_ell = torch.zeros(2, requires_grad=True)
    (y * lattice_filter(y, x / torch.exp(log_ell), t_kernels.rbf_kernel(1))).sum().backward()
    assert torch.isfinite(log_ell.grad).all() and float(log_ell.grad.norm()) > 1e-6


# ``spread`` scales the positions: at d = 17 unit-normal points lie too far
# apart for the kernel, and the gradient would be roundoff alone.
@pytest.mark.parametrize("n,d,L,kind,order,spread", [(200, 2, 3, "rbf", 1, 1.0), (150, 3, 2, "matern", 2, 1.0),
                                                     (300, 5, 11, "matern", 1, 1.0), (64, 17, 2, "rbf", 1, 0.2),
                                                     (257, 9, 1, "rbf", 2, 0.5)])
def test_gradients_match_jax_vjp(n, d, L, kind, order, spread):
    x, s, g = _draws(n + d, n, d, L)
    x = (spread * x).astype(np.float32)
    tdk, jdk = _dks(kind, order)
    _, vjp = jax.vjp(lambda ss, xx: j_lattice_filter(ss, xx, jdk), jnp.asarray(s), jnp.asarray(x))
    j_src, j_ref = vjp(jnp.asarray(g))
    t_src, t_ref = _vjp(s, x, g, tdk)
    assert rel_err(t_src, j_src) <= 2e-5
    assert rel_err(t_ref, j_ref) <= 2e-5


def test_matern_constant_is_two_dk0():
    """The derivative block is scaled by 2 k'(0) = -3 for Matern-1.5, not the reference's -2."""
    x, s, g = _draws(9, 120, 3, 2)
    dk = t_kernels.matern_kernel(1.5, 1)
    assert dk.dk0 == -1.5
    _, grad_ref = _vjp(s, x, g, dk)
    plan = t_filter.build_plan_join(torch.from_numpy(x), dk.deriv_coeffs, dk.deriv_variance)
    unit = K.deriv_grad_plain(plan.seg_ids, plan.weights, plan.neighbors, torch.from_numpy(x),
                              torch.from_numpy(s), torch.from_numpy(g), dk.deriv_coeffs,
                              t_filter.SLICE_NORM(3), 1.0).numpy()
    np.testing.assert_allclose(grad_ref, -3.0 * unit, rtol=1e-6, atol=1e-7)


def test_backward_skips_the_half_not_asked_for(monkeypatch):
    x, s, g = _draws(1, 40, 2, 2)
    dk = t_kernels.rbf_kernel(1)
    calls = []
    for name in ("_filter_plain", "deriv_filter_grad"):
        fn = getattr(t_filter, name)
        monkeypatch.setattr(t_filter, name, lambda *a, fn=fn, name=name, **k: calls.append(name) or fn(*a, **k))
    xt = torch.from_numpy(x).requires_grad_(True)
    (torch.from_numpy(g) * lattice_filter(torch.from_numpy(s), xt, dk)).sum().backward()
    assert calls == ["_filter_plain", "deriv_filter_grad"]  # the forward, then grad_ref only
    calls.clear()
    st = torch.from_numpy(s).requires_grad_(True)
    (torch.from_numpy(g) * lattice_filter(st, torch.from_numpy(x), dk)).sum().backward()
    assert calls == ["_filter_plain", "_filter_plain"]  # the forward, then grad_src only


def test_width_dispatch_matches_jax():
    """Up to 16 columns the one-shot filter, wider the join plan: both equal JAX's _filter_plain."""
    from simplex_gp_tpu.ops.filter import _filter_plain as j_filter_plain

    tdk, jdk = _dks("rbf", 1)
    for c in (16, 17):
        x, s, _ = _draws(c, 100, 3, c)
        want = np.asarray(j_filter_plain(jnp.asarray(s), jnp.asarray(x), jdk))
        assert rel_err(t_filter._filter_plain(torch.from_numpy(s), torch.from_numpy(x), tdk), want) < 2e-5
