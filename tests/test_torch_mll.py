"""The port's NLML engine against dense ground truth and against the JAX package.

Ports of the five tests of tests/test_mll.py (the same data, probes and
bounds, on the port), and the port's ``lattice_nlml`` value and gradients
against JAX's on the same numpy probes, in both slq modes.  Both run the
sort-chain engine for the CG; JAX's backward runs the one-shot fused filter
(the chain operator), the port's a join plan (the same operator to rel
2e-5, test_chain_plan.py).  The port's chain sums each row of its splat in
its kernel's order where JAX differences a running sum.  The JAX reference
is the jitted value_and_grad, as the JAX package's trainer runs it: at the
n = 150, d = 1 case (tolerance 1e-3) JAX's op-by-op dispatch of the same
function gives a mean gradient 3.3e-3 from its jitted one, past the bound
below (test_jax_eager_mean_gradient_at_n150_d1_differs_from_the_jitted_one),
and one ulp of y moves it by more
(test_jax_mean_gradient_at_n150_d1_moves_past_the_parity_bound_with_one_ulp_of_y),
so that case is also held against JAX's range over nine one-ulp inputs
(test_port_mean_gradient_at_n150_d1_lies_in_jax_one_ulp_envelope).
Measured (CPU), value <= 6e-7, gradients rel <= 2e-4, the largest on the
mean at d = 1, where 150 points occupy 7 lattice points, a rank-20
preconditioner of the exact kernel is near rank-deficient, and its f32
Woodbury roundoff reaches the solves: there a 1e-7 relative change of the
filter's output moves the mean's gradient by 1e-3 to 1e-2 against JAX.
Bounds: value 1e-5, gradients rel 2e-3.  The same bounds hold in
``grad_mode="deriv_filter"``, where JAX's backward filters V with its
one-shot sort-chain filter and the port with its one-shot join filter (K4),
and both run the derivative-tap filter (K7) on a join plan.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel_err

from simplex_gp_torch.linalg import mll as t_mll
from simplex_gp_torch.ops import kernels as t_kernels
from simplex_gp_tpu.linalg import mll as j_mll
from simplex_gp_tpu.ops import kernels as j_kernels


def _data(n=120, d=1, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, size=(n, d)).astype(np.float32)
    y = (np.sin(3 * x[:, 0]) + 0.1 * rng.normal(size=n)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(y)


def _params(d, requires_grad=False):
    values = {"inv_ell": np.full(d, 1.5, np.float32), "outputscale": np.float32(0.8),
              "noise": np.float32(0.1), "mean": np.float32(0.05)}
    return {k: torch.tensor(v, requires_grad=requires_grad) for k, v in values.items()}


def _probes(n, p, seed=42):
    return torch.from_numpy(np.random.default_rng(seed).choice([-1.0, 1.0], size=(n, p)).astype(np.float32))


def _dense_nlml(params, x, y):
    ref = x * params["inv_ell"]
    d2 = ((ref[:, None, :] - ref[None, :, :]) ** 2).sum(-1)
    khat = params["outputscale"] * torch.exp(-d2) + params["noise"] * torch.eye(x.shape[0])
    yc = y - params["mean"]
    L = torch.linalg.cholesky(khat)
    alpha = torch.cholesky_solve(yc[:, None], L)[:, 0]
    n = y.shape[0]
    return 0.5 * ((yc * alpha).sum() + 2 * torch.log(torch.diagonal(L)).sum() + n * math.log(2 * math.pi)) / n


def _jax_value_and_grad(f, values):
    """The JAX reference's value and gradients, jitted as one function, as the JAX package's trainer
    (simplex_gp_tpu/utils/training.py) and its own tests (tests/test_mll.py) run it."""
    return jax.jit(jax.value_and_grad(f))({k: jnp.asarray(v) for k, v in values.items()})


def _grads(f, params):
    value = f(params)
    grads = torch.autograd.grad(value, list(params.values()))
    return float(value.detach()), dict(zip(params, grads))


# ---- ports of tests/test_mll.py ------------------------------------------------


def test_nlml_value_close_to_dense():
    x, y = _data()
    params = _params(1)
    cfg = t_mll.BBMMConfig(cg_tolerance=1e-3, max_cg_iterations=400, max_lanczos_iterations=80, num_probes=16)
    ours = float(t_mll.lattice_nlml(t_kernels.rbf_kernel(2), cfg, params, x, y, _probes(x.shape[0], 16)))
    dense = float(_dense_nlml(params, x, y))
    assert abs(ours - dense) < 0.1, (ours, dense)


def test_nlml_gradients_self_consistent_fd():
    """The closed-form backward against central differences of the port's own forward."""
    x, y = _data()
    dk = t_kernels.rbf_kernel(2)
    cfg = t_mll.BBMMConfig(cg_tolerance=1e-6, max_cg_iterations=1000, max_lanczos_iterations=100, num_probes=32)
    probes = _probes(x.shape[0], 32)
    _, g = _grads(lambda p: t_mll.lattice_nlml(dk, cfg, p, x, y, probes), _params(1, requires_grad=True))
    eps = 1e-3
    for k in ["inv_ell", "outputscale", "noise", "mean"]:
        p1, p2 = _params(1), _params(1)
        p1[k] = p1[k] + eps
        p2[k] = p2[k] - eps
        fd = (float(t_mll.lattice_nlml(dk, cfg, p1, x, y, probes))
              - float(t_mll.lattice_nlml(dk, cfg, p2, x, y, probes))) / (2 * eps)
        custom = float(g[k].sum())
        assert abs(custom - fd) < 0.05 * max(1.0, abs(fd)), f"{k}: custom={custom} fd={fd}"


def test_nlml_noise_mean_grads_match_dense():
    x, y = _data()
    dk = t_kernels.rbf_kernel(2)
    cfg = t_mll.BBMMConfig(cg_tolerance=1e-4, max_cg_iterations=400, max_lanczos_iterations=80, num_probes=16)
    probes = _probes(x.shape[0], 16)
    _, g_ours = _grads(lambda p: t_mll.lattice_nlml(dk, cfg, p, x, y, probes), _params(1, requires_grad=True))
    _, g_dense = _grads(lambda p: _dense_nlml(p, x, y), _params(1, requires_grad=True))
    for k in ["noise", "mean"]:
        a, b = float(g_ours[k]), float(g_dense[k])
        assert abs(a - b) < 0.15 * max(1.0, abs(b)), f"{k}: ours={a} dense={b}"


def test_nlml_trainable_end_to_end():
    """30 plain gradient steps lower the NLML."""
    x, y = _data(n=100)
    dk = t_kernels.rbf_kernel(1)
    cfg = t_mll.BBMMConfig(cg_tolerance=1e-2, max_cg_iterations=200, max_lanczos_iterations=50, num_probes=8)
    probes = _probes(x.shape[0], 8)
    raw = {"log_inv_ell": torch.zeros(1), "log_outputscale": torch.tensor(0.0),
           "log_noise": torch.tensor(-1.0), "mean": torch.tensor(0.0)}
    raw = {k: v.requires_grad_(True) for k, v in raw.items()}

    def loss():
        params = {"inv_ell": torch.exp(raw["log_inv_ell"]), "outputscale": torch.exp(raw["log_outputscale"]),
                  "noise": torch.exp(raw["log_noise"]) + 1e-4, "mean": raw["mean"]}
        return t_mll.lattice_nlml(dk, cfg, params, x, y, probes)

    first = float(loss())
    for _ in range(30):
        grads = torch.autograd.grad(loss(), list(raw.values()))
        with torch.no_grad():
            for p, g in zip(raw.values(), grads):
                p -= 0.05 * g
    assert float(loss()) < first - 0.05


def test_slq_mode_cg_matches_lanczos_and_dense():
    x, y = _data(n=150)
    dk = t_kernels.rbf_kernel(2)
    kw = dict(cg_tolerance=1e-4, max_cg_iterations=300, max_lanczos_iterations=60, num_probes=24)
    probes = _probes(x.shape[0], 24)
    vals, grads = {}, {}
    for mode in ("cg", "lanczos"):
        cfg = t_mll.BBMMConfig(slq_mode=mode, **kw)
        vals[mode], grads[mode] = _grads(lambda p: t_mll.lattice_nlml(dk, cfg, p, x, y, probes),
                                         _params(1, requires_grad=True))
    dense_v, dense_g = _grads(lambda p: _dense_nlml(p, x, y), _params(1, requires_grad=True))
    assert abs(vals["cg"] - vals["lanczos"]) < 0.05, vals
    assert abs(vals["cg"] - dense_v) < 0.1, (vals["cg"], dense_v)

    def cos(a, b):
        a, b = a.reshape(-1).double(), b.reshape(-1).double()
        return float((a * b).sum() / (a.norm() * b.norm() + 1e-12))

    for k in ("inv_ell", "outputscale", "noise", "mean"):
        assert cos(grads["cg"][k], grads["lanczos"][k]) > 0.9, k
    for k in ("noise", "mean"):
        assert cos(grads["cg"][k], dense_g[k]) > 0.95, k
    assert abs(float(grads["cg"]["noise"]) - float(dense_g["noise"])) / abs(float(dense_g["noise"])) < 0.2


# ---- the port against JAX --------------------------------------------------------


@pytest.mark.parametrize("tol,rank", [(1.0, 100), (1e-3, 20)])
@pytest.mark.parametrize("slq_mode", ["cg", "lanczos"])
@pytest.mark.parametrize("n,d,kind,order", [(150, 1, "rbf", 2), (300, 3, "matern", 1), (400, 5, "rbf", 1)])
def test_lattice_nlml_matches_jax(n, d, kind, order, slq_mode, tol, rank):
    """Value and gradients (inv_ell, outputscale, noise, mean) on the same probes."""
    x, y = _data(n, d)
    probes = _probes(n, 8)
    values = {"inv_ell": np.linspace(0.8, 1.5, d).astype(np.float32), "outputscale": np.float32(0.8),
              "noise": np.float32(0.1), "mean": np.float32(0.05)}
    kw = dict(cg_tolerance=tol, max_cg_iterations=300, max_lanczos_iterations=40, num_probes=8,
              precond_rank=rank, slq_mode=slq_mode)
    jdk = j_kernels.rbf_kernel(order) if kind == "rbf" else j_kernels.matern_kernel(1.5, order)
    tdk = t_kernels.rbf_kernel(order) if kind == "rbf" else t_kernels.matern_kernel(1.5, order)
    jcfg = j_mll.BBMMConfig(**kw)
    j_val, j_grad = _jax_value_and_grad(
        lambda p: j_mll.lattice_nlml(jdk, jcfg, p, jnp.asarray(x.numpy()), jnp.asarray(y.numpy()),
                                     jnp.asarray(probes.numpy())), values)
    stats = {}
    t_params = {k: torch.tensor(v, requires_grad=True) for k, v in values.items()}
    t_val, t_grad = _grads(lambda p: t_mll.lattice_nlml(tdk, t_mll.BBMMConfig(**kw), p, x, y, probes,
                                                        stats=stats), t_params)
    assert stats["cg_iters"] >= 10
    assert abs(t_val - float(j_val)) <= 1e-5
    for k in values:
        assert rel_err(t_grad[k], j_grad[k]) <= 2e-3, k


def test_jax_mean_gradient_at_n150_d1_moves_past_the_parity_bound_with_one_ulp_of_y():
    """The reference's own float32 sensitivity at the n = 150, d = 1 case of the two parity tests above (rbf
    order 2, CG tolerance 1e-3, rank 20): moving three entries of y by one ulp moves JAX's mean gradient by
    more than their 2e-3 bound (it nearly cancels: -sum(alpha) of O(1) terms is ~3e-4), while the other
    gradients move by far less.  So at that case the mean gradient's parity is a matter of float32 rounding:
    any change to the CG's summation order (K10's, say), or to the reference's, can move it across the bound."""
    n, d = 150, 1
    x, y = _data(n, d)
    probes = _probes(n, 8)
    values = {"inv_ell": np.linspace(0.8, 1.5, d).astype(np.float32), "outputscale": np.float32(0.8),
              "noise": np.float32(0.1), "mean": np.float32(0.05)}
    cfg = j_mll.BBMMConfig(cg_tolerance=1e-3, max_cg_iterations=300, max_lanczos_iterations=40, num_probes=8,
                           precond_rank=20)
    grad = jax.jit(jax.grad(lambda p, yy: j_mll.lattice_nlml(j_kernels.rbf_kernel(2), cfg, p, jnp.asarray(x.numpy()),
                                                              yy, jnp.asarray(probes.numpy()))))
    params = {k: jnp.asarray(v) for k, v in values.items()}
    g0 = grad(params, jnp.asarray(y.numpy()))
    rng = np.random.default_rng(0)
    moves = []
    for _ in range(6):
        yy = y.numpy().copy()
        idx = rng.integers(0, n, 3)
        yy[idx] = np.nextafter(yy[idx], np.float32(np.inf))
        g1 = grad(params, jnp.asarray(yy))
        moves.append({k: rel_err(np.asarray(g1[k]), np.asarray(g0[k])) for k in values})
    assert max(m["mean"] for m in moves) > 2e-3
    assert max(m["inv_ell"] for m in moves) < 1e-3 and max(m["noise"] for m in moves) < 1e-3


@pytest.mark.parametrize("mode", [dict(slq_mode="cg"), dict(slq_mode="lanczos"), dict(grad_mode="deriv_filter")],
                         ids=["cg", "lanczos", "deriv_filter"])
def test_port_mean_gradient_at_n150_d1_lies_in_jax_one_ulp_envelope(mode):
    """The parity tests' n = 150, d = 1 case (rbf order 2, CG tolerance 1e-3, rank 20) on nine inputs: y and
    eight copies with three seeded entries moved by one ulp.  There JAX's own mean gradient spreads over
    5.0e-3 of its value (the test above), so one input's pointwise agreement is float32 rounding (paired port
    and JAX differ by 1.9e-4 to 4.7e-3 over these inputs, measured on the CPU).  Held instead: every one of
    the port's nine mean gradients lies in the range of JAX's nine, widened by the parity bound 2e-3 of JAX's
    value at y at each end, and the other gradients agree within 2e-3 at every input, pair by pair."""
    n, d = 150, 1
    x, y = _data(n, d)
    probes = _probes(n, 8)
    values = {"inv_ell": np.linspace(0.8, 1.5, d).astype(np.float32), "outputscale": np.float32(0.8),
              "noise": np.float32(0.1), "mean": np.float32(0.05)}
    kw = dict(cg_tolerance=1e-3, max_cg_iterations=300, max_lanczos_iterations=40, num_probes=8, precond_rank=20,
              **mode)
    grad = jax.jit(jax.grad(lambda p, yy: j_mll.lattice_nlml(j_kernels.rbf_kernel(2), j_mll.BBMMConfig(**kw), p,
                                                              jnp.asarray(x.numpy()), yy,
                                                              jnp.asarray(probes.numpy()))))
    params = {k: jnp.asarray(v) for k, v in values.items()}
    rng = np.random.default_rng(0)
    jax_g, port_g = [], []
    for i in range(9):
        yy = y.numpy().copy()
        if i:
            idx = rng.integers(0, n, 3)
            yy[idx] = np.nextafter(yy[idx], np.float32(np.inf))
        jax_g.append({k: np.asarray(v) for k, v in grad(params, jnp.asarray(yy)).items()})
        t_params = {k: torch.tensor(v, requires_grad=True) for k, v in values.items()}
        port_g.append(_grads(lambda p: t_mll.lattice_nlml(t_kernels.rbf_kernel(2), t_mll.BBMMConfig(**kw), p, x,
                                                          torch.from_numpy(yy), probes), t_params)[1])
    jm = np.array([float(g["mean"]) for g in jax_g])
    margin = 2e-3 * abs(jm[0])
    for tg, jg in zip(port_g, jax_g):
        assert jm.min() - margin <= float(tg["mean"]) <= jm.max() + margin, (float(tg["mean"]), jm.min(), jm.max())
        for k in ("inv_ell", "outputscale", "noise"):
            assert rel_err(tg[k], jg[k]) <= 2e-3, k


def test_jax_eager_mean_gradient_at_n150_d1_differs_from_the_jitted_one():
    """Why the parity tests above take the jitted JAX function as the reference: at their n = 150, d = 1 case
    (rbf order 2, CG tolerance 1e-3, rank 20) JAX's op-by-op dispatch and its jitted value_and_grad of the same
    lattice_nlml round differently, and their mean gradients differ by more than the 2e-3 parity bound, while
    the value and the other gradients agree within it."""
    n, d = 150, 1
    x, y = _data(n, d)
    probes = _probes(n, 8)
    values = {"inv_ell": np.linspace(0.8, 1.5, d).astype(np.float32), "outputscale": np.float32(0.8),
              "noise": np.float32(0.1), "mean": np.float32(0.05)}
    cfg = j_mll.BBMMConfig(cg_tolerance=1e-3, max_cg_iterations=300, max_lanczos_iterations=40, num_probes=8,
                           precond_rank=20)
    f = lambda p: j_mll.lattice_nlml(j_kernels.rbf_kernel(2), cfg, p, jnp.asarray(x.numpy()), jnp.asarray(y.numpy()),
                                     jnp.asarray(probes.numpy()))
    e_val, e_grad = jax.value_and_grad(f)({k: jnp.asarray(v) for k, v in values.items()})
    j_val, j_grad = _jax_value_and_grad(f, values)
    assert abs(float(e_val) - float(j_val)) <= 1e-5
    assert rel_err(np.asarray(e_grad["mean"]), np.asarray(j_grad["mean"])) > 2e-3
    for k in ("inv_ell", "outputscale", "noise"):
        assert rel_err(np.asarray(e_grad[k]), np.asarray(j_grad[k])) <= 2e-3, k


def test_config_rejects_unported_modes():
    """Both gradient modes are ported; an unknown mode of either kind is refused."""
    assert t_mll.BBMMConfig(grad_mode="deriv_filter").grad_mode == "deriv_filter"
    with pytest.raises(ValueError, match="grad_mode"):
        t_mll.BBMMConfig(grad_mode="deriv")
    with pytest.raises(ValueError, match="slq_mode"):
        t_mll.BBMMConfig(slq_mode="exact")


def test_closed_form_backward_matches_autograd_through_khat():
    """_iql_bwd's closed form = torch autograd of <U, K_hat(params) V> through the exact-grad filter."""
    x, y = _data(n=200, d=3, seed=4)
    dk = t_kernels.matern_kernel(1.5, 1)
    cfg = t_mll.BBMMConfig(cg_tolerance=1e-3, num_probes=4, precond_rank=10)
    probes = _probes(200, 4)
    params = _params(3, requires_grad=True)
    yc = (y - params["mean"]).detach().requires_grad_(True)
    iq, ld = t_mll.lattice_inv_quad_logdet(dk, cfg, params, x, yc, probes)
    a, b = 0.7, -1.3
    grads = torch.autograd.grad(a * iq + b * ld, [params["inv_ell"], params["outputscale"], params["noise"], yc])
    with torch.no_grad():
        sys_ = t_mll._solve_system(dk, cfg, params, x, yc, probes)
    alpha, z = sys_.solves[:, :1], sys_.solves[:, 1:]
    U = torch.cat([-a * alpha, (b / 4) * z], dim=-1)
    V = torch.cat([alpha, sys_.probes_right], dim=-1)
    form = (U * t_mll._khat_matmul_diff(params, x, dk, V)).sum()
    ref = torch.autograd.grad(form, [params["inv_ell"], params["outputscale"], params["noise"]])
    for got, want in zip(grads[:3], ref):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(grads[3], 2 * a * alpha[:, 0], rtol=1e-6, atol=0)


# ---- grad_mode="deriv_filter" ------------------------------------------------------


@pytest.mark.parametrize("tol,rank", [(1.0, 100), (1e-3, 20)])
@pytest.mark.parametrize("n,d,kind,order", [(150, 1, "rbf", 2), (300, 3, "matern", 1), (400, 5, "rbf", 1)])
def test_lattice_nlml_deriv_filter_matches_jax(n, d, kind, order, tol, rank):
    """Value and reference-parity gradients on the same probes."""
    x, y = _data(n, d)
    probes = _probes(n, 8)
    values = {"inv_ell": np.linspace(0.8, 1.5, d).astype(np.float32), "outputscale": np.float32(0.8),
              "noise": np.float32(0.1), "mean": np.float32(0.05)}
    kw = dict(cg_tolerance=tol, max_cg_iterations=300, max_lanczos_iterations=40, num_probes=8,
              precond_rank=rank, grad_mode="deriv_filter")
    jdk = j_kernels.rbf_kernel(order) if kind == "rbf" else j_kernels.matern_kernel(1.5, order)
    tdk = t_kernels.rbf_kernel(order) if kind == "rbf" else t_kernels.matern_kernel(1.5, order)
    j_val, j_grad = _jax_value_and_grad(
        lambda p: j_mll.lattice_nlml(jdk, j_mll.BBMMConfig(**kw), p, jnp.asarray(x.numpy()),
                                     jnp.asarray(y.numpy()), jnp.asarray(probes.numpy())), values)
    t_params = {k: torch.tensor(v, requires_grad=True) for k, v in values.items()}
    t_val, t_grad = _grads(lambda p: t_mll.lattice_nlml(tdk, t_mll.BBMMConfig(**kw), p, x, y, probes), t_params)
    assert abs(t_val - float(j_val)) <= 1e-5
    for k in values:
        assert rel_err(t_grad[k], j_grad[k]) <= 2e-3, k


def test_deriv_closed_form_backward_matches_autograd_through_khat():
    """The deriv branch of the closed form = autograd of <U, K_hat(params) V> through lattice_filter."""
    x, y = _data(n=200, d=3, seed=4)
    dk = t_kernels.matern_kernel(1.5, 1)
    cfg = t_mll.BBMMConfig(cg_tolerance=1e-3, num_probes=4, precond_rank=10, grad_mode="deriv_filter")
    probes = _probes(200, 4)
    params = _params(3, requires_grad=True)
    yc = (y - params["mean"]).detach().requires_grad_(True)
    iq, ld = t_mll.lattice_inv_quad_logdet(dk, cfg, params, x, yc, probes)
    a, b = 0.7, -1.3
    grads = torch.autograd.grad(a * iq + b * ld, [params["inv_ell"], params["outputscale"], params["noise"], yc])
    with torch.no_grad():
        sys_ = t_mll._solve_system(dk, cfg, params, x, yc, probes)
    alpha, z = sys_.solves[:, :1], sys_.solves[:, 1:]
    U = torch.cat([-a * alpha, (b / 4) * z], dim=-1)
    V = torch.cat([alpha, sys_.probes_right], dim=-1)
    form = (U * t_mll._khat_matmul_diff(params, x, dk, V, grad_mode="deriv_filter")).sum()
    ref = torch.autograd.grad(form, [params["inv_ell"], params["outputscale"], params["noise"]])
    for got, want in zip(grads[:3], ref):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(grads[3], 2 * a * alpha[:, 0], rtol=1e-6, atol=0)
    exact = torch.autograd.grad((U * t_mll._khat_matmul_diff(params, x, dk, V)).sum(), params["inv_ell"])[0]
    assert not torch.allclose(exact, ref[0], rtol=1e-3)  # the two modes are different estimates


def test_simplex_gp_trains_with_deriv_filter():
    """SimplexGP.nlml with grad_mode="deriv_filter" through fit_adam, and its raw gradients against JAX."""
    import simplex_gp_torch as T
    import simplex_gp_tpu as J

    x, y = _data(n=200, d=2, seed=8)
    raw = {"raw_lengthscale": np.zeros(2, np.float32), "raw_outputscale": np.float32(0.0),
           "raw_noise": np.float32(-1.0), "mean": np.float32(0.0)}
    kw = dict(num_dims=2, kernel="matern", nu=1.5, order=1, min_noise=0.01)
    bbmm = dict(num_probes=6, precond_rank=20, grad_mode="deriv_filter")
    probes = _probes(200, 6, seed=3)
    jm = J.SimplexGP(**kw, bbmm=J.BBMMConfig(**bbmm))
    j_grad = jax.grad(lambda r: j_mll.lattice_nlml(jm.dk, jm.bbmm, jm.constrained(r), jnp.asarray(x.numpy()),
                                                   jnp.asarray(y.numpy()), jnp.asarray(probes.numpy())))(
        {k: jnp.asarray(v) for k, v in raw.items()})
    model = T.SimplexGP(**kw, bbmm=T.BBMMConfig(**bbmm)).load_raw(raw)
    model.nlml(x, y, probes=probes).backward()
    for k in raw:
        assert rel_err(getattr(model, k).grad, j_grad[k]) <= 2e-3, k
    hist = T.fit_adam(lambda gen: model.nlml(x, y, generator=gen), model.parameters(), epochs=15, lr=0.1)
    assert hist["loss"][-1] < hist["loss"][0] - 0.05
