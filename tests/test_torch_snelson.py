"""Ports of tests/test_snelson.py's prediction and LOVE tests, on the port alone (the main path's gate).

``test_snelson_mll_parity`` is ported in test_torch_training.py.  The bounds
are the JAX tests': held-out RMSE < 0.35 with 90% of the residuals within
3 sigma; the cached posterior (randomized rank-128 root) against the dense
posterior of the same lattice operator, mean rtol 0.05 / atol 0.02 and
variance relative error median < 0.10, 90th percentile < 0.20.  The dense
operator is the port's join plan applied to the identity, as JAX's is its
chain plan's (the same operator to rel 2e-5).
"""

import numpy as np
import torch
import torch_parity  # noqa: F401 (one intra-op thread per worker)

import simplex_gp_torch as T
from simplex_gp_torch.ops.filter import lattice_filter_rect
from simplex_gp_torch.ops.lattice import apply_plan_join, build_plan_join
from simplex_gp_torch.utils.data import load_snelson


def test_snelson_prediction_quality():
    """Train on the even Snelson rows (60 Adam epochs), predict the odd ones."""
    xs, ys = load_snelson()
    x, y = torch.from_numpy(xs), torch.from_numpy(ys)
    xt, yt, xe, ye = x[::2], y[::2], x[1::2], y[1::2]
    simplex = T.SimplexGP(num_dims=1, kernel="rbf", order=1, min_noise=1e-4,
                          bbmm=T.BBMMConfig(cg_tolerance=1e-4, max_lanczos_iterations=100))
    T.fit_adam(lambda g: simplex.nlml(xt, yt, generator=g), simplex.parameters(), epochs=60, lr=0.1)
    mean, var = simplex.predict(xt, yt, xe, generator=torch.Generator().manual_seed(0))
    rmse = float(torch.sqrt(((mean - ye) ** 2).mean()))
    assert rmse < 0.35, f"Snelson held-out RMSE {rmse}"
    assert bool((var > 0).all())
    z = (mean - ye).abs() / torch.sqrt(var)
    assert float((z < 3).float().mean()) > 0.9


def test_love_variance_matches_dense_lattice_posterior():
    """The fast-variance cache reproduces the dense posterior of the same lattice operator."""
    n, n_test, d = 1024, 128, 2
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    y = torch.from_numpy((np.sin(2 * x[:, 0].numpy()) + 0.3 * rng.normal(size=n)).astype(np.float32))
    x_test = torch.from_numpy(rng.normal(size=(n_test, d)).astype(np.float32))
    model = T.SimplexGP(num_dims=d, kernel="rbf", order=1,
                        bbmm=T.BBMMConfig(cg_tolerance=1e-4, max_cg_iterations=400, max_lanczos_iterations=128,
                                          num_probes=8),
                        eval_cg_tolerance=1e-4)
    mean_fast, var_fast = model.predict(x, y, x_test, generator=torch.Generator().manual_seed(3))

    with torch.no_grad():
        params = model.constrained()
        s, noise = float(params["outputscale"]), float(params["noise"])
        ref, ref_t = x * params["inv_ell"], x_test * params["inv_ell"]
        dk = model.dk
        eye = torch.eye(n)
        Khat = s * apply_plan_join(build_plan_join(ref, dk.coeffs, dk.variance), eye, dk.coeffs).double().numpy()
        Kst = s * lattice_filter_rect(eye, ref, ref_t, dk).double().numpy()
    Khat = 0.5 * (Khat + Khat.T) + noise * np.eye(n)
    mu = float(params["mean"].detach())
    yc = y.double().numpy() - mu
    mean_dense = Kst @ np.linalg.solve(Khat, yc) + mu
    var_dense = s + noise - np.einsum("tn,nm,tm->t", Kst, np.linalg.inv(Khat), Kst)

    np.testing.assert_allclose(mean_fast.numpy(), mean_dense, rtol=0.05, atol=0.02)
    rel = np.abs(var_fast.numpy() - var_dense) / np.abs(var_dense)
    assert np.median(rel) < 0.10, float(np.median(rel))
    assert np.quantile(rel, 0.9) < 0.20, float(np.quantile(rel, 0.9))
