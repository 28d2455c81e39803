"""Ports of tests/test_love.py: the randomized-root predictive variance against the exact lattice posterior.

On the port alone, with the JAX tests' bounds: max relative variance error
< 0.15 at rank 100 (with the cached variance an upper bound of the exact
one, up to 1e-4), and the error at rank 100 below half the error at rank
10.  The exact posterior materialises the port's lattice operator by
filtering the identity.
"""

import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401 (one intra-op thread per worker)

import simplex_gp_torch as T
from simplex_gp_torch.models.components import init_raw_params
from simplex_gp_torch.ops.filter import lattice_filter, lattice_filter_rect
from simplex_gp_torch.utils.data import load_snelson


@torch.no_grad()
def _lattice_posterior_var_exact(model, x, x_test):
    """Exact posterior variance of the lattice kernel operator, O(n^2)."""
    params = model.constrained()
    n = x.shape[0]
    ref, ref_test = x * params["inv_ell"], x_test * params["inv_ell"]
    s, noise = float(params["outputscale"]), float(params["noise"])
    K = s * lattice_filter(torch.eye(n), ref, model.dk).double().numpy()
    K = 0.5 * (K + K.T) + noise * np.eye(n)
    Kst = s * lattice_filter_rect(torch.eye(n), ref, ref_test, model.dk).double().numpy()
    sol = np.linalg.solve(K, Kst.T)
    return s + noise - (Kst * sol.T).sum(axis=-1)


def _model(d, **init):
    model = T.SimplexGP(num_dims=d, kernel="rbf", order=1, min_noise=1e-4,
                        bbmm=T.BBMMConfig(max_cg_iterations=500, max_lanczos_iterations=100))
    return model.load_raw(init_raw_params(d, **init))


@pytest.mark.parametrize("d", [1, 2])
def test_love_variance_vs_exact_lattice_posterior(d):
    rng = np.random.default_rng(0)
    n, nt = 512, 128
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    y = torch.from_numpy((np.sin(x.numpy().sum(-1)) + 0.1 * rng.normal(size=n)).astype(np.float32))
    x_test = torch.from_numpy(rng.normal(size=(nt, d)).astype(np.float32))
    model = _model(d, noise=0.05)
    _, var = model.predict(x, y, x_test, generator=torch.Generator().manual_seed(1))
    var_exact = _lattice_posterior_var_exact(model, x, x_test)
    rel = np.abs(var.numpy() - var_exact) / np.abs(var_exact)
    assert float(rel.max()) < 0.15, f"max rel var err {rel.max():.3f}"
    # The root inverse is truncated, so the cached variance bounds the exact one from above.
    assert np.all(var.numpy() >= var_exact - 1e-4)


def test_love_variance_improves_with_rank():
    rng = np.random.default_rng(3)
    n, nt, d = 512, 64, 2
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    y = torch.from_numpy(np.sin(x.numpy().sum(-1)).astype(np.float32))
    x_test = torch.from_numpy(rng.normal(size=(nt, d)).astype(np.float32))
    model = T.SimplexGP(num_dims=d, kernel="rbf", order=1, min_noise=1e-4).load_raw(
        init_raw_params(d, noise=0.05))
    var_exact = _lattice_posterior_var_exact(model, x, x_test)
    errs = []
    for rank in (10, 100):
        cache = model.posterior_cache(x, y, generator=torch.Generator().manual_seed(0), root_rank=rank)
        _, var = model.predict_from_cache(cache, x, x_test)
        errs.append(float(np.abs(var.numpy() - var_exact).max()))
    assert errs[1] < 0.5 * errs[0], f"rank 10 err {errs[0]:.4f} -> rank 100 err {errs[1]:.4f}"


def test_love_variance_snelson_end_to_end():
    """On Snelson, against the exact posterior of the lattice operator (not the dense RBF's: test_love.py)."""
    xs, ys = load_snelson()
    x, y = torch.from_numpy(xs), torch.from_numpy(ys)
    x_test = torch.linspace(float(x.min()), float(x.max()), 100)[:, None]
    model = _model(1, lengthscale=0.6, outputscale=1.0, noise=0.1)
    _, var = model.predict(x, y, x_test, generator=torch.Generator().manual_seed(0))
    var_exact = _lattice_posterior_var_exact(model, x, x_test)
    rel = np.abs(var.numpy() - var_exact) / np.abs(var_exact)
    assert float(rel.max()) < 0.15, f"max rel var err {rel.max():.3f}"
