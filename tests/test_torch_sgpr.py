"""SGPR (models/sgpr.py) against the JAX package, on the CPU, with the same inducing rows.

The port draws its inducing rows with torch's generator and JAX with
``jax.random.choice``, so every comparison loads JAX's raw dict, its
``inducing`` rows included, into the port.  Tolerances: the same float32
matmul-form distances, Cholesky factors and triangular solves in another
library, summed in another order: NLML 1e-5 absolute (values O(1)),
gradients rel 1e-3 (the inducing rows' gradient passes through two
triangular solves with Kmm's condition number), predictions rel 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401 (one intra-op thread per worker)
from torch_parity import rel_err

from simplex_gp_torch.models.exact_gp import DenseGP
from simplex_gp_torch.models.sgpr import SGPR
from simplex_gp_tpu.models.sgpr import SGPR as JSGPR

RAW_NAMES = ("raw_lengthscale", "raw_outputscale", "raw_noise", "mean", "inducing")


def _problem(n=80, d=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.5 * x[:, 1] + 0.05 * rng.normal(size=n)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("kernel,m,ell", [("rbf", 20, 0.7), ("matern", 64, 1.3)])
def test_sgpr_matches_jax(kernel, m, ell):
    x, y = _problem(n=300, d=3)
    xt = np.random.default_rng(5).normal(size=(40, 3)).astype(np.float32)
    jm = JSGPR(num_dims=3, num_inducing=m, kernel=kernel, min_noise=0.1)
    raw = jm.init_params(jnp.asarray(x), seed=3, lengthscale=ell)
    raw["mean"] = jnp.asarray(0.2, jnp.float32)
    jl, jg = jax.jit(jax.value_and_grad(lambda r: jm.nlml(r, jnp.asarray(x), jnp.asarray(y))))(raw)
    jmean, jvar = jax.jit(lambda r: jm.predict(r, jnp.asarray(x), jnp.asarray(y), jnp.asarray(xt)))(raw)

    tm = SGPR(num_dims=3, num_inducing=m, kernel=kernel, min_noise=0.1)
    tm.load_raw({k: np.asarray(v) for k, v in raw.items()})
    np.testing.assert_array_equal(tm.inducing.detach().numpy(), np.asarray(raw["inducing"]))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    loss = tm.nlml(tx, ty)
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5
    for k in RAW_NAMES:
        assert rel_err(getattr(tm, k).grad.numpy(), np.asarray(jg[k])) <= 1e-3, k
    mean, var = tm.predict(tx, ty, torch.from_numpy(xt))
    assert rel_err(mean.numpy(), np.asarray(jmean)) <= 1e-4
    assert rel_err(var.numpy(), np.asarray(jvar)) <= 1e-4


def test_init_inducing_draws_training_rows():
    x, _ = _problem(n=50)
    tm = SGPR(num_dims=2, num_inducing=16).init_inducing(torch.from_numpy(x), seed=1)
    z = tm.inducing.detach().numpy()
    assert z.shape == (16, 2) and len({tuple(r) for r in z}) == 16
    assert all((x == r).all(axis=1).any() for r in z)
    again = SGPR(num_dims=2, num_inducing=16).init_inducing(torch.from_numpy(x), seed=1)
    assert torch.equal(again.inducing, tm.inducing)
    few = SGPR(num_dims=2, num_inducing=512).init_inducing(torch.from_numpy(x), seed=1)
    assert few.inducing.shape == (50, 2) and few.num_inducing == 50


# Ports of tests/test_sgpr.py on the port alone.


def test_sgpr_exact_limit():
    # With inducing = all training inputs, the collapsed bound equals the
    # exact NLML and predictions match the dense GP.
    x, y = map(torch.from_numpy, _problem())
    sgpr = SGPR(num_dims=2, num_inducing=x.shape[0]).init_inducing(x)
    sgpr.load_raw({**sgpr.raw(), "inducing": x})  # all points, in order
    dense = DenseGP(num_dims=2)
    with torch.no_grad():
        nl_s, nl_d = float(sgpr.nlml(x, y)), float(dense.nlml(x, y))
    assert abs(nl_s - nl_d) < 0.02, (nl_s, nl_d)
    xt = x[:10] + 0.1
    ms, vs = sgpr.predict(x, y, xt)
    md, vd = dense.predict(x, y, xt)
    np.testing.assert_allclose(ms.numpy(), md.numpy(), atol=0.02)
    np.testing.assert_allclose(vs.numpy(), vd.numpy(), atol=0.02)


def test_sgpr_trains():
    x, y = map(torch.from_numpy, _problem(n=120))
    sgpr = SGPR(num_dims=2, num_inducing=20).init_inducing(x)
    loss0 = sgpr.nlml(x, y)
    loss0.backward()
    with torch.no_grad():
        for p in sgpr.parameters():
            p -= 0.1 * p.grad
        assert float(sgpr.nlml(x, y)) < float(loss0.detach())
