"""SKIP (models/ski.py) and its K13 kernels' plain versions against the JAX package, on the CPU.

Inputs are numpy draws from one seed fed to both.  The port fixes the signs
of the grid eigenvectors and of the range finder's Q and U_B
(``fix_signs``); JAX leaves them to LAPACK, so the model comparisons run
JAX inside ``port_signs``, which gives its ``eigh`` / ``qr`` / ``svd`` the
port's signs, with JAX's Omega arrays fed to the port.

Tolerances:
  * interpolation: indices equal, weights 1e-6 (the same float32 formula);
  * the plain K13 versions against the materialised M = R (.) F and JAX's
    jnp ops: rel 1e-5 (float32 sums in another order), backward too;
  * SKIP at d = 3, g = 100, rank 16 (well separated eigenvalues): root
    R R^T rel 1e-4, NLML 1e-5, raw gradients rel 1e-3, predictions 1e-4;
  * SKIP at the round-5 width (g = 100, rank 64, Matern-1.5): the grid
    kernel's 30-odd smallest kept eigenvalues lie within ~1e-6 of each
    other relative to the largest, so float32 LAPACKs return different
    eigenvectors for them (rotations, not signs; up to 0.4 apart at
    lengthscale 3), the range finder's fixed Omega then sketches a
    slightly different subspace, and eigh's backward divides by those
    gaps.  Measured on this problem: R R^T rel 3.6e-2, NLML 2.7e-4,
    gradient rel <= 4.7e-2 (the mean's; lengthscales 3.7e-2).  Bounds:
    R R^T 0.1, NLML 1e-3, gradient cos 0.995 and rel 0.1 over the whole
    raw gradient, predictive mean rms 5e-2 (measured 2.6e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401 (one intra-op thread per worker)
from jax_ski_signs import jax_omegas, port_signs, sign_weights
from torch_parity import rel_err

from simplex_gp_torch.kernels import ski as K
from simplex_gp_torch.models.exact_gp import DenseGP
from simplex_gp_torch.models.ski import SKIP, fix_signs
from simplex_gp_torch.models.ski import sign_weights as port_sign_weights
from simplex_gp_tpu.models import DenseGP as JDenseGP
from simplex_gp_tpu.models import ski as jski

RAW_NAMES = ("raw_lengthscale", "raw_outputscale", "raw_noise", "mean")


def _problem(n=500, d=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.5 * x[:, 1] * x[:, d - 1] + 0.1 * rng.normal(size=n)).astype(np.float32)
    return x, y


def _grid(xj, g):
    """JAX's grid origin and step for one column (ski.py:98-100)."""
    lo, hi = jnp.min(xj), jnp.max(xj)
    step = (hi - lo) / (g - 5) + 1e-12
    return np.float32(lo - 2 * step), np.float32(step)


def test_sign_weights_equal_and_rule():
    np.testing.assert_array_equal(port_sign_weights(1000).numpy(), sign_weights(1000))
    V = torch.from_numpy(np.random.default_rng(0).normal(size=(50, 7)).astype(np.float32))
    W = fix_signs(V)
    assert (port_sign_weights(50) @ W >= 0).all() and torch.equal(W.abs(), V.abs())
    assert torch.equal(fix_signs(-V), W)


@pytest.mark.parametrize("g", [9, 100])
def test_interp_matches_jax(g):
    x = np.random.default_rng(g).normal(size=700).astype(np.float32)
    gmin, step = _grid(jnp.asarray(x), g)
    j_idx, j_w = jski._interp_1d(jnp.asarray(x), gmin, step, g)
    idx, w = K.interp_taps(torch.from_numpy(x), torch.tensor(gmin), torch.tensor(step), g)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    assert float(np.abs(w.numpy() - np.asarray(j_w)).max()) <= 1e-6
    U = np.random.default_rng(1).normal(size=(g, 5)).astype(np.float32)
    F = K.interp_plain(torch.from_numpy(x), torch.tensor(gmin), torch.tensor(step), torch.from_numpy(U))
    want = (np.asarray(j_w)[:, :, None] * U[np.asarray(j_idx)]).sum(1)
    assert rel_err(F.numpy(), want) <= 1e-6


def _kr_inputs(n, r, k, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return f(n, r), f(n, r), f(r * r, k), f(n, k)


def _materialised(R, F):
    return (R[:, :, None] * F[:, None, :]).reshape(R.shape[0], -1)


# The kernels' block is 256 rows: its height -1, +0 and +1; r = 63; k = 1; k not a multiple of 4.
KR_EDGES = [(255, 64, 64), (256, 64, 64), (257, 63, 64), (256, 64, 1), (257, 64, 30)]


@pytest.mark.parametrize("n,r,k", [(257, 64, 64), (100, 24, 24), (33, 5, 7), *KR_EDGES])
def test_plain_kr_twins_match_materialised_and_jax(n, r, k):
    R, F, W, G = _kr_inputs(n, r, k)
    tR, tF, tW, tG = map(torch.from_numpy, (R, F, W, G))
    M = _materialised(tR, tF)
    jM = (jnp.asarray(R)[:, :, None] * jnp.asarray(F)[:, None, :]).reshape(n, -1)
    Q = G  # (n, k), the gram's left factor
    for got, want, jax_want in (
        (K.kr_matmul_plain(tR, tF, tW), M @ tW, jM @ jnp.asarray(W)),
        (K.kr_gram_plain(tG, tR, tF), tG.T @ M, jnp.asarray(Q).T @ jM),
    ):
        assert rel_err(got.numpy(), want.numpy()) <= 1e-5
        assert rel_err(got.numpy(), np.asarray(jax_want)) <= 1e-5
    dR, dF = K.kr_adjoint_plain(tR, tF, tW, tG)
    jdR, jdF = jax.vjp(lambda a, b: (a[:, :, None] * b[:, None, :]).reshape(n, -1) @ jnp.asarray(W),
                       jnp.asarray(R), jnp.asarray(F))[1](jnp.asarray(G))
    assert rel_err(dR.numpy(), np.asarray(jdR)) <= 1e-5 and rel_err(dF.numpy(), np.asarray(jdF)) <= 1e-5


@pytest.mark.parametrize("n,r,k", [(257, 64, 64), (60, 12, 9), *KR_EDGES])
def test_autograd_functions_match_autograd_and_vjp(n, r, k):
    R, F, W, G = _kr_inputs(n, r, k, seed=1)
    Qn = np.random.default_rng(2).normal(size=(n, k)).astype(np.float32)
    dB = np.random.default_rng(3).normal(size=(k, r * r)).astype(np.float32)

    def leaves():
        return [torch.from_numpy(a).requires_grad_() for a in (R, F, W, Qn)]

    tR, tF, tW, tQ = leaves()
    K.KhatriRaoMatmul.apply(tR, tF, tW).backward(torch.from_numpy(G))
    K.KhatriRaoGram.apply(tQ, tR, tF).backward(torch.from_numpy(dB))
    got = [t.grad.numpy() for t in (tR, tF, tW, tQ)]
    aR, aF, aW, aQ = leaves()
    M = _materialised(aR, aF)
    (((M @ aW) * torch.from_numpy(G)).sum() + ((aQ.T @ M) * torch.from_numpy(dB)).sum()).backward()
    want = [t.grad.numpy() for t in (aR, aF, aW, aQ)]

    def jfun(a, b, w, q):
        jM = (a[:, :, None] * b[:, None, :]).reshape(n, -1)
        return jM @ w, q.T @ jM

    _, vjp = jax.vjp(jfun, *map(jnp.asarray, (R, F, W, Qn)))
    jax_want = [np.asarray(v) for v in vjp((jnp.asarray(G), jnp.asarray(dB)))]
    for a, b, c in zip(got, want, jax_want):
        assert rel_err(a, b) <= 1e-5 and rel_err(a, c) <= 1e-5


def test_interp_function_backward_is_the_scatter():
    x = np.random.default_rng(4).normal(size=300).astype(np.float32)
    g, r = 40, 6
    gmin, step = _grid(jnp.asarray(x), g)
    U = torch.from_numpy(np.random.default_rng(5).normal(size=(g, r)).astype(np.float32)).requires_grad_()
    dF = np.random.default_rng(6).normal(size=(300, r)).astype(np.float32)
    K.SkiInterp.apply(torch.from_numpy(x), torch.tensor(gmin), torch.tensor(step), U).backward(torch.from_numpy(dF))
    j_idx, j_w = jski._interp_1d(jnp.asarray(x), gmin, step, g)
    _, vjp = jax.vjp(lambda u: (j_w[:, :, None] * u[j_idx]).sum(axis=1), jnp.asarray(U.detach().numpy()))
    assert rel_err(U.grad.numpy(), np.asarray(vjp(jnp.asarray(dF))[0])) <= 1e-5


@pytest.mark.parametrize("n,g,r", [(300, 40, 6), (5000, 100, 64), (20000, 100, 16), (1, 9, 3)])
def test_interp_backward_twin_matches_vjp_and_repeats(n, g, r):
    """K13a's backward twin, in the kernel's order (sub-ranges, slices, blocks), against jax.vjp of the
    gather (rel 1e-5: float32 sums in another order) and the index_add_ scatter (rel 1e-6), and the same
    bits twice."""
    x = np.random.default_rng(n).normal(size=n).astype(np.float32)
    gmin, step = _grid(jnp.asarray(x), g)
    dF = np.random.default_rng(6).normal(size=(n, r)).astype(np.float32)
    args = (torch.from_numpy(x), torch.tensor(gmin), torch.tensor(step), torch.from_numpy(dF), g)
    dU = K.interp_backward_plain(*args)
    assert torch.equal(dU, K.interp_backward_plain(*args))
    j_idx, j_w = jski._interp_1d(jnp.asarray(x), gmin, step, g)
    _, vjp = jax.vjp(lambda u: (j_w[:, :, None] * u[j_idx]).sum(axis=1), jnp.zeros((g, r), jnp.float32))
    assert rel_err(dU.numpy(), np.asarray(vjp(jnp.asarray(dF))[0])) <= 1e-5
    idx, w = K.interp_taps(*args[:3], g)
    scatter = torch.zeros((g, r)).index_add_(0, idx.reshape(-1), (w[:, :, None] * args[3][:, None, :]).reshape(-1, r))
    assert rel_err(dU.numpy(), scatter.numpy()) <= 1e-6


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 8447, 65536, 402223])
def test_interp_backward_split_covers_every_point_once(n):
    """The kernel's sub-ranges tile [0, n) in order: at most 132 blocks of 4 sub-ranges, none empty but the
    last ones."""
    blocks, span = K._scatter_split(n)
    assert 1 <= blocks <= 132 and span >= 1
    assert blocks * 4 * span >= n > (blocks - 1) * 4 * span or n == 0


def _pair(rank, kernel="matern", ell=1.2, n=500, grid_size=100):
    """(JAX model, raw dict, port model) at one lengthscale, the port fed JAX's Omega."""
    jm = jski.SKIP(num_dims=3, grid_size=grid_size, rank=rank, kernel=kernel, min_noise=0.1)
    raw = jm.init_params(lengthscale=ell)
    tm = SKIP(num_dims=3, grid_size=grid_size, rank=rank, kernel=kernel, min_noise=0.1, omegas=jax_omegas(3, rank))
    tm.load_raw({k: np.asarray(v) for k, v in raw.items()})
    return jm, raw, tm


def _compare(rank, bounds):
    x, y = _problem()
    xt = np.random.default_rng(9).normal(size=(60, 3)).astype(np.float32)
    jm, raw, tm = _pair(rank)
    jx, jy = jnp.asarray(x), jnp.asarray(y)

    def jax_all(r):
        return (jax.value_and_grad(lambda r_: jm.nlml(r_, jx, jy))(r), jm._root(jm.constrained(r), jx),
                jm.predict(r, jx, jy, jnp.asarray(xt)))

    with port_signs():
        (jl, jg), jR, (jmean, jvar) = jax.jit(jax_all)(raw)
    jR = np.asarray(jR)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    loss = tm.nlml(tx, ty)
    loss.backward()
    R = tm.root(tm.constrained(), tx).detach().numpy()
    mean, var = tm.predict(tx, ty, torch.from_numpy(xt))
    g = np.concatenate([getattr(tm, k).grad.numpy().ravel() for k in RAW_NAMES])
    jgv = np.concatenate([np.asarray(jg[k]).ravel() for k in RAW_NAMES])
    assert np.all(np.isfinite(g))
    assert rel_err(R @ R.T, jR @ jR.T) <= bounds["rrt"]
    assert abs(float(loss.detach()) - float(jl)) <= bounds["nlml"]
    assert float(g @ jgv / np.linalg.norm(g) / np.linalg.norm(jgv)) >= bounds["cos"]
    assert rel_err(g, jgv) <= bounds["grad"]
    assert float(np.sqrt(((mean.numpy() - np.asarray(jmean)) ** 2).mean())) <= bounds["mean"]
    assert rel_err(var.numpy(), np.asarray(jvar)) <= bounds["var"]


def test_skip_matches_jax_well_separated_rank():
    _compare(16, dict(rrt=1e-4, nlml=1e-5, cos=0.99999, grad=1e-3, mean=1e-4, var=1e-4))


def test_skip_matches_jax_at_round5_width():
    _compare(64, dict(rrt=0.1, nlml=1e-3, cos=0.995, grad=0.1, mean=5e-2, var=0.1))


def test_rbf_lengthscale_gradient_is_finite_where_jax_gives_nan():
    """RBF grid kernel, g = 100, rank 64: some of the top-64 eigenvalues are <= 0 in float32 and are clamped.

    JAX's d sqrt(maximum(e, 0)) / de is inf * 0 = NaN there, which makes its
    lengthscale gradients NaN; torch's clamp passes a zero gradient, so the
    port's are finite (a deliberate divergence, ROADMAP section 3).  The
    other gradients and the NLML agree.
    """
    x, y = _problem()
    jm, raw, tm = _pair(64, kernel="rbf", ell=1.63)
    gmin, step = _grid(jnp.asarray(x[:, 0]), 100)
    with torch.no_grad():
        grid = float(gmin) + float(step) * torch.arange(100, dtype=torch.float32)
        Kg = tm._grid_kernel_1d(tm.constrained()["inv_ell"][0], grid)
    assert int((torch.linalg.eigvalsh(Kg)[-64:] <= 0).sum()) > 0
    with port_signs():
        jl, jg = jax.jit(jax.value_and_grad(lambda r: jm.nlml(r, jnp.asarray(x), jnp.asarray(y))))(raw)
    assert np.isnan(np.asarray(jg["raw_lengthscale"])).any()
    loss = tm.nlml(torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    assert torch.isfinite(tm.raw_lengthscale.grad).all()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-3
    for k in ("raw_outputscale", "raw_noise"):
        assert rel_err(getattr(tm, k).grad.numpy(), np.asarray(jg[k])) <= 1e-2


def test_drawn_omega_is_seeded_on_the_cpu():
    tm = SKIP(num_dims=2, rank=8)
    w = tm.omega(1, 8, torch.device("cpu"))
    assert w.shape == (64, 8)
    assert torch.equal(w, torch.randn((64, 8), generator=torch.Generator().manual_seed(1)))


# Ports of tests/test_ski.py on the port alone.


def _ski_problem(n=100, d=1, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, size=(n, d)).astype(np.float32)
    y = (np.sin(2 * x[:, 0]) + 0.05 * rng.normal(size=n)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(y)


def test_skip_1d_matches_dense():
    x, y = _ski_problem()
    skip = SKIP(num_dims=1, grid_size=120, rank=100)
    dense = DenseGP(num_dims=1)
    with torch.no_grad():
        nl_s, nl_d = float(skip.nlml(x, y)), float(dense.nlml(x, y))
    assert abs(nl_s - nl_d) < 0.05, (nl_s, nl_d)
    xt = torch.linspace(-1.5, 1.5, 20)[:, None]
    ms, vs = skip.predict(x, y, xt)
    md, vd = dense.predict(x, y, xt)
    np.testing.assert_allclose(ms.numpy(), md.numpy(), atol=0.05)
    np.testing.assert_allclose(vs.numpy(), vd.numpy(), atol=0.05)


def test_skip_product_2d_trains():
    x, y = _ski_problem(n=150, d=2)
    skip = SKIP(num_dims=2, grid_size=40, rank=24)
    loss0 = skip.nlml(x, y)
    assert np.isfinite(float(loss0.detach()))
    loss0.backward()
    with torch.no_grad():
        for p in skip.parameters():
            p -= 0.1 * p.grad
        assert float(skip.nlml(x, y)) < float(loss0)


def test_skip_1d_matches_jax_dense_gp_too():
    """The 1-D KISS limit against JAX's dense GP (the JAX test's reference), same inputs."""
    x, y = _ski_problem()
    skip = SKIP(num_dims=1, grid_size=120, rank=100)
    jd = JDenseGP(num_dims=1)
    with torch.no_grad():
        nl_s = float(skip.nlml(x, y))
    nl_d = float(jd.nlml(jd.init_params(), jnp.asarray(x.numpy()), jnp.asarray(y.numpy())))
    assert abs(nl_s - nl_d) < 0.05


def test_host_grid_eigh_runs_in_one_thread_and_restores_the_count():
    """The grid factors run on the host in one torch thread, forward and backward; the caller's count returns."""
    x, y = map(torch.from_numpy, _problem(n=200))
    skip = SKIP(num_dims=3, grid_size=30, rank=8, kernel="matern", min_noise=0.1)
    seen = []
    real = skip.grid_factor

    def spy(*args):
        seen.append(torch.get_num_threads())
        return real(*args)

    skip.grid_factor = spy
    torch.set_num_threads(2)
    try:
        skip.nlml(x, y).backward()
        assert torch.get_num_threads() == 2
    finally:
        torch.set_num_threads(1)
    assert seen == [1, 1, 1] and torch.isfinite(skip.raw_lengthscale.grad).all()
