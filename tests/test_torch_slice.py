"""The serving slice end to end: SimplexGP.posterior_cache + predict_from_cache.

The port (plain kernel versions, CPU) against the JAX package on the same
raw parameters and the same sketch matrix omega, drawn exactly as
exact_gp.py:328 draws it and handed to the port.  Tolerances:
  * eval_cg_tolerance 1e-5: the solves are tight, so alpha, mean and
    variance agree to f32 roundoff amplified by CG (rel 1e-4);
  * the default 1e-2: the CG iteration counts may differ by one (the mean
    residual crosses the tolerance within f32 noise of the two reduction
    orders); mean within 1e-2 of the target scale, variance rel 1e-3.
"""

import pathlib
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel_err

import simplex_gp_torch as T
import simplex_gp_tpu as J
from simplex_gp_torch import convert
from simplex_gp_torch.utils.data import load_snelson
from simplex_gp_tpu.linalg.cg import cg_solve
from simplex_gp_tpu.linalg.mll import build_precond
from simplex_gp_tpu.models.components import constrain
from simplex_gp_tpu.ops.filter import build_plan_any

ROOT = pathlib.Path(__file__).resolve().parents[1]
ELEVATORS_PARAMS = ROOT / "runs" / "r5" / "simplexgp_elevators_s0" / "model_best.pkl"


def _problem(name):
    rng = np.random.default_rng(21)
    if name == "matern_d3":
        n, d = 1024, 3
        x = rng.normal(size=(n, d)).astype(np.float32)
        y = (np.sin(2 * x[:, 0]) + 0.3 * rng.normal(size=n)).astype(np.float32)
        xt = rng.normal(size=(128, d)).astype(np.float32)
        kw = dict(num_dims=d, kernel="matern", nu=1.5, order=1, min_noise=0.1)
        ls = np.array([0.7, 1.2, 2.0], np.float32)
    else:
        xs, ys = load_snelson()
        x, y, xt = xs[::2], ys[::2], xs[1::2]
        kw = dict(num_dims=1, kernel="rbf", order=1, min_noise=1e-4)
        ls = np.array([0.5], np.float32)
    raw = {k: np.asarray(v) for k, v in J.SimplexGP(**kw).init_params(lengthscale=1.0).items()}
    raw["raw_lengthscale"] = np.log(np.expm1(ls)).astype(np.float32)
    raw["raw_noise"] = np.float32(-2.0)
    return kw, raw, x, y, xt


def _jax_cg_iters(model, raw, x, y):
    """Iterations of the eval CG inside JAX's posterior_cache (same pieces, run alone)."""
    params = model.constrained(raw)
    ref = x * params["inv_ell"]
    plan = build_plan_any(ref, model.dk)
    P = build_precond(model.dk, model.bbmm, params, ref, x.shape[0])
    from simplex_gp_tpu.linalg.pivoted_cholesky import precond_solve

    r = cg_solve(model._khat_mv(params, plan), (y - params["mean"])[:, None],
                 tol=model.eval_cg_tolerance, max_iters=model.bbmm.max_cg_iterations,
                 precond=lambda V: precond_solve(P, V))
    return int(r.iterations)


@pytest.mark.parametrize("tol", [1e-5, 1e-2])
@pytest.mark.parametrize("problem", ["matern_d3", "snelson"])
def test_posterior_cache_and_predict_match_jax(problem, tol):
    kw, raw, x, y, xt = _problem(problem)
    jm = J.SimplexGP(**kw, eval_cg_tolerance=tol)
    jraw = {k: jnp.asarray(v) for k, v in raw.items()}
    key = jax.random.PRNGKey(0)
    jc = jm.posterior_cache(jraw, jnp.asarray(x), jnp.asarray(y), key)
    jmean, jvar = map(np.asarray, jm.predict_from_cache(jc, jnp.asarray(x), jnp.asarray(xt)))
    m = min(jm.bbmm.max_lanczos_iterations, x.shape[0])
    omega = np.array(jax.random.normal(key, (x.shape[0], m), jnp.float32))  # exact_gp.py:328
    j_iters = _jax_cg_iters(jm, jraw, jnp.asarray(x), jnp.asarray(y))

    tm = T.SimplexGP(**kw, eval_cg_tolerance=tol).load_raw(raw)
    tc = tm.posterior_cache(torch.from_numpy(x), torch.from_numpy(y), omega=torch.from_numpy(omega))
    tmean, tvar = tm.predict_from_cache(tc, torch.from_numpy(x), torch.from_numpy(xt))
    assert tmean.shape == tvar.shape == (xt.shape[0],)

    if tol < 1e-3:
        assert tc["cg_iters"] == j_iters
        assert rel_err(tc["alpha"].numpy(), np.asarray(jc["alpha"])) < 1e-4
        np.testing.assert_allclose(tmean.numpy(), jmean, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tvar.numpy(), jvar, rtol=1e-4)
    else:
        assert abs(tc["cg_iters"] - j_iters) <= 1
        np.testing.assert_allclose(tmean.numpy(), jmean, atol=1e-2)
        np.testing.assert_allclose(tvar.numpy(), jvar, rtol=1e-3)


def test_predict_is_cache_then_predict_from_cache():
    kw, raw, x, y, xt = _problem("snelson")
    tm = T.SimplexGP(**kw).load_raw(raw)
    x, y, xt = map(torch.from_numpy, (x, y, xt))
    mean, var = tm.predict(x, y, xt, generator=torch.Generator().manual_seed(3))
    cache = tm.posterior_cache(x, y, generator=torch.Generator().manual_seed(3))
    mean2, var2 = tm.predict_from_cache(cache, x, xt)
    torch.testing.assert_close(mean, mean2, rtol=0, atol=0)
    torch.testing.assert_close(var, var2, rtol=0, atol=0)


def test_convert_elevators_params_match_jax_constrain():
    raw_np = convert.load_jax_params(ELEVATORS_PARAMS)
    assert set(raw_np) == {"raw_lengthscale", "raw_outputscale", "raw_noise", "mean"}
    raw_t = convert.raw_params_from_numpy(raw_np)
    assert all(v.dtype == torch.float32 for v in raw_t.values())
    model = T.SimplexGP(num_dims=18, kernel="matern", nu=1.5, order=1, min_noise=0.1).load_raw(raw_t)
    ours = {k: v.detach().numpy() for k, v in model.constrained().items()}
    ref = {k: np.asarray(v) for k, v in constrain({k: jnp.asarray(v) for k, v in raw_np.items()}, 0.1).items()}
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-6, err_msg=k)


def test_load_jax_params_refuses_other_objects(tmp_path):
    path = tmp_path / "evil.pkl"
    with open(path, "wb") as f:
        pickle.dump({"mean": pathlib.Path("x")}, f)
    with pytest.raises(pickle.UnpicklingError):
        convert.load_jax_params(path)


def test_import_leaves_jax_out():
    code = ("import sys; import simplex_gp_torch, simplex_gp_torch.convert, simplex_gp_torch.utils.data, "
            "simplex_gp_torch.ops.filter, simplex_gp_torch.kernels.build; "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m); "
            "import torch; assert not torch.backends.cuda.matmul.allow_tf32; "
            "assert not torch.backends.cudnn.allow_tf32; "
            "assert torch.get_float32_matmul_precision() == 'highest'")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
