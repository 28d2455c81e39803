"""The training path end to end: SimplexGP.nlml, DenseGP, fit_adam, the trainer CLI.

The port on the CPU (plain kernel versions) against the JAX package on the
same raw parameters and numpy probes.  Tolerances, each with its reason:
  * SimplexGP.nlml against JAX's lattice_nlml on model.constrained(raw):
    both run the CG on the sort chain, the port's backward on the join
    operator (rel 2e-5 apart), value 1e-5 and raw gradients rel 2e-3, as
    tests/test_torch_mll.py;
  * DenseGP: dense f32 Cholesky on both sides, value rel 1e-5, gradients
    rel 1e-4;
  * the Snelson parity port keeps the reference's bound, |delta MLL| < 0.1
    per datapoint (train_snelson.py:96).
"""

import json
import math
import pathlib
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
from simplex_gp_torch import convert, train
from simplex_gp_torch.utils.data import load_snelson
from simplex_gp_tpu.linalg.mll import lattice_nlml as j_lattice_nlml

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _problem(n=300, d=3, seed=11):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (np.sin(2 * x[:, 0]) + 0.5 * x[:, 1] + 0.2 * rng.normal(size=n)).astype(np.float32)
    raw = {"raw_lengthscale": np.log(np.expm1(np.array([0.7, 1.3, 2.0][:d], np.float32))),
           "raw_outputscale": np.float32(0.3), "raw_noise": np.float32(-1.5), "mean": np.float32(0.1)}
    return x, y, raw


@pytest.mark.parametrize("slq_mode", ["cg", "lanczos"])
@pytest.mark.parametrize("kernel", ["rbf", "matern"])
def test_simplex_nlml_and_raw_grads_match_jax(kernel, slq_mode):
    x, y, raw = _problem()
    kw = dict(num_dims=3, kernel=kernel, nu=1.5, order=1, min_noise=0.1)
    bbmm = dict(cg_tolerance=1.0, max_cg_iterations=500, max_lanczos_iterations=100, precond_rank=100,
                num_probes=10, slq_mode=slq_mode)
    probes = np.random.default_rng(5).choice([-1.0, 1.0], size=(300, 10)).astype(np.float32)
    jm = J.SimplexGP(**kw, bbmm=J.BBMMConfig(**bbmm))
    j_val, j_grad = jax.value_and_grad(
        lambda r: j_lattice_nlml(jm.dk, jm.bbmm, jm.constrained(r), jnp.asarray(x), jnp.asarray(y),
                                 jnp.asarray(probes)))({k: jnp.asarray(v) for k, v in raw.items()})
    tm = T.SimplexGP(**kw, bbmm=T.BBMMConfig(**bbmm)).load_raw(raw)
    loss = tm.nlml(torch.from_numpy(x), torch.from_numpy(y), probes=torch.from_numpy(probes))
    loss.backward()
    assert abs(float(loss.detach()) - float(j_val)) <= 1e-5
    for k in raw:
        assert rel_err(getattr(tm, k).grad, j_grad[k]) <= 2e-3, k


def test_simplex_nlml_draws_probes_from_the_generator():
    x, y, raw = _problem(n=100, d=2)
    raw["raw_lengthscale"] = raw["raw_lengthscale"][:2]
    tm = T.SimplexGP(num_dims=2, min_noise=0.1).load_raw(raw)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    a = tm.nlml(xt, yt, generator=torch.Generator().manual_seed(3))
    b = tm.nlml(xt, yt, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and torch.isfinite(a)
    with pytest.raises(ValueError):
        tm.nlml(xt, yt, probes=torch.ones(100, 3))


@pytest.mark.parametrize("kernel,nu", [("rbf", 1.5), ("matern", 1.5), ("matern", 2.5)])
def test_dense_nlml_and_predict_match_jax(kernel, nu):
    x, y, raw = _problem(n=120)
    xt = np.random.default_rng(2).normal(size=(30, 3)).astype(np.float32)
    jm = J.DenseGP(num_dims=3, kernel=kernel, nu=nu, min_noise=0.1)
    jraw = {k: jnp.asarray(v) for k, v in raw.items()}
    j_val, j_grad = jax.value_and_grad(lambda r: jm.nlml(r, jnp.asarray(x), jnp.asarray(y)))(jraw)
    j_mean, j_var = jm.predict(jraw, jnp.asarray(x), jnp.asarray(y), jnp.asarray(xt))
    tm = T.DenseGP(num_dims=3, kernel=kernel, nu=nu, min_noise=0.1).load_raw(raw)
    loss = tm.nlml(torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    assert abs(float(loss.detach()) - float(j_val)) <= 1e-5 * abs(float(j_val))
    for k in raw:
        assert rel_err(getattr(tm, k).grad, j_grad[k]) <= 1e-4, k
    t_mean, t_var = tm.predict(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(xt), block=16)
    np.testing.assert_allclose(t_mean.numpy(), np.asarray(j_mean), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t_var.numpy(), np.asarray(j_var), rtol=1e-4, atol=1e-6)


def test_snelson_mll_parity():
    """Port of test_snelson.py::test_snelson_mll_parity: 100 Adam epochs each, |delta MLL| < 0.1."""
    xs, ys = load_snelson()
    x, y = torch.from_numpy(xs), torch.from_numpy(ys)
    simplex = T.SimplexGP(num_dims=1, kernel="rbf", order=1, min_noise=1e-4,
                          bbmm=T.BBMMConfig(cg_tolerance=1e-4, max_cg_iterations=500,
                                            max_lanczos_iterations=100, num_probes=10))
    hist_s = T.fit_adam(lambda g: simplex.nlml(x, y, generator=g), simplex.parameters(), epochs=100, lr=0.1)
    dense = T.DenseGP(num_dims=1, kernel="rbf", min_noise=1e-4)
    hist_d = T.fit_adam(lambda g: dense.nlml(x, y), dense.parameters(), epochs=100, lr=0.1)
    assert hist_s["loss"][-1] < hist_s["loss"][0] and hist_d["loss"][-1] < hist_d["loss"][0]
    with torch.no_grad():
        mll_simplex = -float(simplex.nlml(x, y, generator=torch.Generator().manual_seed(123)))
        mll_dense = -float(dense.nlml(x, y))
    assert abs(mll_simplex - mll_dense) < 0.1, (mll_simplex, mll_dense)


def test_fit_adam_lowers_the_loss_and_redraws_probes():
    x, y, raw = _problem(n=150, d=2)
    raw["raw_lengthscale"] = raw["raw_lengthscale"][:2]
    model = T.SimplexGP(num_dims=2, min_noise=0.01, bbmm=T.BBMMConfig(num_probes=4)).load_raw(raw)
    seen = []

    def loss_fn(gen):
        probes = T.models.exact_gp.rademacher((150, 4), gen)
        seen.append(probes)
        return model.nlml(torch.from_numpy(x), torch.from_numpy(y), probes=probes)

    calls = []
    hist = T.fit_adam(loss_fn, model.parameters(), epochs=15, lr=0.1, seed=7,
                      callback=lambda e, loss, ms: calls.append((e, loss, ms)))
    assert hist["clock"] == "host" and len(hist["step_ms"]) == 15 and [c[0] for c in calls] == list(range(15))
    assert hist["loss"][-1] < hist["loss"][0] - 0.05
    assert not torch.equal(seen[0], seen[1])


def test_early_stopper():
    s = T.EarlyStopper(patience=2, min_delta=0.01)
    assert not s.step(1.0, "a") and s.is_best
    assert not s.step(0.995, "b") and not s.is_best  # within min_delta: no improvement
    assert not s.step(0.5, "c") and s.is_best and s.best_state == "c"
    assert not s.step(0.6) and not s.step(0.7)
    assert s.step(0.8) and s.best_score == 0.5 and s.counter == 3


def test_raw_params_round_trip_through_numpy():
    _, _, raw = _problem()
    model = T.SimplexGP(num_dims=3).load_raw(raw)
    back = convert.raw_params_to_numpy(model.raw())
    assert set(back) == set(raw)
    for k in raw:
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], np.asarray(raw[k], np.float32))


def test_median_lengthscale_matches_the_jax_trainer_formula():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2500, 4)).astype(np.float32)
    sub = x[np.random.default_rng(0).permutation(2500)[:2000]]  # experiments/common.py:100-103
    d2 = ((sub[:, None, :] - sub[None, :, :]) ** 2).sum(-1)
    assert train.median_lengthscale(x) == float(np.sqrt(np.median(d2[d2 > 0]))) / np.sqrt(2.0)


def test_trainer_cli_runs_on_snelson():
    out = subprocess.run([sys.executable, "-m", "simplex_gp_torch.train", "--dataset", "snelson", "--epochs",
                          "2", "--device", "cpu"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(line) for line in out.stdout.splitlines()]
    epochs = [r for r in lines if "epoch" in r]
    assert [r["epoch"] for r in epochs] == [0, 1]
    assert all(math.isfinite(r["train/mll"]) and r["cg_iters"] >= 1 for r in epochs)
    final = lines[-1]
    assert all(math.isfinite(final[k]) for k in ("test/rmse", "test/nll", "test/mae"))


def test_trainer_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--dataset", "snelson", "--epochs", "1", "--device", "cuda"])
