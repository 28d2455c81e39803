"""The baseline trainers (``train_skip``, ``train_sgpr``, ``train_exact``) on the CPU, against JAX's.

``simplex_gp_torch.train.run_training`` takes two epochs (an eval at the
second) on a seeded 3-D problem from the same raw parameters as
experiments/common.py::run_training, SKIP with JAX's Omega and JAX's
eigenvector and range-finder signs matched to the port's
(``tests/jax_ski_signs.py``), SGPR with JAX's inducing rows.  The records
carry the same keys; the losses agree to 1e-4 (float32 Adam steps over the
same losses: SKIP's eigh and SVD, SGPR's triangular solves and the dense
GP's Cholesky summed in another order) and the test RMSE to 1e-3.  Then
the entry points' own files, and JAX's round-5 precipitation checkpoints
loaded through ``convert``.
"""

import argparse
import json
import pathlib
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401 (one intra-op thread per worker)
from jax_ski_signs import jax_omegas, port_signs

from simplex_gp_torch import convert, train, train_exact, train_sgpr, train_skip
from simplex_gp_torch.models.exact_gp import DenseGP
from simplex_gp_torch.models.sgpr import SGPR
from simplex_gp_torch.models.ski import SKIP
from simplex_gp_torch.utils.data import Dataset, load_dataset

ROOT = pathlib.Path(__file__).resolve().parents[1]
RUNS = ROOT / "runs" / "r5"
LOSS_ATOL = 1e-4
RMSE_ATOL = 1e-3


def _dataset(n=240, d=3, seed=0) -> Dataset:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n + 120, d)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.5 * x[:, 1] * x[:, 2] + 0.1 * rng.normal(size=n + 120)).astype(np.float32)
    return Dataset(x[:n], y[:n], x[n:n + 60], y[n:n + 60], x[n + 60:], y[n + 60:], "toy")


def _args(out, **kw):
    return argparse.Namespace(dataset="toy", data_dir=None, epochs=2, lr=0.1, seed=0, log_int=2, patience=20,
                              min_noise=0.1, out=str(out), max_n=0, ls_init="default", plan_capacity=0,
                              no_eval=False, host_loop=False, resume=False, **kw)


def _lines(run_dir):
    return [json.loads(line) for line in (pathlib.Path(run_dir) / "metrics.jsonl").read_text().splitlines()]


def _models(name, ds):
    """(JAX model, its raw init, the port's model with that init; JAX's Omega or inducing rows)."""
    from simplex_gp_tpu import DenseGP as JDenseGP
    from simplex_gp_tpu.models.sgpr import SGPR as JSGPR
    from simplex_gp_tpu.models.ski import SKIP as JSKIP

    kw = dict(num_dims=3, kernel="matern", nu=1.5, min_noise=0.1)
    if name == "skip":
        jm, tm = JSKIP(grid_size=40, rank=16, **kw), SKIP(grid_size=40, rank=16, omegas=jax_omegas(3, 16), **kw)
        raw = jm.init_params(lengthscale=1.2)
    elif name == "sgpr":
        jm, tm = JSGPR(num_inducing=24, **kw), SGPR(num_inducing=24, **kw)
        raw = jm.init_params(jnp.asarray(ds.train_x), seed=0, lengthscale=1.2)
    else:
        jm, tm = JDenseGP(**kw), DenseGP(**kw)
        raw = jm.init_params(lengthscale=1.2)
    return jm, raw, tm.load_raw({k: np.asarray(v) for k, v in raw.items()})


@pytest.mark.parametrize("name", ["skip", "sgpr", "exact"])
def test_run_training_matches_jax(tmp_path, monkeypatch, name):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla"))
    monkeypatch.syspath_prepend(str(ROOT / "experiments"))
    import common

    ds = _dataset()
    jm, raw, tm = _models(name, ds)
    with port_signs():
        _, jfinal = common.run_training(jm, raw, ds, _args(tmp_path / "jax"), name)
    del sys.modules["common"]
    summary = train.run_training(tm, ds, _args(tmp_path / "torch"), name)
    want, got = _lines(tmp_path / "jax" / f"{name}_toy_s0"), _lines(summary["out_dir"])
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert "val/rmse" in got[2] and "test/rmse" in got[3]
    for g, w in zip(got[1:3], want[1:3]):
        assert abs(g["train/mll"] - w["train/mll"]) <= LOSS_ATOL, (g["train/mll"], w["train/mll"])
    assert abs(summary["final"]["test/rmse"] - jfinal["test/rmse"]) <= RMSE_ATOL
    with open(pathlib.Path(summary["out_dir"]) / "model_final.pkl", "rb") as f:
        saved = pickle.load(f)
    assert sorted(saved) == sorted(raw)


@pytest.mark.parametrize("module,name,cls,extra", [
    (train_skip, "skip", "SKIP", ["--grid-size", "30", "--rank", "8"]),
    (train_sgpr, "sgpr", "SGPR", ["--num-inducing", "16"]),
    (train_exact, "exact", "DenseGP", []),
])
def test_entry_points_write_their_runs(tmp_path, module, name, cls, extra):
    summary = module.main(["--dataset", "snelson", "--device", "cpu", "--epochs", "2", "--log-int", "1",
                           "--ls-init", "median", "--out", str(tmp_path), *extra])
    run_dir = tmp_path / f"{name}_snelson_s0"
    assert summary["out_dir"] == str(run_dir)
    lines = _lines(run_dir)
    assert lines[0]["config"]["device"] == "cpu" and lines[0]["model"].startswith(cls + "(")
    losses = [-r["train/mll"] for r in summary["records"]]
    assert len(losses) == 2 and np.isfinite(losses).all() and np.isfinite(summary["final"]["test/rmse"])
    for f in ("model_best.pkl", "model_final.pkl", "checkpoint.pt"):
        assert (run_dir / f).exists()


def test_entry_points_take_the_jax_trainers_flags():
    a = train_skip.parse_args([])
    assert (a.kernel, a.nu, a.grid_size, a.rank, a.log_int, a.device) == ("rbf", 1.5, 100, 64, 5, "cuda")
    assert train_sgpr.parse_args([]).num_inducing == 512
    assert train_exact.parse_args(["--plan-capacity", "-1"]).plan_capacity == -1  # accepted, unused


def test_round5_checkpoints_load_through_convert():
    """JAX's runs/r5 SKIP and SGPR model_best.pkl load into the port and give JAX's NLML on 1,024 rows.

    SKIP's bound, 3e-3: its grid kernels' 30-odd smallest kept eigenvalues
    lie within float32 roundoff of each other, so two LAPACKs return other
    eigenvectors for them and the fixed Omega sketches another subspace
    (measured 1.1e-3 here); the sign convention alone moves JAX's own NLML
    at this checkpoint by 3.0e-3 (the golden file's ``native_skip_loss_best``).
    SGPR's, 1e-4: float32 Cholesky factors and solves in another order.
    """
    from simplex_gp_tpu.models.sgpr import SGPR as JSGPR
    from simplex_gp_tpu.models.ski import SKIP as JSKIP

    ds = load_dataset("precipitation", None, 1024)
    x, y = torch.from_numpy(ds.train_x), torch.from_numpy(ds.train_y)
    kw = dict(kernel="matern", nu=1.5, min_noise=0.1)
    raw = convert.load_jax_params(RUNS / "skip_precipitation_s0" / "model_best.pkl")
    skip = convert.skip_model_from_jax(raw, grid_size=100, rank=64, omegas=jax_omegas(3, 64), **kw)
    for k, v in raw.items():
        np.testing.assert_array_equal(getattr(skip, k).detach().numpy(), v.reshape(getattr(skip, k).shape))
    jskip = JSKIP(num_dims=3, grid_size=100, rank=64, **kw)
    with port_signs(), torch.no_grad():
        want = float(jax.jit(lambda r: jskip.nlml(r, jnp.asarray(ds.train_x), jnp.asarray(ds.train_y)))(raw))
        assert abs(float(skip.nlml(x, y)) - want) <= 3e-3

    sraw = convert.load_jax_params(RUNS / "sgpr_precipitation_s0" / "model_best.pkl")
    sgpr = convert.sgpr_model_from_jax(sraw, **kw)
    assert sgpr.inducing.shape == (512, 3) and sgpr.num_inducing == 512
    np.testing.assert_array_equal(sgpr.inducing.detach().numpy(), sraw["inducing"])
    want = float(JSGPR(num_dims=3, num_inducing=512, **kw).nlml(sraw, jnp.asarray(ds.train_x), jnp.asarray(ds.train_y)))
    with torch.no_grad():
        assert abs(float(sgpr.nlml(x, y)) - want) <= 1e-4
