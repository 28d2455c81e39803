"""The trainer loop of ``python -m simplex_gp_torch.train`` on the CPU, on Snelson.

Its files against experiments/common.py::run_training's (the JAX trainer,
run here on the CPU for two epochs): the same metrics.jsonl record keys.
Then the loop's own rules: early stopping after patience + 1 evaluations
without a better validation RMSE, model_best.pkl at the best one,
``--resume``, which on the CPU (deterministic) reproduces an uninterrupted
run exactly, and ``--kernel mixture``.
"""

import argparse
import json
import pathlib
import pickle
import sys

import numpy as np
import pytest
import torch  # noqa: F401
import torch_parity  # noqa: F401 (one intra-op thread per worker)

from simplex_gp_torch import convert, train

ROOT = pathlib.Path(__file__).resolve().parents[1]
BASE = ["--dataset", "snelson", "--device", "cpu", "--lr", "0.1"]


def _run(out, *args):
    return train.main([*BASE, "--out", str(out), *args])


def _lines(run_dir):
    return [json.loads(line) for line in (pathlib.Path(run_dir) / "metrics.jsonl").read_text().splitlines()]


def _params(path):
    return convert.load_jax_params(path)


def _same_params(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_metrics_keys_equal_run_training(tmp_path, monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla"))
    monkeypatch.syspath_prepend(str(ROOT / "experiments"))
    import common

    from simplex_gp_tpu import SimplexGP

    args = argparse.Namespace(dataset="snelson", data_dir=None, epochs=2, lr=0.1, seed=0, log_int=2, patience=20,
                              min_noise=1e-4, out=str(tmp_path / "jax"), max_n=0, ls_init="default",
                              plan_capacity=0, no_eval=False, host_loop=False, resume=False)
    model = SimplexGP(num_dims=1)
    common.run_training(model, model.init_params(), common.load_dataset(args), args, "simplexgp")
    want = _lines(tmp_path / "jax" / "simplexgp_snelson_s0")
    got = _lines(_run(tmp_path / "torch", "--epochs", "2", "--log-int", "2")["out_dir"])
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert sorted(got[0]) == ["config", "model"]
    assert "val/rmse" in got[2] and "val/rmse" not in got[1] and "test/rmse" in got[3]
    del sys.modules["common"]


def _scripted_val_rmse(monkeypatch, scores):
    """Replace the validation RMSE by ``scores`` in turn (the test rows keep their real metrics)."""
    real = train.regression_metrics
    it = iter(scores)

    def fake(mean, var, y):
        out = real(mean, var, y)
        if y.shape[0] == 32:  # Snelson's validation rows (the test rows are 40)
            out["rmse"] = next(it)
        return out

    monkeypatch.setattr(train, "regression_metrics", fake)


def test_early_stop_after_patience_plus_one_and_model_best_at_the_best(tmp_path, monkeypatch):
    _scripted_val_rmse(monkeypatch, [0.9, 0.5, 0.7, 0.8, 0.1, 0.1])
    summary = _run(tmp_path / "long", "--epochs", "10", "--log-int", "1", "--patience", "1")
    lines = _lines(summary["out_dir"])
    epochs = [r["epoch"] for r in lines if "epoch" in r]
    assert epochs == [0, 1, 2, 3] and summary["early_stop"] == 3
    assert {"early_stop": 3} in lines and "test/rmse" in lines[-1]
    # The same run cut after the best epoch (1) ends with the parameters model_best holds.
    _scripted_val_rmse(monkeypatch, [0.9, 0.5])
    short = _run(tmp_path / "short", "--epochs", "2", "--log-int", "1", "--patience", "1")
    best = _params(pathlib.Path(summary["out_dir"]) / "model_best.pkl")
    _same_params(best, _params(pathlib.Path(short["out_dir"]) / "model_final.pkl"))
    _same_params(best, _params(pathlib.Path(summary["out_dir"]) / "model_final.pkl"))


def test_resume_reproduces_an_uninterrupted_run(tmp_path):
    straight = _run(tmp_path / "straight", "--epochs", "4", "--log-int", "2", "--plan-capacity", "-1")
    _run(tmp_path / "cut", "--epochs", "2", "--log-int", "2", "--plan-capacity", "-1")
    resumed = _run(tmp_path / "cut", "--epochs", "4", "--log-int", "2", "--plan-capacity", "-1", "--resume")

    def epoch_records(run_dir):
        return [{k: v for k, v in r.items() if not k.endswith("_ts")} for r in _lines(run_dir) if "epoch" in r]

    assert [r["epoch"] for r in epoch_records(resumed["out_dir"])] == [0, 1, 2, 3]
    assert epoch_records(resumed["out_dir"]) == epoch_records(straight["out_dir"])
    for name in ("model_best.pkl", "model_final.pkl"):
        _same_params(_params(pathlib.Path(resumed["out_dir"]) / name),
                     _params(pathlib.Path(straight["out_dir"]) / name))
    ck = [torch.load(pathlib.Path(s["out_dir"]) / "checkpoint.pt", weights_only=True) for s in (resumed, straight)]
    assert ck[0]["epoch"] == ck[1]["epoch"] == 3
    _same_params(*(c["raw"] for c in ck))
    assert torch.equal(ck[0]["generator"], ck[1]["generator"])


def test_model_files_load_as_jax_parameter_files(tmp_path):
    summary = _run(tmp_path, "--epochs", "1", "--no-eval")
    run_dir = pathlib.Path(summary["out_dir"])
    assert summary["final"] == {} and not (run_dir / "model_best.pkl").exists()
    with open(run_dir / "model_final.pkl", "rb") as f:
        raw = pickle.load(f)
    assert sorted(raw) == ["mean", "raw_lengthscale", "raw_noise", "raw_outputscale"]
    assert all(isinstance(v, np.ndarray) and v.dtype == np.float32 for v in raw.values())


def test_mixture_kernel_trains_two_epochs(tmp_path):
    """``--kernel mixture``: weights subset-fit at the initial lengthscales, on the config line, two epochs.

    The records carry the rbf run's keys; the weights are the port's own fit
    at the initial lengthscales (the same call on a fresh model gives them
    again), and an autotrimmed capacity is counted with the Matern taps and
    left unused by the mixture plans.
    """
    from simplex_gp_torch.models.exact_gp import SimplexGP
    from simplex_gp_torch.utils.data import load_dataset

    summary = _run(tmp_path / "mix", "--kernel", "mixture", "--mix-components", "6", "--epochs", "2",
                   "--log-int", "2", "--plan-capacity", "-1")
    lines = _lines(summary["out_dir"])
    rbf = _lines(_run(tmp_path / "rbf", "--epochs", "2", "--log-int", "2")["out_dir"])
    assert [sorted(r) for r in lines] == [sorted(r) for r in rbf]
    assert lines[0]["config"]["kernel"] == "mixture" and lines[0]["config"]["mix_components"] == 6
    ds = load_dataset("snelson")
    fresh = SimplexGP(num_dims=1, kernel="mixture", mix_components=6).with_fitted_mixture(
        torch.from_numpy(ds.train_x))
    assert f"mix_weights={fresh.mix_weights}" in lines[0]["model"]
    assert all(w >= 0 for w in fresh.mix_weights) and len(fresh.mix_weights) == 6
    assert summary["plan_capacity"] is not None  # counted, as JAX's trainer counts it, then ignored
    losses = [-r["train/mll"] for r in summary["records"]]
    assert all(np.isfinite(losses)) and summary["final"]["test/rmse"] < 1.0


def test_plan_capacity_flag_refuses_other_negatives():
    with pytest.raises(SystemExit):
        train.parse_args(["--plan-capacity", "-2"])
