"""ARD screening in the port (``SimplexGP.prune_thresh``), its trainer flag and ``eval_checkpoint``, on the CPU.

Held against the unchanged JAX package (models/exact_gp.py:237-280,
experiments/common.py:229-238, experiments/eval_checkpoint.py) with the same
numpy inputs:
  * ports of tests/test_screening.py's three tests, the port's screened
    cache held to the hand-subset model bit for bit (one process, the same
    generator; JAX's test takes rtol 1e-5);
  * the kept dims equal to JAX's on seeded raw vectors and on the round-5
    checkpoints, and one ulp either side of the threshold.  A dim within a
    few ulps of the threshold follows the last bits of the constrained
    float32 inverse lengthscales, and torch's CPU softplus and XLA's differ
    by 1-3 ulps for about 3% of raw values below 5 (none at or above 5 in a
    sweep of 10^5 values).  So the edge cases put the largest inverse
    lengthscale at raw lengthscales of 5 and above, and assert that both
    packages' inverse lengthscales are equal bit for bit there;
  * the screened cache and predict against JAX's at JAX's omega (n = 300,
    d = 6 -> 3, eval tolerance 1e-5: alpha rel 1e-4, mean and variance
    rtol 1e-4 / atol 1e-4, test_torch_chain_plan.py's serving bounds);
  * the trainer: at ``--prune-thresh 0`` its records and model files are bit
    for bit those of the plain calls it made before screening was ported;
    with screening, its record keys are JAX's and the test rows are served
    from the best epoch's screened cache;
  * ``eval_checkpoint``: JAX's keys and lines, the 1.4 capacity rule, and
    the serving gates (RMSE 0.01, NLL 0.05; the sketch's omega differs).
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
from torch_parity import rel_err

import simplex_gp_torch as T
import simplex_gp_tpu as J
from simplex_gp_torch import convert, eval_checkpoint, train
from simplex_gp_torch.linalg.mll import BBMMConfig
from simplex_gp_torch.models.components import constrain as t_constrain
from simplex_gp_torch.utils import data as t_data
from simplex_gp_tpu.models.components import constrain as j_constrain
from simplex_gp_tpu.utils.data import UCI_SHAPES, load_uci

ROOT = pathlib.Path(__file__).resolve().parents[1]
R5 = ROOT / "runs" / "r5"
SPARSE = ["--dataset", "elevators_sparse", "--kernel", "matern", "--min-noise", "0.1", "--device", "cpu"]


def _model(d, thresh, **kw):
    return T.SimplexGP(num_dims=d, kernel="rbf", order=1, min_noise=1e-4, prune_thresh=thresh,
                       bbmm=BBMMConfig(max_cg_iterations=100, max_lanczos_iterations=30, precond_rank=0,
                                       num_probes=4), **kw)


def _data(n=220, d=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (np.sin(x[:, 0] * 2.0) + 0.1 * rng.normal(size=n)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(y)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# ---- ports of tests/test_screening.py ---------------------------------------------------------------------


def test_screened_selection_and_equivalence_to_manual_subset():
    d = 5
    model = _model(d, thresh=0.1)
    with torch.no_grad():
        model.raw_lengthscale[3:] = 60.0  # dims 3, 4 irrelevant: a tiny inverse lengthscale
    sub, raw_sub, keep = model.screened()
    assert list(keep) == [0, 1, 2]
    assert sub.num_dims == 3 and sub.prune_thresh == 0.0 and sub is not model

    x, y = _data(d=d)
    cache = model.posterior_cache_screened(x, y, generator=_gen(0))
    xt = x[:32] + 0.05
    m1, v1 = model.predict_from_cache_screened(cache, x, xt)
    # The manual subset: the same sub-model driven by hand, with the same sketch draws.
    cache2 = sub.posterior_cache(x[:, :3], y, generator=_gen(0))
    m2, v2 = sub.predict_from_cache(cache2, x[:, :3], xt[:, :3])
    assert torch.equal(m1, m2) and torch.equal(v1, v2)
    assert cache["sub"] is not model and list(cache["keep"]) == [0, 1, 2]


def test_prune_thresh_zero_is_plain_path():
    d = 4
    model = _model(d, thresh=0.0)
    x, y = _data(d=d)
    sub, raw_sub, keep = model.screened()
    assert keep is None and sub is model
    cache = model.posterior_cache_screened(x, y, generator=_gen(1))
    assert cache["keep"] is None and cache["sub"] is model
    xt = x[:16]
    m1, v1 = model.predict_from_cache_screened(cache, x, xt)
    m2, v2 = model.predict_from_cache(model.posterior_cache(x, y, generator=_gen(1)), x, xt)
    assert torch.equal(m1, m2) and torch.equal(v1, v2)


def test_sparse_synthetic_variant_is_anisotropic():
    n, d = t_data.UCI_SHAPES["protein"]
    data = t_data.load_uci("protein_sparse")
    assert data.shape == (n, d + 1)
    np.testing.assert_array_equal(data, load_uci("protein_sparse"))  # the port's copy of the generator
    x, y = data[:, :-1], data[:, -1]
    c = np.abs([np.corrcoef(x[:, j], y)[0, 1] for j in range(d)])
    strong = (c > 5 * np.median(c)).sum()
    assert 1 <= strong <= 4, c
    assert not np.allclose(data[:, -1], t_data.load_uci("protein_clustered")[:, -1])


# ---- the screened model ---------------------------------------------------------------------------------


def test_screened_model_keeps_the_settings_and_copies_the_parameters():
    """kernel, taps, mixture weights, BBMM settings (the plan capacity) and eval tolerance carry over; the
    raw parameters are copies, with no autograd link to the parent."""
    bbmm = BBMMConfig(precond_rank=7, num_probes=3, plan_capacity=4096, max_lanczos_iterations=20)
    model = T.SimplexGP(num_dims=6, kernel="mixture", nu=2.5, order=2, min_noise=0.05, bbmm=bbmm,
                        eval_cg_tolerance=3e-3, mix_components=3, mix_weights=(0.2, 0.5, 0.3), prune_thresh=0.3)
    assert "prune_thresh=0.3" in repr(model)
    with torch.no_grad():
        model.raw_lengthscale.copy_(torch.tensor([0.5, 60.0, 1.0, 60.0, 60.0, 2.0]))
        model.raw_noise.fill_(-1.0)
    sub, raw_sub, keep = model.screened()
    assert list(keep) == [0, 2, 5] and sub.num_dims == 3
    for name in ("kernel", "nu", "order", "min_noise", "bbmm", "eval_cg_tolerance", "mix_components",
                 "mix_weights"):
        assert getattr(sub, name) == getattr(model, name), name
    assert sub.dk == model.dk and sub.prune_thresh == 0.0
    assert torch.equal(sub.raw_lengthscale.detach(), model.raw_lengthscale.detach()[[0, 2, 5]])
    for name in ("raw_outputscale", "raw_noise", "mean"):
        assert torch.equal(getattr(sub, name).detach(), getattr(model, name).detach()), name
    assert all(not v.requires_grad for v in raw_sub.values())
    for name, v in raw_sub.items():
        assert torch.equal(v, getattr(sub, name).detach()), name
    with torch.no_grad():
        model.raw_lengthscale.add_(1.0)
        model.raw_noise.add_(1.0)
    assert sub.raw_noise.item() == -1.0 and sub.raw_lengthscale[0].item() == 0.5


def _jax_keep(raw: dict, thresh: float):
    d = raw["raw_lengthscale"].shape[0]
    return J.SimplexGP(num_dims=d, prune_thresh=thresh).screened({k: jnp.asarray(v) for k, v in raw.items()})[2]


def _port_keep(raw: dict, thresh: float):
    d = raw["raw_lengthscale"].shape[0]
    return T.SimplexGP(num_dims=d, prune_thresh=thresh).load_raw(raw).screened()[2]


def _inv_ell_bits(raw: dict):
    """(JAX's, the port's) constrained float32 inverse lengthscales as int32 bit patterns."""
    j = np.asarray(j_constrain({k: jnp.asarray(v) for k, v in raw.items()}, 1e-4)["inv_ell"])
    t = t_constrain({k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in raw.items()}, 1e-4)["inv_ell"]
    return j.view(np.int32), t.numpy().view(np.int32)


def _raw(rl) -> dict:
    return {"raw_lengthscale": np.asarray(rl, np.float32), "raw_outputscale": np.float32(0.0),
            "raw_noise": np.float32(0.0), "mean": np.float32(0.0)}


def _same_keep(a, b):
    assert (a is None) == (b is None), (a, b)
    if a is not None:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("thresh", [0.1, 0.3, 0.5, 0.9])
def test_kept_dims_equal_jax_on_seeded_raw_vectors(thresh):
    rng = np.random.default_rng(17)
    cases = [_raw(rng.uniform(-1.0, 8.0, size=8)) for _ in range(40)]
    cases += [_raw(convert.load_jax_params(p)["raw_lengthscale"])
              for p in sorted(R5.glob("simplexgp_*/model_best.pkl"))]
    dropped = 0
    for raw in cases:
        jk, tk = _jax_keep(raw, thresh), _port_keep(raw, thresh)
        _same_keep(jk, tk)
        dropped += jk is not None
    assert dropped > 0


def test_softplus_bits_equal_jax_at_and_above_five():
    """The regime of the edge cases below: raw lengthscales of 5 and above (lengthscales >= 5)."""
    raw = np.random.default_rng(5).uniform(5.0, 80.0, size=100_000).astype(np.float32)
    jbits, tbits = _inv_ell_bits(_raw(raw))
    np.testing.assert_array_equal(jbits, tbits)


def _edge_raw(r_max: float, thresh: float, d: int = 6):
    """Raw lengthscales with dim 0 the largest inverse lengthscale and dims 1-4 at consecutive float32 raw
    values around the one whose inverse lengthscale (JAX's) crosses ``thresh`` times the largest: two kept,
    two dropped, each within about one ulp of the threshold; dim 5 far below it."""
    base = np.full(d, np.float32(r_max), np.float32)
    base[5] = 1000.0
    inv_max = np.asarray(j_constrain({"raw_lengthscale": jnp.asarray(base[:1]), "raw_outputscale": 0.0,
                                      "raw_noise": 0.0, "mean": 0.0}, 1e-4)["inv_ell"])
    t = thresh * inv_max.max()

    def inv(r):
        return np.asarray(j_constrain({"raw_lengthscale": jnp.asarray(np.asarray([r], np.float32)),
                                       "raw_outputscale": 0.0, "raw_noise": 0.0, "mean": 0.0}, 1e-4)["inv_ell"])[0]

    # Bisect over float32 bit patterns (positive floats order as their bits) for the last raw value kept.
    lo, hi = np.float32(r_max).view(np.int32), np.float32(r_max / thresh * 4).view(np.int32)
    assert inv(lo.view(np.float32)) >= t > inv(hi.view(np.float32))
    while hi - lo > 1:
        mid = np.int32((int(lo) + int(hi)) // 2)
        if inv(mid.view(np.float32)) >= t:
            lo = mid
        else:
            hi = mid
    base[1:5] = np.arange(int(lo) - 1, int(lo) + 3, dtype=np.int32).view(np.float32)
    return base


@pytest.mark.parametrize("thresh", [0.1, 0.3, 0.5])
@pytest.mark.parametrize("r_max", [5.0, 6.5, 9.0])
def test_kept_dims_equal_jax_one_ulp_either_side_of_the_threshold(r_max, thresh):
    raw = _raw(_edge_raw(r_max, thresh))
    jbits, tbits = _inv_ell_bits(raw)
    np.testing.assert_array_equal(jbits, tbits)
    jk, tk = _jax_keep(raw, thresh), _port_keep(raw, thresh)
    _same_keep(jk, tk)
    assert list(jk) == [0, 1, 2]  # the edge crossed between dims 2 and 3


def test_screened_cache_and_predict_match_jax():
    """posterior_cache_screened / predict_from_cache_screened against JAX's, JAX's omega fed in."""
    rng = np.random.default_rng(21)
    n, d = 300, 6
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (np.sin(2 * x[:, 0]) + 0.5 * x[:, 2] + 0.3 * rng.normal(size=n)).astype(np.float32)
    xt = rng.normal(size=(64, d)).astype(np.float32)
    kw = dict(num_dims=d, kernel="matern", nu=1.5, order=1, min_noise=0.1, prune_thresh=0.3, eval_cg_tolerance=1e-5)
    rl = np.array([0.7, 60.0, 1.2, 60.0, 2.0, 60.0], np.float32)
    raw = {k: np.asarray(v) for k, v in J.SimplexGP(**kw).init_params().items()}
    raw["raw_lengthscale"] = np.log(np.expm1(rl)).astype(np.float32)
    raw["raw_noise"] = np.float32(-2.0)
    jm = J.SimplexGP(**kw)
    key = jax.random.PRNGKey(0)
    jraw = {k: jnp.asarray(v) for k, v in raw.items()}
    jc = jm.posterior_cache_screened(jraw, jnp.asarray(x), jnp.asarray(y), key)
    jmean, jvar = map(np.asarray, jm.predict_from_cache_screened(jc, jnp.asarray(x), jnp.asarray(xt)))
    omega = np.array(jax.random.normal(key, (n, min(jm.bbmm.max_lanczos_iterations, n)), jnp.float32))

    tm = T.SimplexGP(**kw).load_raw(raw)
    tc = tm.posterior_cache_screened(torch.from_numpy(x), torch.from_numpy(y), omega=torch.from_numpy(omega))
    np.testing.assert_array_equal(tc["keep"], jc["keep"])
    assert list(tc["keep"]) == [0, 2, 4] and tc["sub"].num_dims == jc["sub"].num_dims == 3
    tmean, tvar = tm.predict_from_cache_screened(tc, torch.from_numpy(x), torch.from_numpy(xt))
    assert rel_err(tc["alpha"].numpy(), np.asarray(jc["alpha"])) < 1e-4
    np.testing.assert_allclose(tmean.numpy(), jmean, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tvar.numpy(), jvar, rtol=1e-4, atol=1e-4)


# ---- the trainer ------------------------------------------------------------------------------------------


def _lines(run_dir):
    return [json.loads(line) for line in (pathlib.Path(run_dir) / "metrics.jsonl").read_text().splitlines()]


def _untimed(lines):
    return [{k: v for k, v in r.items() if not k.endswith("_ts") and k != "config"} for r in lines]


def test_trainer_at_prune_thresh_zero_is_bit_for_bit_the_plain_path(tmp_path, monkeypatch):
    flags = [*SPARSE, "--max-n", "200", "--epochs", "2", "--log-int", "1", "--ls-init", "median",
             "--prune-thresh", "0"]
    screened = train.main([*flags, "--out", str(tmp_path / "screened")])
    # The calls the trainer made before screening was ported.
    monkeypatch.setattr(T.SimplexGP, "posterior_cache_screened",
                        lambda self, x, y, generator=None: dict(self.posterior_cache(x, y, generator=generator),
                                                                keep=None))
    monkeypatch.setattr(T.SimplexGP, "predict_from_cache_screened",
                        lambda self, cache, x, x_test: self.predict_from_cache(cache, x, x_test))
    plain = train.main([*flags, "--out", str(tmp_path / "plain")])
    assert _untimed(_lines(screened["out_dir"])) == _untimed(_lines(plain["out_dir"]))
    for name in ("model_best.pkl", "model_final.pkl"):
        a, b = (pathlib.Path(s["out_dir"]) / name for s in (screened, plain))
        assert a.read_bytes() == b.read_bytes(), name


def test_trainer_with_prune_thresh_keys_equal_run_training_and_serves_the_screened_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla"))
    monkeypatch.syspath_prepend(str(ROOT / "experiments"))
    import common

    args = argparse.Namespace(dataset="elevators_sparse", data_dir=None, epochs=2, lr=0.1, seed=0, log_int=2,
                              patience=20, min_noise=0.1, out=str(tmp_path / "jax"), max_n=300, ls_init="median",
                              plan_capacity=0, no_eval=False, host_loop=False, resume=False)
    ds = common.load_dataset(args)
    jm = J.SimplexGP(num_dims=18, kernel="matern", nu=1.5, min_noise=0.1, prune_thresh=0.95)
    common.run_training(jm, jm.init_params(**common.init_kwargs(args, ds)), ds, args, "simplexgp")
    want = _lines(tmp_path / "jax" / "simplexgp_elevators_sparse_s0")
    del sys.modules["common"]

    served = []
    real = T.SimplexGP.predict_from_cache_screened

    def spy(self, cache, x, x_test):
        served.append((cache, x_test.shape[0]))
        return real(self, cache, x, x_test)

    monkeypatch.setattr(T.SimplexGP, "predict_from_cache_screened", spy)
    summary = train.main([*SPARSE, "--max-n", "300", "--epochs", "2", "--log-int", "2", "--ls-init", "median",
                          "--prune-thresh", "0.95", "--out", str(tmp_path / "torch")])
    got = _lines(summary["out_dir"])
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert got[0]["config"]["prune_thresh"] == 0.95 and "prune_thresh=0.95" in got[0]["model"]
    (val_cache, n_val), (test_cache, n_test) = served
    assert (n_val, n_test) == (ds.val_x.shape[0], ds.test_x.shape[0])
    assert test_cache is val_cache and test_cache["keep"] is not None  # the best epoch's screened cache, reused
    assert test_cache["sub"].num_dims == len(test_cache["keep"]) < 18
    assert summary["records"][-1]["val/screened_dims"] == len(test_cache["keep"])
    assert np.isfinite(summary["final"]["test/rmse"]) and summary["final"]["test/rmse"] < 1.0


# ---- eval_checkpoint --------------------------------------------------------------------------------------


def test_capacity_headroom_rules():
    assert eval_checkpoint.EVAL_HEADROOM == 1.4
    assert train.trim_capacity(6000, 10**6, 10) == 8192  # the trainer's 1.25
    assert train.trim_capacity(6000, 10**6, 10, eval_checkpoint.EVAL_HEADROOM) == 16384
    assert train.trim_capacity(6000, 1000, 10, eval_checkpoint.EVAL_HEADROOM) == 11000  # at most n(d+1)


def test_eval_checkpoint_matches_jax_script(tmp_path, monkeypatch, capsys):
    """Both scripts on one raw pickle: four dims at lengthscale 2, fourteen at raw 60; screening at 0.3 keeps
    the four.  The occupancy count is replaced by 6,000 in both, so that the 1.4 rule (16,384 rows at 1,000
    training rows) and the trainer's 1.25 (8,192) part."""
    n_max, d = 1000, UCI_SHAPES["elevators"][1]
    rl = np.full(d, 60.0, np.float32)
    rl[[2, 9, 10, 12]] = np.log(np.expm1(np.float32(2.0)))
    raw = {"raw_lengthscale": rl, "raw_outputscale": np.float32(0.0), "raw_noise": np.float32(-1.0),
           "mean": np.float32(0.0)}
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    with open(run_dir / "model_final.pkl", "wb") as f:
        pickle.dump(raw, f)
    flags = ["--run-dir", str(run_dir), "--dataset", "elevators_sparse", "--max-n", str(n_max), "--kernel",
             "matern", "--min-noise", "0.1", "--plan-capacity", "-1", "--prune-thresh", "0.3"]

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla"))
    monkeypatch.syspath_prepend(str(ROOT / "experiments"))
    import simplex_gp_tpu.ops.lattice as j_lattice

    monkeypatch.setattr(j_lattice, "count_lattice_points", lambda *a, **k: 6000)
    import eval_checkpoint as j_eval

    monkeypatch.setattr(sys, "argv", ["eval_checkpoint.py", *flags])
    j_eval.main()
    jax_lines = capsys.readouterr().out.strip().splitlines()
    del sys.modules["common"], sys.modules["eval_checkpoint"]
    want = json.loads(jax_lines[-1])

    monkeypatch.setattr(eval_checkpoint, "count_lattice_points", lambda *a, **k: 6000)
    got = eval_checkpoint.main([*flags, "--device", "cpu"])
    lines = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]
    assert lines[0] == {"plan_capacity": 16384, "occupancy": 6000, "worst_case": n_max * (d + 1)}
    assert jax_lines[0] == "plan capacity: occupancy 6000 -> 16384"
    assert lines[1] == json.loads(jax_lines[1]) == {"screened_dims": 4, "of": d}
    assert lines[2] == {"screened_occupancy": 6000, "plan_capacity": min(16384, n_max * 5)}
    # JAX's record has the eval CG's residual and count where its cache records them (the host loop's cache,
    # exact_gp.py:227-233); the port's cache always does.
    assert lines[-1] == got and sorted(got) == sorted([*want, "cache_cg_res", "cache_cg_iters"])
    assert [json.loads(s) for s in (run_dir / "eval.jsonl").read_text().splitlines()] == [want, got]
    assert got["which"] == want["which"] == "model_final.pkl" and got["root_rank"] is want["root_rank"] is None
    for split in ("val", "test"):
        assert abs(got[f"{split}/rmse"] - want[f"{split}/rmse"]) <= 0.01
        assert abs(got[f"{split}/nll"] - want[f"{split}/nll"]) <= 0.05
