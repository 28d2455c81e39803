"""The port's entry points ``quality_gap``, ``asymptotics`` and ``sweep`` on the CPU, against the JAX scripts.

  * ``quality_gap``: both scripts at the same fixed parameters (each one's
    ``train`` replaced by a function returning them): the same records in
    the same order with the same keys and combos, ``d_eff`` equal to JAX's,
    the dense combos within rel 1e-4 of JAX's (float32 Cholesky in another
    order), the lattice combos within the serving gates (RMSE 0.01, NLL 0.05:
    the eval CG at 1e-2 and another sketch omega), and the discretization
    record's dense NLML within 1e-4 and MVM error within 1e-3; then the
    port's own training loop for a few steps.
  * ``asymptotics``: JAX's keys, on small sizes.
  * ``sweep``: every config's program maps to a port module but
    ``experiments/backend_diff.py``, which is an error that names it; the
    config reader and the grid equal experiments/sweep.py's; ``--dry-run``
    prints ``-m simplex_gp_torch.<module>`` commands; one real run of a
    small grid records its summaries.
  * the new entry points default to the card, and no module of the port
    (nor chip_smoke.py) imports jax, the JAX package or experiments/.
"""

import ast
import importlib
import json
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplex_gp_torch import asymptotics, quality_gap, sweep

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "configs").glob("*.yml"))
RELEVANT = [2, 9, 10, 12]  # elevators_sparse's relevant dims (the generator's draws)


def _jax_script(monkeypatch, tmp_path, name):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla"))
    monkeypatch.syspath_prepend(str(ROOT / "experiments"))
    module = __import__(name)
    return module


def _forget(*names):
    for name in names:
        sys.modules.pop(name, None)


def _fixed_raw(d: int, ell: float, noise_raw: float) -> dict:
    rl = np.full(d, 60.0, np.float32)
    rl[RELEVANT] = np.log(np.expm1(np.float32(ell)))
    return {"raw_lengthscale": rl, "raw_outputscale": np.float32(0.3), "raw_noise": np.float32(noise_raw),
            "mean": np.float32(0.05)}


def test_quality_gap_records_match_jax_at_fixed_parameters(tmp_path, monkeypatch, capsys):
    d = 18
    fixed = {"dense": _fixed_raw(d, 1.5, -1.0), "simplex": _fixed_raw(d, 2.0, -0.5)}
    flags = ["--dataset", "elevators_sparse", "--max-n", "256", "--epochs", "2", "--kernel", "matern",
             "--min-noise", "0.1", "--prune-thresh", "0.3"]

    j_qg = _jax_script(monkeypatch, tmp_path, "quality_gap")
    monkeypatch.setattr(j_qg, "train", lambda model, raw, x, y, epochs, lr, seed, label: (
        {k: jnp.asarray(v) for k, v in fixed[label].items()}, [-1.0, -0.9]))
    monkeypatch.setattr(sys, "argv", ["quality_gap.py", *flags, "--out", str(tmp_path / "jax")])
    j_qg.main()
    capsys.readouterr()
    _forget("quality_gap", "common")
    want = [json.loads(s) for s in (tmp_path / "jax" / "quality_gap_elevators_sparse.jsonl").read_text().splitlines()]

    def fixed_train(model, x, y, epochs, lr, seed, label):
        model.load_raw(fixed[label])
        return quality_gap._raw(model), [-1.0, -0.9]

    monkeypatch.setattr(quality_gap, "train", fixed_train)
    got = quality_gap.main([*flags, "--out", str(tmp_path / "torch"), "--device", "cpu"])
    assert got == [json.loads(s) for s in (tmp_path / "torch" / "quality_gap_elevators_sparse.jsonl").read_text()
                   .splitlines()]
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert [r.get("combo", r.get("phase")) for r in got] == [r.get("combo", r.get("phase")) for r in want]
    assert got[0] == want[0]
    by_name = {r["combo"]: (r, w) for r, w in zip(got, want) if "combo" in r}
    for label in ("dense_params", "simplex_params"):
        r, w = by_name[f"{label}/pruned_lattice_inf"]
        assert r["d_eff"] == w["d_eff"] == 4 and r["prune_thresh"] == w["prune_thresh"] == 0.3
    for name, (r, w) in by_name.items():
        for split in ("val", "test"):
            if name.endswith("dense_inf"):
                for k in ("rmse", "mae", "nll"):
                    assert r[f"{split}/{k}"] == pytest.approx(w[f"{split}/{k}"], rel=1e-4), (name, split, k)
            else:
                assert abs(r[f"{split}/rmse"] - w[f"{split}/rmse"]) <= 0.01, (name, split)
                assert abs(r[f"{split}/nll"] - w[f"{split}/nll"]) <= 0.05, (name, split)
    for r, w in zip(got[-2:], want[-2:]):
        assert r["nlml_dense"] == pytest.approx(w["nlml_dense"], rel=1e-4)
        assert abs(r["mvm_rel_err"] - w["mvm_rel_err"]) <= 1e-3 and abs(r["mvm_cos"] - w["mvm_cos"]) <= 1e-3
        assert r["mean_lengthscale"] == pytest.approx(w["mean_lengthscale"], rel=1e-6)
        assert r["noise"] == pytest.approx(w["noise"], rel=1e-6)


def test_quality_gap_trains_both_models(tmp_path):
    records = quality_gap.main(["--dataset", "elevators_sparse", "--max-n", "128", "--epochs", "3", "--kernel",
                                "matern", "--min-noise", "0.1", "--ls-init", "median", "--device", "cpu",
                                "--out", str(tmp_path), "--tag", "_t"])
    assert (tmp_path / "quality_gap_elevators_sparse_t.jsonl").exists()
    combos = [r["combo"] for r in records if "combo" in r]
    assert combos == ["dense_params/dense_inf", "dense_params/lattice_inf", "simplex_params/lattice_inf",
                      "simplex_params/dense_inf"]  # no pruned combos at --prune-thresh 0
    assert all(np.isfinite(v) for r in records for v in r.values() if isinstance(v, float))


def test_asymptotics_keys_match_jax(tmp_path, monkeypatch, capsys):
    flags = ["--ns", "300", "600", "--ds", "2", "3", "--fixed-n", "300", "--fixed-d", "2", "--reps", "1"]
    j_as = _jax_script(monkeypatch, tmp_path, "asymptotics")
    monkeypatch.setattr(sys, "argv", ["asymptotics.py", *flags])
    j_as.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    _forget("asymptotics")
    got = asymptotics.main([*flags, "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    assert list(got) == list(want)
    assert got["ns"] == want["ns"] and got["ds"] == want["ds"] and got["order"] == want["order"]
    assert all(t > 0 for t in got["t_n_ms"] + got["t_d_ms"]) and np.isfinite(got["exponent_n"])


def test_sweep_maps_every_config_program_to_a_port_module():
    for path in CONFIGS:
        program = sweep.load_config(path)["program"]
        if program == "experiments/backend_diff.py":
            with pytest.raises(ValueError, match="experiments/backend_diff.py"):
                sweep.module_for(program)
        else:
            module = sweep.module_for(program)
            assert module.startswith("simplex_gp_torch.")
            assert (ROOT / (module.replace(".", "/") + ".py")).exists(), module
    with pytest.raises(ValueError, match="experiments/backend_diff.py"):
        sweep.main([str(ROOT / "configs" / "backend_diff.yml"), "--dry-run"])


def test_sweep_reader_and_grid_equal_jax(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "experiments"))
    import sweep as j_sweep

    try:
        for path in CONFIGS:
            cfg = sweep.load_config(path)
            assert cfg == j_sweep.load_config(str(path)), path
            assert list(sweep.grid_points(cfg["parameters"])) == list(j_sweep.grid_points(cfg["parameters"]))
    finally:
        _forget("sweep")


def test_sweep_dry_run_prints_module_commands(tmp_path, capsys):
    commands = sweep.main([str(ROOT / "configs" / "simplexgp.yml"), "--dry-run", "--limit", "2", "--epochs", "1",
                           "--out", str(tmp_path / "s")])
    out = capsys.readouterr().out.splitlines()
    assert len(commands) == 2 and not (tmp_path / "s").exists()
    for line, cmd in zip(out[1:], commands):
        assert cmd[:3] == [sys.executable, "-m", "simplex_gp_torch.train"]
        assert cmd[3:7] == ["--dataset", "elevators", "--kernel", "matern"] and cmd[-2:] == ["--epochs", "1"]
        assert line.endswith(" ".join(cmd)) and " -m simplex_gp_torch.train " in line
    assert [cmd[cmd.index("--seed") + 1] for cmd in commands] == ["0", "1"]


def test_sweep_runs_a_grid_and_records_summaries(tmp_path):
    cfg = tmp_path / "mvm_small.yml"
    cfg.write_text("program: experiments/mvm_err.py\nmethod: grid\nparameters:\n  dataset:\n    value: snelson\n"
                   "  order:\n    values: [1, 2]\n")
    sweep.main([str(cfg), "--out", str(tmp_path / "out"), "--device", "cpu", "--iters", "1"])
    recs = [json.loads(s) for s in (tmp_path / "out" / "sweep_results.jsonl").read_text().splitlines()]
    assert [r["point"] for r in recs] == [{"dataset": "snelson", "order": 1}, {"dataset": "snelson", "order": 2}]
    assert all(r["returncode"] == 0 for r in recs), recs
    assert [r["summary"]["order"] for r in recs] == [1, 2] and all(r["summary"]["cos_err"] > 0.9 for r in recs)


@pytest.mark.parametrize("module", ["eval_checkpoint", "quality_gap", "asymptotics"])
def test_new_entry_points_default_to_the_card(module):
    """--device defaults to cuda, which raises without a card: no CPU fallback."""
    mod = importlib.import_module(f"simplex_gp_torch.{module}")
    argv = ["--run-dir", "unused"] if module == "eval_checkpoint" else []
    assert mod.parse_args(argv).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cuda"):
            mod.main(argv)


def test_port_and_chip_smoke_import_nothing_of_jax_or_the_experiments():
    """No import statement of the port's modules or chip_smoke.py names jax, the JAX package or experiments/
    (its scripts import as top-level modules: common, sweep, ...)."""
    banned = {"jax", "jaxlib", "simplex_gp_tpu", "experiments", "optax"}
    banned |= {p.stem for p in (ROOT / "experiments").glob("*.py")}
    files = sorted((ROOT / "simplex_gp_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path.relative_to(ROOT)} imports {name}"
