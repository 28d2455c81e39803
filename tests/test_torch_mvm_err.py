"""``python -m simplex_gp_torch.mvm_err`` on the CPU against experiments/mvm_err.py's measurement.

``--kernel mixture`` is held to the JAX script's mixture branch (each side
fits its own weights) within 1e-3.

The port prints the keys of the JAX script's JSON line; its rel_err and
cos_err are held, within 1e-4, to the same formulas (mvm_err.py:109-113)
evaluated on JAX's filter_once and kernel_value_jnp over the same rows.  The
one-shot filters agree to rel 2e-5 (the chain-vs-join bound); the dense
products differ in f32 summation order and in the squared distances' form
(the port's matmul form against JAX's difference form), well inside 1e-4.
"""

import json
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplex_gp_torch import mvm_err
from simplex_gp_torch.ops import kernels as t_kernels
from simplex_gp_torch.ops import lattice as t_lattice
from simplex_gp_torch.utils.data import load_dataset
from simplex_gp_tpu.ops import kernels as j_kernels
from simplex_gp_tpu.ops import lattice as j_lattice

ROOT = pathlib.Path(__file__).resolve().parents[1]
KEYS = ["dataset", "n", "d", "order", "kernel", "nu", "rel_err", "cos_err", "ts/lattice", "ts/exact_subset",
        "exact_subset_n"]


def _jax_errors(dataset, kind, order, nu, max_exact):
    """experiments/mvm_err.py:78-113 on JAX (CPU), for the port's dataset rows."""
    ds = load_dataset(dataset)
    x_all = np.concatenate([ds.train_x, ds.val_x, ds.test_x], axis=0)
    y_all = np.concatenate([ds.train_y, ds.val_y, ds.test_y], axis=0)
    dk = j_kernels.rbf_kernel(order) if kind == "rbf" else j_kernels.matern_kernel(nu, order)
    ns = min(max_exact, x_all.shape[0])
    xs, vs = x_all[:ns], y_all[:ns, None]
    lat = np.asarray(j_lattice.filter_once(jnp.asarray(vs), jnp.asarray(xs), dk.coeffs, dk.variance))
    xj = jnp.asarray(xs)
    d2 = ((xj[:, None, :] - xj[None, :, :]) ** 2).sum(-1)
    exact = np.asarray(j_kernels.kernel_value_jnp(dk, d2) @ jnp.asarray(vs))
    scale = (lat * exact).sum() / (lat * lat).sum()
    rel = float(np.linalg.norm(scale * lat - exact) / np.linalg.norm(exact))
    cos = float((lat * exact).sum() / (np.linalg.norm(lat) * np.linalg.norm(exact)))
    return rel, cos, ns


def test_cli_prints_the_jax_scripts_keys():
    out = subprocess.run([sys.executable, "-m", "simplex_gp_torch.mvm_err", "--dataset", "snelson", "--device",
                          "cpu", "--iters", "2"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert list(rec) == KEYS
    assert rec["n"] == 200 and rec["d"] == 1 and rec["exact_subset_n"] == 200 and rec["nu"] is None
    assert rec["ts/lattice"] > 0 and rec["ts/exact_subset"] > 0


@pytest.mark.parametrize("kind,order,nu,max_exact", [("rbf", 1, 1.5, 20000), ("rbf", 2, 1.5, 120),
                                                     ("matern", 1, 1.5, 20000), ("matern", 2, 2.5, 150)])
def test_errors_match_jax(capsys, kind, order, nu, max_exact):
    rec = mvm_err.main(["--dataset", "snelson", "--kernel", kind, "--order", str(order), "--nu", str(nu),
                        "--max-exact", str(max_exact), "--iters", "1", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == rec
    rel, cos, ns = _jax_errors("snelson", kind, order, nu, max_exact)
    assert rec["exact_subset_n"] == ns
    assert rec["nu"] == (nu if kind == "matern" else None)
    assert abs(rec["rel_err"] - rel) <= 1e-4, (rec["rel_err"], rel)
    assert abs(rec["cos_err"] - cos) <= 1e-4, (rec["cos_err"], cos)


def test_trim_capacity_follows_the_jax_rule(monkeypatch):
    """Occupancy x 1.05 rounded up to 8192, used only below 0.9 n(d+1) (mvm_err.py:69-74)."""
    rng = np.random.default_rng(0)
    base = rng.normal(size=(40, 3)).astype(np.float32)
    x = base[rng.integers(0, 40, size=20000)] + 0.01 * rng.normal(size=(20000, 3)).astype(np.float32)
    dk = t_kernels.rbf_kernel(1)
    xt = torch.from_numpy(x)
    assert mvm_err.trim_capacity(xt, dk) is None  # 80,000 rows: under the 2^20 threshold
    occ = int(j_lattice.count_lattice_points(jnp.asarray(x), dk.variance, dk.coeffs))
    want = -(-int(occ * 1.05) // 8192) * 8192
    assert want < 0.9 * 80000
    monkeypatch.setattr(mvm_err, "TRIM_ROWS", 1000)  # trim at this small size
    cap = mvm_err.trim_capacity(xt, dk)
    assert cap == want
    v = torch.from_numpy(rng.normal(size=(20000, 1)).astype(np.float32))
    trimmed = t_lattice.filter_once(v, xt, dk.coeffs, dk.variance, cap)
    torch.testing.assert_close(trimmed, t_lattice.filter_once(v, xt, dk.coeffs, dk.variance), rtol=0, atol=0)
    # A capacity that would not trim below 0.9 n(d+1) is not used.
    spread = torch.from_numpy(rng.normal(size=(300, 3)).astype(np.float32))
    assert mvm_err.trim_capacity(spread, dk) is None  # 1,200 rows, over the patched threshold


def test_dense_mvm_matches_jax_kernel_value():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(90, 4)).astype(np.float32)
    v = rng.normal(size=(90, 2)).astype(np.float32)
    for tdk, jdk in ((t_kernels.rbf_kernel(1), j_kernels.rbf_kernel(1)),
                     (t_kernels.matern_kernel(2.5, 1), j_kernels.matern_kernel(2.5, 1))):
        xj = jnp.asarray(x)
        want = np.asarray(j_kernels.kernel_value_jnp(jdk, ((xj[:, None] - xj[None]) ** 2).sum(-1)) @ jnp.asarray(v))
        got = mvm_err.dense_mvm(torch.from_numpy(x), torch.from_numpy(v), tdk).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _jax_mixture_errors(dataset, order, nu, max_exact):
    """experiments/mvm_err.py:53-58, 81-113 for --kernel mixture on JAX (CPU): the subset refit, then the errors."""
    from simplex_gp_tpu.ops.filter import lattice_filter_any

    ds = load_dataset(dataset)
    x_all = np.concatenate([ds.train_x, ds.val_x, ds.test_x], axis=0)
    y_all = np.concatenate([ds.train_y, ds.val_y, ds.test_y], axis=0)
    ns = min(max_exact, x_all.shape[0])
    xs, vs = x_all[:ns], y_all[:ns, None]
    dk = j_kernels.fit_mixture_weights_subset(j_kernels.mixture_kernel(nu, order), xs, m=1024)
    lat = np.asarray(lattice_filter_any(jnp.asarray(vs), jnp.asarray(xs), dk))
    xj = jnp.asarray(xs)
    exact = np.asarray(j_kernels.kernel_value_jnp(dk, ((xj[:, None, :] - xj[None, :, :]) ** 2).sum(-1))
                       @ jnp.asarray(vs))
    scale = (lat * exact).sum() / (lat * lat).sum()
    rel = float(np.linalg.norm(scale * lat - exact) / np.linalg.norm(exact))
    cos = float((lat * exact).sum() / (np.linalg.norm(lat) * np.linalg.norm(exact)))
    return rel, cos, ns


@pytest.mark.parametrize("nu,max_exact", [(1.5, 20000), (2.5, 150)])
def test_mixture_errors_match_jax(capsys, nu, max_exact):
    """--kernel mixture: the port's subset refit and K12 filter against JAX's, within 1e-3.

    Each side fits its own weights (NNLS on filters that differ by rel 2e-5),
    so the two measure slightly different operators; their errors agree to
    1e-3, the bound mvm_err's elevators run is held to on the card.
    """
    rec = mvm_err.main(["--dataset", "snelson", "--kernel", "mixture", "--nu", str(nu), "--max-exact",
                        str(max_exact), "--iters", "1", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == rec
    rel, cos, ns = _jax_mixture_errors("snelson", 1, nu, max_exact)
    assert rec["kernel"] == "mixture" and rec["nu"] == nu and rec["exact_subset_n"] == ns
    assert abs(rec["rel_err"] - rel) <= 1e-3, (rec["rel_err"], rel)
    assert abs(rec["cos_err"] - cos) <= 1e-3, (rec["cos_err"], cos)


def test_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        mvm_err.main(["--dataset", "snelson", "--device", "cuda"])
