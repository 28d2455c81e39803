"""Port of tests/test_training_stability.py: late-epoch NLML scatter within the probe noise.

The port trains the JAX test's problem at the reference's loose training
tolerance (CG tol 1.0, with the 10-iteration floor), 60 Adam epochs at lr
0.1, probes re-drawn each epoch; the scatter of the last 15 losses around
their linear trend must stay below max(5 x the NLML's probe-noise std at
the final parameters, 0.02), the JAX test's bound.
"""

import numpy as np
import torch
import torch_parity  # noqa: F401 (one intra-op thread per worker)

import simplex_gp_torch as T
from simplex_gp_torch.models.components import init_raw_params


def _make_problem(n=512, d=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, 2)).astype(np.float32) / np.sqrt(d)
    y = np.tanh(x @ w) @ rng.normal(size=(2,)).astype(np.float32)
    y = (y + 0.1 * rng.normal(size=n)).astype(np.float32)
    y = (y - y.mean()) / (y.std() + 1e-6)
    return torch.from_numpy(x), torch.from_numpy(y)


def test_late_epoch_mll_scatter_within_probe_noise():
    x, y = _make_problem()
    d = x.shape[-1]
    model = T.SimplexGP(num_dims=d, kernel="rbf", order=1, min_noise=1e-4,
                        bbmm=T.BBMMConfig(cg_tolerance=1.0, max_cg_iterations=100, max_lanczos_iterations=30,
                                          num_probes=8, precond_rank=50))
    model.load_raw(init_raw_params(d, lengthscale=float(np.sqrt(2.0 * d) / np.sqrt(2.0))))
    hist = T.fit_adam(lambda g: model.nlml(x, y, generator=g), model.parameters(), epochs=60, lr=0.1, seed=0)
    losses = np.asarray(hist["loss"])
    assert np.all(np.isfinite(losses))
    with torch.no_grad():
        nl = [float(model.nlml(x, y, generator=torch.Generator().manual_seed(1000 + i))) for i in range(8)]
    probe_std = float(np.std(nl))
    tail = losses[-15:]
    t = np.arange(tail.size, dtype=np.float64)
    tail_std = float(np.std(tail - np.polyval(np.polyfit(t, tail, 1), t)))
    assert tail_std < max(5.0 * probe_std, 0.02), (
        f"late-epoch MLL scatter {tail_std:.4f} exceeds 5x probe noise {probe_std:.4f}")
