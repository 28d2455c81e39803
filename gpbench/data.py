"""The inputs common to every configuration: the run's seed streams, parameter points, the jitter.

The table itself comes from the recipe that the configuration's ``data``
names (``gpbench/recipes/<data>.py``); the points the traffic replays from
``gpbench/trajectories/`` or from the configuration's ``points``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["seed_of", "inv_softplus", "point_raw", "Strata", "jittered"]


def seed_of(seed: int, stream: str) -> int:
    """A 63-bit seed for one named stream of draws from the run's seed."""
    return int(np.random.SeedSequence([seed & (2 ** 64 - 1), *stream.encode()]).generate_state(1, np.uint64)[0]
               & (2 ** 63 - 1))


def inv_softplus(y: float) -> float:
    return float(np.log(np.expm1(max(y, 1e-8))))


def point_raw(point: dict, d: int, ell_median: float) -> dict:
    """The raw parameters (numpy float32) of a configuration's point of constrained values (a lengthscale of
    "median" is the data's median lengthscale), as GPyTorch's softplus maps them."""
    ell = ell_median if point["lengthscale"] == "median" else float(point["lengthscale"])
    return {"raw_lengthscale": np.full(d, inv_softplus(ell), np.float32),
            "raw_outputscale": np.float32(inv_softplus(point["outputscale"])),
            "raw_noise": np.float32(inv_softplus(point["noise"])),
            "mean": np.float32(point["mean"])}


class Strata:
    """Draws of exp(U(lo, hi)) from a fixed set of 64 stratified values, in an order drawn from the seed.

    Every seed sees the same values, so the work per step is the same however the seed orders them.
    """

    K = 64

    def __init__(self, lo: float, hi: float, width: int, seed: int, stream: str):
        self.values = np.exp(lo + (hi - lo) * (np.arange(self.K) + 0.5) / self.K)
        self.rng = np.random.default_rng(seed_of(seed, stream))
        self.width, self.queue = width, np.zeros((width, 0), np.int64)

    def draw(self) -> np.ndarray:
        if self.queue.shape[1] == 0:
            self.queue = np.stack([self.rng.permutation(self.K) for _ in range(self.width)])
        out, self.queue = self.values[self.queue[:, 0]], self.queue[:, 1:]
        return out


def jittered(raw: dict, draws: dict, min_noise: float) -> dict:
    """``raw`` with its lengthscales, outputscale and noise multiplied by the draws (constrained values)."""
    sp = lambda v: np.logaddexp(v, 0.0)
    out = dict(raw)
    if "lengthscale" in draws:
        out["raw_lengthscale"] = np.log(np.expm1(sp(raw["raw_lengthscale"].astype(np.float64)) * draws["lengthscale"])
                                        ).astype(np.float32)
    if "outputscale" in draws:
        out["raw_outputscale"] = np.float32(inv_softplus(float(sp(float(raw["raw_outputscale"]))
                                                               * draws["outputscale"][0])))
    if "noise" in draws:
        noise = (min_noise + float(sp(float(raw["raw_noise"])))) * draws["noise"][0]
        out["raw_noise"] = np.float32(inv_softplus(noise - min_noise))
    return out
