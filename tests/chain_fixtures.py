"""Sort-chain plans shared by the chain's CPU tests (test_torch_chain_plan.py) and card tests
(test_torch_kernels_cuda.py); jax-free, not collected (no test_ prefix)."""

import numpy as np
import torch

from simplex_gp_torch.kernels import chain as KC

# Run lengths of every class of the sort chain's splat: short (1 .. SHORT = 32), mid (33 .. PIECE = 1,024)
# and long (> PIECE: one to three pieces).
RUN_LENGTHS = [1, 2, 3, 31, 32, 33, 1024, 1025, 2500, 5, 16, 17, 63, 64, 65, 100, 1, 2049, 3072, 4, 8, 9]


def synthetic_chain_plan(lengths, n, seed, device="cpu", dead=3):
    """A sort-chain plan with the given run lengths (its live rows) and ``dead`` rows past them, over n
    points, seeded; only the splat's fields are filled (the axis and slice fields are empty).  Every
    seventh weight is 0, so some contributions are 0 times a negative value, -0."""
    rng = np.random.default_rng(seed)
    N = int(sum(lengths))
    cnt = torch.full((len(lengths) + dead,), N, dtype=torch.int32)
    cnt[:len(lengths)] = torch.from_numpy(np.cumsum(lengths).astype(np.int32))
    points = torch.from_numpy(rng.integers(0, n, size=N).astype(np.int32))
    weights = rng.uniform(-1.0, 1.0, size=N).astype(np.float32)
    weights[::7] = 0.0
    empty = torch.zeros(0, dtype=torch.int32)
    plan = KC.ChainPlan(points, torch.from_numpy(weights), cnt, *KC.run_lists(cnt, len(lengths), N),
                        empty, torch.zeros(0), empty, torch.zeros((n, 2)),
                        torch.tensor(len(lengths), dtype=torch.int32))
    return KC.ChainPlan(*(t.to(device) for t in plan))


def chain_class_positions(seed=9):
    """(3,200, 2) float32 positions whose sort-chain plan (order-1 RBF) has runs of every class: a tight
    cluster (long runs), a looser one (mid) and spread points (short)."""
    rng = np.random.default_rng(seed)
    return np.concatenate([0.02 * rng.normal(size=(2500, 2)), 0.3 * rng.normal(size=(300, 2)),
                           3.0 * rng.normal(size=(400, 2))]).astype(np.float32)
