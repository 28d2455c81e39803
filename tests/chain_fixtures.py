"""Sort-chain plans and build inputs shared by the chain's CPU tests (test_torch_chain_plan.py,
test_torch_chain_build.py) and card tests (test_torch_kernels_cuda.py); jax-free, not collected (no test_
prefix)."""

import numpy as np
import torch

from simplex_gp_torch.kernels import chain as KC

# Run lengths of every class of the sort chain's splat: short (1 .. SHORT = 32), mid (33 .. PIECE = 1,024)
# and long (> PIECE: one to three pieces).
RUN_LENGTHS = [1, 2, 3, 31, 32, 33, 1024, 1025, 2500, 5, 16, 17, 63, 64, 65, 100, 1, 2049, 3072, 4, 8, 9]


def synthetic_chain_plan(lengths, n, seed, device="cpu", dead=3, axes=None):
    """A sort-chain plan with the given run lengths (its live rows) and ``dead`` rows past them, over n
    points, seeded; only the splat's fields are filled (the axis and slice fields are empty), unless
    ``axes = (d, order)``: then d + 1 axes of random taps (0 where a tap would reach past the live rows, as
    a built plan's are) and d transitions, each a random permutation of the live rows that leaves the dead
    rows in place.  Every seventh weight is 0, so some contributions are 0 times a negative value, -0."""
    rng = np.random.default_rng(seed)
    N = int(sum(lengths))
    cnt = torch.full((len(lengths) + dead,), N, dtype=torch.int32)
    cnt[:len(lengths)] = torch.from_numpy(np.cumsum(lengths).astype(np.int32))
    points = torch.from_numpy(rng.integers(0, n, size=N).astype(np.int32))
    weights = rng.uniform(-1.0, 1.0, size=N).astype(np.float32)
    weights[::7] = 0.0
    empty = torch.zeros(0, dtype=torch.int32)
    gather, tapw = empty, torch.zeros(0)
    if axes is not None:
        d, order = axes
        live, Mc = len(lengths), len(lengths) + dead
        gather = np.tile(np.arange(Mc, dtype=np.int32), (d, 1))
        for j in range(d):
            gather[j, :live] = rng.permutation(live)
        taps = rng.uniform(-1.0, 1.0, size=(d + 1, order, Mc)).astype(np.float32)
        for k in range(1, order + 1):
            taps[:, k - 1, max(live - k, 0):] = 0.0
        gather, tapw = torch.from_numpy(gather), torch.from_numpy(taps)
    plan = KC.ChainPlan(points, torch.from_numpy(weights), cnt, *KC.run_lists(cnt, len(lengths), N),
                        gather, tapw, empty, torch.zeros((n, 2)),
                        torch.tensor(len(lengths), dtype=torch.int32))
    return KC.ChainPlan(*(t.to(device) for t in plan))


def chain_class_positions(seed=9):
    """(3,200, 2) float32 positions whose sort-chain plan (order-1 RBF) has runs of every class: a tight
    cluster (long runs), a looser one (mid) and spread points (short)."""
    rng = np.random.default_rng(seed)
    return np.concatenate([0.02 * rng.normal(size=(2500, 2)), 0.3 * rng.normal(size=(300, 2)),
                           3.0 * rng.normal(size=(400, 2))]).astype(np.float32)


def synthetic_mixture_plan(lengths, n, dp1, seed, device="cpu"):
    """(seg_ids (J, n, dp1), weights, neighbours (dp1, J M, 2), live (J,)) of a stacked mixture plan whose
    component j's live rows have the run lengths ``lengths[j]`` (an empty list: a component with no live
    row), M rows a component with 3 or more dead rows past every component's live ones.  The J n dp1
    contributions, seeded, are scattered over the stacked seg ids, a component's into any component's rows
    (so a component without live rows still has contributions); the last component gets runs of 1 to make
    up the count.  Every neighbour is missing (the blur is the centre tap).  Every seventh weight is 0."""
    rng = np.random.default_rng(seed)
    J = len(lengths)
    lengths = [list(ls) for ls in lengths]
    lengths[-1] += [1] * (J * n * dp1 - sum(map(sum, lengths)))
    M = max(map(len, lengths)) + 3
    seg = np.concatenate([np.repeat(j * M + np.arange(len(ls)), ls) for j, ls in enumerate(lengths)])
    seg = rng.permutation(seg).astype(np.int32).reshape(J, n, dp1)
    weights = rng.uniform(-1.0, 1.0, size=seg.size).astype(np.float32)
    weights[::7] = 0.0
    out = (torch.from_numpy(seg), torch.from_numpy(weights.reshape(J, n, dp1)),
           torch.full((dp1, J * M, 2), M, dtype=torch.int32),
           torch.tensor([len(ls) for ls in lengths], dtype=torch.int32))
    return tuple(t.to(device) for t in out)


def colliding_inputs(n=400, d=3, seed=0):
    """K1-shaped inputs (h1, h2, s, weights) in which a third of the points' vertices are copied with h2 + 1:
    distinct lattice points whose axis-0 keys are equal (the same chain word c1 and sum s; c2 one apart,
    its top 11 bits the same), the rank stage's runs of equal keys.  Vertex hashes are drawn at random in
    a small range, so that lattice points repeat too."""
    rng = np.random.default_rng(seed)
    N = n * (d + 1)
    h1 = rng.integers(-50, 50, size=N).astype(np.int32)
    h2 = (2 * rng.integers(-50, 50, size=N)).astype(np.int32)
    s = rng.integers(-3, 3, size=N).astype(np.int32)
    twin = rng.random(N) < 0.33
    src = rng.integers(0, N, size=N)
    h1[twin], s[twin], h2[twin] = h1[src[twin]], s[src[twin]], h2[src[twin]] + 1
    w = rng.uniform(0.0, 1.0, size=(n, d + 1)).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (h1, h2, s, w))
