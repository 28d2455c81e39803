"""The UCI stand-in table, made on the device from the configuration's ``data_seed``.

A PyTorch copy of the recipe of simplex_gp_torch/utils/data.py:73-145
(``_synthetic_uci``, i.i.d. case): x i.i.d. standard normal at the table's
published (n, d), y a rank-3 tanh ridge plus noise 0.1; split as :145-170
(``prepare_dataset``): the first 80% train-and-val, of which the last 20%
val, the last 20% test, z-scored by the train rows' statistics.  The median
lengthscale is that of simplex_gp_torch/train.py:126-131
(``median_lengthscale``): the median pairwise distance of 2,000 train rows
over sqrt(2).  The table is the configuration's, the same in every run.
"""

from __future__ import annotations

import math

import torch

from ..data import seed_of

__all__ = ["make", "split_sizes", "make_data", "median_lengthscale"]


def make(cfg: dict, device) -> dict:
    """The configuration's table (its ``n``, ``d`` and ``data_seed``)."""
    return make_data(cfg["n"], cfg["d"], device, cfg["data_seed"])


def split_sizes(n: int) -> tuple:
    """(train, val, test) rows of prepare_dataset's positional 80/20, 80/20 split."""
    n_tt = int(0.8 * n)
    n_train = int(0.8 * n_tt)
    return n_train, n_tt - n_train, n - n_tt


def make_data(n: int, d: int, device, data_seed: int = 0) -> dict:
    """The stand-in table, split and z-scored: train_x, train_y, val_x, val_y, test_x, test_y (float32), and the
    median lengthscale of its train rows.

    The table and its row order are drawn from ``data_seed`` (the
    configuration's), the same in every run: the preconditioner's first pivot
    is the first row (every diagonal is equal), so an order drawn from the
    run's seed gave every seed its own preconditioner and its own CG work.
    The run's ``seed`` draws everything else (probes, the jitter's order,
    Omega, the batches).
    """
    g = torch.Generator(device=device).manual_seed(seed_of(data_seed, "data"))
    f32 = dict(dtype=torch.float32, device=device)
    x = torch.randn((n, d), generator=g, **f32)
    rank = min(3, d)
    w1 = torch.randn((d, rank), generator=g, **f32) / math.sqrt(d)
    w2 = torch.randn((rank,), generator=g, **f32)
    y = torch.tanh(x @ w1) @ w2 + 0.1 * torch.randn((n,), generator=g, **f32)
    n_train, n_val, _ = split_sizes(n)
    tx, ty = x[:n_train], y[:n_train]
    mx, sx = tx.mean(0, keepdim=True), tx.std(0, unbiased=False, keepdim=True) + 1e-6
    my, sy = ty.mean(), ty.std(unbiased=False) + 1e-6
    x, y = (x - mx) / sx, (y - my) / sy
    out = {"median_lengthscale": median_lengthscale(x[:n_train], data_seed)}
    cut = (0, n_train, n_train + n_val, n)
    for i, name in enumerate(("train", "val", "test")):
        out[f"{name}_x"], out[f"{name}_y"] = x[cut[i]:cut[i + 1]].contiguous(), y[cut[i]:cut[i + 1]].contiguous()
    return out


def median_lengthscale(x: torch.Tensor, seed: int) -> float:
    """Median pairwise distance of 2,000 rows drawn from the seed, over sqrt(2)."""
    g = torch.Generator(device=x.device).manual_seed(seed_of(seed, "median"))
    sub = x[torch.randperm(x.shape[0], generator=g, device=x.device)[:2000]].double()
    d2 = ((sub[:, None, :] - sub[None, :, :]) ** 2).sum(-1)
    v = torch.sort(d2[d2 > 0]).values
    k = v.shape[0]
    med = 0.5 * (v[(k - 1) // 2] + v[k // 2])
    return float(torch.sqrt(med)) / math.sqrt(2.0)
