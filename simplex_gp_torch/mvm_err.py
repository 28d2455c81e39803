"""MVM accuracy and speed of the lattice filter: ``python -m simplex_gp_torch.mvm_err``.

Port of experiments/mvm_err.py.  Computes K(X, X) @ y over every row of a
dataset (train, val and test) with the one-shot filter ``filter_once`` (K4)
-- for ``--kernel mixture`` with ``lattice_filter_any`` (K1, K2 per
component, K12) -- and times it; then, on the first ``--max-exact`` rows,
compares the filter with the dense kernel product and reports the
scale-corrected relative error and the cosine (mvm_err.py:109-113).  One JSON line, with the keys of the
JAX script::

    python -m simplex_gp_torch.mvm_err --dataset elevators --order 1 --device cuda

Where n(d+1) > 2^20 the filter's table is trimmed to the measured occupancy
(K8 ``count_lattice_points``) times 1.05, rounded up to a multiple of 8192,
if that is below 0.9 n(d+1) (mvm_err.py:69-74); mixture filters are never
trimmed.  A mixture's weights are subset-fit (m = 1,024) to the dense
Matern-nu target on all rows for the timed filter, and again on the first
``--max-exact`` rows for the accuracy measurement, whose operator they must
describe (mvm_err.py:53-58, 81-92); the dense side is the target.  Times
are medians of ``--iters`` calls after one warm-up, by CUDA events on a card and by the host
clock on the CPU, in seconds.  The dense side is ``kernel_value`` of the
squared distances, both products by ``torch.matmul``.  ``--device`` has no
fallback: ``cuda`` without a card is an error.  The training flags of
experiments/common.py do not apply here and are not taken.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .ops.filter import lattice_filter_any
from .ops.kernels import (
    DiscretizedKernel,
    fit_mixture_weights_subset,
    kernel_value,
    matern_kernel,
    mixture_kernel,
    rbf_kernel,
)
from .ops.lattice import count_lattice_points, filter_once
from .utils.data import load_dataset
from .utils.device import resolve_device

__all__ = ["main", "trim_capacity", "dense_mvm"]

# Contribution rows n(d+1) above which the table is trimmed (mvm_err.py:69).
TRIM_ROWS = 1024 * 1024


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m simplex_gp_torch.mvm_err", description=__doc__.split("\n")[0])
    p.add_argument("--dataset", default="snelson")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--max-n", type=int, default=0, help="optional training-subset cap")
    p.add_argument("--kernel", default="rbf", choices=["rbf", "matern", "mixture"])
    p.add_argument("--nu", type=float, default=1.5)
    p.add_argument("--order", type=int, default=1)
    p.add_argument("--max-exact", type=int, default=20000)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--device", default="cuda", help="cuda (default; an error without a card) or cpu")
    return p.parse_args(argv)


def trim_capacity(x: torch.Tensor, dk: DiscretizedKernel) -> Optional[int]:
    """The filter's table capacity for positions x (n, d): None (untrimmed) or the trimmed row count."""
    n, d = x.shape
    if n * (d + 1) <= TRIM_ROWS:
        return None
    occ = int(count_lattice_points(x, dk.variance, dk.coeffs))
    c = -(-int(occ * 1.05) // 8192) * 8192
    return c if c < 0.9 * n * (d + 1) else None


def dense_mvm(x: torch.Tensor, v: torch.Tensor, dk) -> torch.Tensor:
    """The exact kernel product K(x, x) @ v, with squared distances in matmul form."""
    sq = (x * x).sum(-1)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * torch.matmul(x, x.T), min=0.0)
    return torch.matmul(kernel_value(dk, d2), v)


def _seconds(fn: Callable[[], torch.Tensor], reps: int, dev: torch.device) -> float:
    """Median seconds per call of ``fn`` after one warm-up call."""
    fn()
    times = []
    for _ in range(max(1, reps)):
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Measure, print one JSON line, and return it as a dict."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    ds = load_dataset(args.dataset, args.data_dir, args.max_n)
    x_all = np.concatenate([ds.train_x, ds.val_x, ds.test_x], axis=0)
    y_all = np.concatenate([ds.train_y, ds.val_y, ds.test_y], axis=0)
    mixture = args.kernel == "mixture"

    with torch.no_grad():
        x = torch.from_numpy(x_all).to(dev)
        v = torch.from_numpy(y_all[:, None].copy()).to(dev)
        if mixture:
            dk = fit_mixture_weights_subset(mixture_kernel(args.nu, args.order), x, m=1024)
            t_lattice = _seconds(lambda: lattice_filter_any(v, x, dk), args.iters, dev)
        else:
            dk = rbf_kernel(args.order) if args.kernel == "rbf" else matern_kernel(args.nu, args.order)
            cap = trim_capacity(x, dk)
            t_lattice = _seconds(lambda: filter_once(v, x, dk.coeffs, dk.variance, cap), args.iters, dev)

        ns = min(args.max_exact, x_all.shape[0])
        xs, vs = x[:ns].contiguous(), v[:ns].contiguous()
        if mixture:
            dk_sub = fit_mixture_weights_subset(mixture_kernel(args.nu, args.order), xs, m=1024)
            lat_s = lattice_filter_any(vs, xs, dk_sub)
        else:
            lat_s = filter_once(vs, xs, dk.coeffs, dk.variance)
        lat_s = lat_s.cpu().numpy().astype(np.float64)
        t_exact = _seconds(lambda: dense_mvm(xs, vs, dk), args.iters, dev)
        exact = dense_mvm(xs, vs, dk).cpu().numpy().astype(np.float64)

    scale = (lat_s * exact).sum() / (lat_s * lat_s).sum()
    record = {
        "dataset": args.dataset,
        "n": int(x_all.shape[0]),
        "d": int(x_all.shape[1]),
        "order": args.order,
        "kernel": args.kernel,
        "nu": args.nu if args.kernel in ("matern", "mixture") else None,
        "rel_err": float(np.linalg.norm(scale * lat_s - exact) / np.linalg.norm(exact)),
        "cos_err": float((lat_s * exact).sum() / (np.linalg.norm(lat_s) * np.linalg.norm(exact))),
        "ts/lattice": t_lattice,
        "ts/exact_subset": t_exact,
        "exact_subset_n": ns,
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
