"""Evaluate a saved SimplexGP checkpoint: ``python -m simplex_gp_torch.eval_checkpoint``.

Port of experiments/eval_checkpoint.py.  It separates the eval pass from
training at large n: train with ``--no-eval``, then build one posterior cache
(the generator seeded ``--seed`` + 555) at the checkpoint's parameters and
predict the validation and test rows from it.  The checkpoint is a raw
parameter pickle as both trainers write it (``<--run-dir>/<--which>``,
``model_final.pkl`` by default; ``convert.load_jax_params``).

``--plan-capacity -1`` counts the occupancy (K8) at the checkpoint's
lengthscales on all d dims and takes ceil(1.4 occ / 8192) 8192 rows, at most
n(d+1) (eval_checkpoint.py:63-77; the trainer's headroom is 1.25, because the
lengthscales drift in training).  ``--prune-thresh`` > 0 screens the ARD
dims (``SimplexGP.screened``): the cache and both predictions run on the kept
columns, the screened model keeps the capacity (clamped to n(d'+1) by the
plan), a ``{"screened_dims": k, "of": d}`` line is printed, and with a
counted capacity a second line gives the screened plan's occupancy beside it.
The last line is one JSON object with JAX's keys (``cache_ts``, ``which``,
``root_rank``, ``cache_cg_res``, ``cache_cg_iters``, ``{val,test}/pred_ts``
and ``{val,test}/rmse|mae|nll``), appended to ``<--run-dir>/eval.jsonl``;
times are wall seconds, synchronised with the card.  The houseelectric
configuration of the round-5 runs::

    python -m simplex_gp_torch.eval_checkpoint --run-dir runs/torch/simplexgp_houseelectric_s0 \\
        --dataset houseelectric --kernel matern --nu 1.5 --min-noise 0.1 --plan-capacity -1

``--device`` has no fallback: ``cuda`` (the default) without a card is an
error.  Not ported: the power-of-two padding of the eval rows
(eval_checkpoint.py:116-123), a trick for XLA's compile buckets, and
``--host-loop`` with it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time
from typing import Optional, Sequence

import torch

from .convert import load_jax_params, raw_params_from_numpy
from .linalg.mll import BBMMConfig
from .models.components import constrain
from .models.exact_gp import SimplexGP
from .ops.kernels import matern_kernel, rbf_kernel
from .ops.lattice import count_lattice_points
from .train import add_common_args, add_device_arg, add_prune_arg, regression_metrics, trim_capacity
from .utils.data import load_dataset
from .utils.device import resolve_device

__all__ = ["main", "EVAL_HEADROOM"]

# Capacity headroom over the occupancy at the checkpoint's lengthscales (eval_checkpoint.py:75).
EVAL_HEADROOM = 1.4


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m simplex_gp_torch.eval_checkpoint",
                                description=__doc__.split("\n")[0])
    add_common_args(p)
    p.add_argument("--run-dir", required=True)
    p.add_argument("--which", default="model_final.pkl", help="checkpoint file name")
    p.add_argument("--kernel", default="rbf", choices=["rbf", "matern"])
    p.add_argument("--nu", type=float, default=1.5)
    p.add_argument("--order", type=int, default=1)
    p.add_argument("--eval-cg-tol", type=float, default=1e-2)
    p.add_argument("--cg-iter", type=int, default=500)
    p.add_argument("--pre-size", type=int, default=100)
    p.add_argument("--root-rank", type=int, default=0,
                   help="LOVE root rank (0 = the model's max_lanczos_iterations); smaller bounds the (n, m) sketch")
    add_prune_arg(p)
    add_device_arg(p)
    args = p.parse_args(argv)
    if args.plan_capacity < -1:
        p.error("--plan-capacity takes -1, 0 or a positive row count")
    return args


def _seconds(t0: float, dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Build the cache, predict val and test, print and append the record; returns it."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    ds = load_dataset(args.dataset, args.data_dir, args.max_n)
    run_dir = pathlib.Path(args.run_dir)
    raw = raw_params_from_numpy(load_jax_params(run_dir / args.which), device=dev)
    x = torch.from_numpy(ds.train_x).to(dev)
    y = torch.from_numpy(ds.train_y).to(dev)
    n, d = x.shape

    dk = rbf_kernel(args.order) if args.kernel == "rbf" else matern_kernel(args.nu, args.order)
    capacity = None
    if args.plan_capacity == -1:
        # At the checkpoint's lengthscales, which drift in training.
        occ = int(count_lattice_points(x * constrain(raw, args.min_noise)["inv_ell"], dk.variance, dk.coeffs))
        capacity = trim_capacity(occ, n, d, EVAL_HEADROOM)
        print(json.dumps({"plan_capacity": capacity, "occupancy": occ, "worst_case": n * (d + 1)}), flush=True)
    elif args.plan_capacity > 0:
        capacity = args.plan_capacity
    model = SimplexGP(num_dims=d, kernel=args.kernel, nu=args.nu, order=args.order, min_noise=args.min_noise,
                      bbmm=BBMMConfig(max_cg_iterations=args.cg_iter, precond_rank=args.pre_size,
                                      plan_capacity=capacity),
                      eval_cg_tolerance=args.eval_cg_tol, prune_thresh=args.prune_thresh, device=dev)
    model.load_raw(raw)

    t0 = time.perf_counter()
    sub, _, keep = model.screened()
    if keep is not None:
        print(json.dumps({"screened_dims": int(len(keep)), "of": int(d)}), flush=True)
        if args.plan_capacity == -1:
            occ_sub = int(count_lattice_points(x[:, torch.from_numpy(keep).to(dev)] * sub.constrained()["inv_ell"],
                                               dk.variance, dk.coeffs))
            print(json.dumps({"screened_occupancy": occ_sub, "plan_capacity": min(capacity, n * (len(keep) + 1))}),
                  flush=True)
    cache = model.posterior_cache_screened(x, y, generator=torch.Generator(device=dev).manual_seed(args.seed + 555),
                                           root_rank=args.root_rank or None)
    out = {"cache_ts": _seconds(t0, dev), "which": args.which, "root_rank": args.root_rank or None,
           "cache_cg_res": float(cache["cg_res"]), "cache_cg_iters": int(cache["cg_iters"])}
    for split, xe, ye in (("val", ds.val_x, ds.val_y), ("test", ds.test_x, ds.test_y)):
        t0 = time.perf_counter()
        mean, var = model.predict_from_cache_screened(cache, x, torch.from_numpy(xe).to(dev))
        mean, var = mean.cpu().numpy(), var.cpu().numpy()
        out[f"{split}/pred_ts"] = _seconds(t0, dev)
        out.update({f"{split}/{k}": v for k, v in regression_metrics(mean, var, ye).items()})
    print(json.dumps(out), flush=True)
    with open(run_dir / "eval.jsonl", "a") as f:
        f.write(json.dumps(out) + "\n")
    return out


if __name__ == "__main__":
    main()
