"""Simplex-GP trainer: ``python -m simplex_gp_torch.train``.

Port of experiments/train_simplexgp.py with the parts of
experiments/common.py:27-116 that the training path needs: load a dataset,
build the model, take ``--epochs`` Adam steps on the NLML (one JSON line per
epoch: loss, step ms, CG iterations), then build the posterior cache and
print the test RMSE and NLL.  Example, the elevators configuration of the
round-5 run (runs/r5/simplexgp_elevators_s0)::

    python -m simplex_gp_torch.train --dataset elevators --kernel matern \\
        --nu 1.5 --order 1 --min-noise 0.1 --ls-init median --device cuda

``--device`` has no fallback: ``cuda`` without a card is an error.
Periodic evaluation, early stopping, checkpoints and resume, the host loop,
the plan capacity, mixtures and ARD screening are not ported (ROADMAP).
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch

from .linalg.mll import BBMMConfig
from .models.components import init_raw_params
from .models.exact_gp import SimplexGP
from .utils.data import load_snelson, load_uci, prepare_dataset
from .utils.training import fit_adam

__all__ = ["main", "median_lengthscale", "regression_metrics"]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m simplex_gp_torch.train", description=__doc__.split("\n")[0])
    p.add_argument("--dataset", default="snelson")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--min-noise", type=float, default=1e-4)
    p.add_argument("--max-n", type=int, default=0, help="optional training-subset cap")
    p.add_argument("--ls-init", default="default", choices=["default", "median"],
                   help="lengthscale init: softplus(0) = 0.693, or the median pairwise distance / sqrt(2)")
    p.add_argument("--kernel", default="rbf", choices=["rbf", "matern"])
    p.add_argument("--nu", type=float, default=1.5)
    p.add_argument("--order", type=int, default=1)
    p.add_argument("--cg-tol", type=float, default=1.0)
    p.add_argument("--cg-iter", type=int, default=500)
    p.add_argument("--lanc-iter", type=int, default=100)
    p.add_argument("--pre-size", type=int, default=100)
    p.add_argument("--num-probes", type=int, default=10)
    p.add_argument("--device", default="cuda", help="cuda (default; an error without a card) or cpu")
    return p.parse_args(argv)


def median_lengthscale(x: np.ndarray) -> float:
    """Median pairwise distance of 2,000 seeded rows over sqrt(2) (common.py:95-103)."""
    sub = x[np.random.default_rng(0).permutation(x.shape[0])[:2000]]
    d2 = ((sub[:, None, :] - sub[None, :, :]) ** 2).sum(-1)
    return float(np.sqrt(np.median(d2[d2 > 0]))) / np.sqrt(2.0)


def regression_metrics(mean: np.ndarray, var: np.ndarray, y: np.ndarray) -> dict:
    err = mean - y
    return {
        "rmse": float(np.sqrt((err**2).mean())),
        "mae": float(np.abs(err).mean()),
        "nll": float(0.5 * (np.log(2 * np.pi * var) + err**2 / var).mean()),
    }


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is false (pass --device cpu to "
                           "train on the CPU)")
    return dev


def _load(args):
    if args.dataset == "snelson":
        x, y = load_snelson()
        data = np.concatenate([x, y[:, None]], axis=-1)
    else:
        data = load_uci(args.dataset, args.data_dir)
    ds = prepare_dataset(data, name=args.dataset, standardize=(args.dataset != "snelson"))
    if args.max_n and ds.train_x.shape[0] > args.max_n:
        ds = ds._replace(train_x=ds.train_x[: args.max_n], train_y=ds.train_y[: args.max_n])
    return ds


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train, evaluate on the test split, print JSON lines; returns the final record."""
    args = parse_args(argv)
    dev = _device(args.device)
    ds = _load(args)
    model = SimplexGP(
        num_dims=ds.train_x.shape[-1], kernel=args.kernel, nu=args.nu, order=args.order,
        min_noise=args.min_noise,
        bbmm=BBMMConfig(cg_tolerance=args.cg_tol, max_cg_iterations=args.cg_iter,
                        max_lanczos_iterations=args.lanc_iter, precond_rank=args.pre_size,
                        num_probes=args.num_probes),
        device=dev,
    )
    if args.ls_init == "median":
        model.load_raw(init_raw_params(model.num_dims, lengthscale=median_lengthscale(ds.train_x)))
    print(json.dumps({"config": vars(args), "device": str(dev), "n_train": int(ds.train_x.shape[0]),
                      "d": int(ds.train_x.shape[1])}), flush=True)
    x = torch.from_numpy(ds.train_x).to(dev)
    y = torch.from_numpy(ds.train_y).to(dev)
    stats = {}

    def loss_fn(gen):
        return model.nlml(x, y, generator=gen, stats=stats)

    def log(epoch, loss, step_ms):
        print(json.dumps({"epoch": epoch, "train/mll": -loss, "train/step_ms": step_ms,
                          "cg_iters": stats["cg_iters"]}), flush=True)

    history = fit_adam(loss_fn, model.parameters(), epochs=args.epochs, lr=args.lr, seed=args.seed,
                       callback=log)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    cache = model.posterior_cache(x, y, generator=gen)
    mean, var = model.predict_from_cache(cache, x, torch.from_numpy(ds.test_x).to(dev))
    final = {f"test/{k}": v for k, v in
             regression_metrics(mean.cpu().numpy(), var.cpu().numpy(), ds.test_y).items()}
    final.update({"eval_cg_iters": cache["cg_iters"], "train/loss": history["loss"],
                  "train/step_ms": history["step_ms"], "clock": history["clock"]})
    print(json.dumps(final), flush=True)
    return final


if __name__ == "__main__":
    main()
