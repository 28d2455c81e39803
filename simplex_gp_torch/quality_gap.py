"""SimplexGP against DenseGP, crossed: ``python -m simplex_gp_torch.quality_gap``.

Port of experiments/quality_gap.py.  On a subset where the dense GP is exact
(``--max-n``) it trains both models from the same initial parameters
(``torch.optim.Adam`` at ``--lr``, optax.adam's update with eps 1e-8; the
lattice NLML's probes from a generator seeded ``--seed``), then crosses
{dense-trained, simplex-trained} parameters with {dense, lattice}
inference:

  dense_params/dense_inf       the gold standard;
  dense_params/lattice_inf     the lattice posterior at good parameters;
  simplex_params/lattice_inf   the production pipeline;
  simplex_params/dense_inf     the quality of lattice training alone;

each with validation and test RMSE, MAE and NLL.  With ``--prune-thresh`` > 0
two ``<params>/pruned_lattice_inf`` records serve each parameter set through
the ARD-screened model (``SimplexGP.posterior_cache_screened``) and give the
dims kept (``d_eff``).  Then one ``discretization@<params>`` record each: the
dense and lattice NLML and their gap, and the MVM's relative error and cosine
of the lattice operator (``ops/filter.py::lattice_filter_exact_grad``, on 8
seeded columns) against the dense kernel matrix.  Every lattice cache draws
its sketch from a generator seeded ``--seed`` + 1000, as JAX reuses one key.

Records go to standard output and to ``<--out>/quality_gap_<dataset><--tag>.jsonl``
(``--out`` is ``runs/torch`` by default).  ``--kernel mixture`` fits the
mixture weights at the initial lengthscales; its dense side is Matern-nu.
``--device`` has no fallback: ``cuda`` (the default) without a card is an
error.  For instance::

    python -m simplex_gp_torch.quality_gap --dataset elevators_sparse --max-n 4096 --kernel matern \\
        --min-noise 0.1 --ls-init median --epochs 100 --prune-thresh 0.3
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .linalg.mll import BBMMConfig
from .models.exact_gp import DenseGP, SimplexGP
from .ops.filter import lattice_filter_exact_grad
from .train import add_common_args, add_device_arg, add_prune_arg, init_lengthscale, regression_metrics
from .utils.data import load_dataset
from .utils.device import resolve_device

__all__ = ["main", "train"]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m simplex_gp_torch.quality_gap", description=__doc__.split("\n")[0])
    add_common_args(p)
    p.add_argument("--kernel", default="rbf", choices=["rbf", "matern", "mixture"])
    p.add_argument("--nu", type=float, default=1.5)
    p.add_argument("--order", type=int, default=1)
    p.add_argument("--cg-tol", type=float, default=1.0)
    p.add_argument("--cg-iter", type=int, default=500)
    p.add_argument("--eval-cg-tol", type=float, default=1e-2)
    p.add_argument("--lanc-iter", type=int, default=100)
    p.add_argument("--pre-size", type=int, default=100)
    p.add_argument("--root-rank", type=int, default=0, help="LOVE root rank (0 = --lanc-iter)")
    p.add_argument("--tag", default="", help="suffix of the output file")
    add_prune_arg(p)
    add_device_arg(p)
    return p.parse_args(argv)


def _raw(model) -> dict:
    return {k: v.detach().clone() for k, v in model.raw().items()}


def train(model, x: torch.Tensor, y: torch.Tensor, epochs: int, lr: float, seed: int, label: str):
    """``epochs`` Adam steps on the model's NLML; returns its raw parameters (a copy) and the MLL of each step."""
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    gen = torch.Generator(device=x.device).manual_seed(seed)
    lattice = isinstance(model, SimplexGP)
    mlls = []
    t0 = time.perf_counter()
    for _ in range(epochs):
        opt.zero_grad(set_to_none=True)
        loss = model.nlml(x, y, generator=gen) if lattice else model.nlml(x, y)
        loss.backward()
        opt.step()
        mlls.append(-float(loss.detach()))
    print(json.dumps({"phase": f"train_{label}", "mll_first": mlls[0], "mll_last": mlls[-1],
                      "mll_tail_std": float(np.std(np.asarray(mlls[-20:], np.float32))),
                      "ts": time.perf_counter() - t0}), flush=True)
    return _raw(model), mlls


def _metrics(split: str, mean: torch.Tensor, var: torch.Tensor, y: np.ndarray) -> dict:
    return {f"{split}/{k}": v for k, v in regression_metrics(mean.cpu().numpy(), var.cpu().numpy(), y).items()}


def main(argv: Optional[Sequence[str]] = None) -> list:
    """Train, cross, measure; returns the records written."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    ds = load_dataset(args.dataset, args.data_dir, args.max_n)
    x, y = torch.from_numpy(ds.train_x).to(dev), torch.from_numpy(ds.train_y).to(dev)
    xv, xt = torch.from_numpy(ds.val_x).to(dev), torch.from_numpy(ds.test_x).to(dev)
    n, d = x.shape

    # The mixture kernel targets Matern-nu, so the dense gold side is Matern.
    dense_kernel = "matern" if args.kernel == "mixture" else args.kernel
    dense = DenseGP(num_dims=d, kernel=dense_kernel, nu=args.nu, min_noise=args.min_noise, device=dev)
    simplex = SimplexGP(num_dims=d, kernel=args.kernel, nu=args.nu, order=args.order, min_noise=args.min_noise,
                        bbmm=BBMMConfig(cg_tolerance=args.cg_tol, max_cg_iterations=args.cg_iter,
                                        max_lanczos_iterations=args.lanc_iter, precond_rank=args.pre_size),
                        eval_cg_tolerance=args.eval_cg_tol, prune_thresh=args.prune_thresh, device=dev)
    init_lengthscale(dense, args, ds)
    init_lengthscale(simplex, args, ds)
    if args.kernel == "mixture":
        simplex.with_fitted_mixture(x)
        print(json.dumps({"mix_weights": list(simplex.mix_weights)}), flush=True)

    out_path = pathlib.Path(args.out) / f"quality_gap_{args.dataset}{args.tag}.jsonl"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    records = []
    with open(out_path, "w") as out:
        def emit(rec):
            print(json.dumps(rec), flush=True)
            out.write(json.dumps(rec) + "\n")
            out.flush()
            records.append(rec)

        emit({"dataset": args.dataset, "n": n, "d": d, "order": args.order, "kernel": args.kernel,
              "cg_tol": args.cg_tol, "eval_cg_tol": args.eval_cg_tol, "pre_size": args.pre_size,
              "ls_init": args.ls_init})
        raw_d, mlls_d = train(dense, x, y, args.epochs, args.lr, args.seed, "dense")
        raw_s, mlls_s = train(simplex, x, y, args.epochs, args.lr, args.seed, "simplex")
        emit({"phase": "train_curves", "dense_mll_tail_std": float(np.std(mlls_d[-20:])),
              "simplex_mll_tail_std": float(np.std(mlls_s[-20:]))})

        root_rank = args.root_rank or None

        def sketch():
            return torch.Generator(device=dev).manual_seed(args.seed + 1000)

        def dense_inf(raw):
            dense.load_raw(raw)
            return [dense.predict(x, y, xe) for xe in (xv, xt)]

        def lattice_inf(raw):
            simplex.load_raw(raw)
            cache = simplex.posterior_cache(x, y, generator=sketch(), root_rank=root_rank)
            return [simplex.predict_from_cache(cache, x, xe) for xe in (xv, xt)]

        combos = {
            "dense_params/dense_inf": lambda: dense_inf(raw_d),
            "dense_params/lattice_inf": lambda: lattice_inf(raw_d),
            "simplex_params/lattice_inf": lambda: lattice_inf(raw_s),
            "simplex_params/dense_inf": lambda: dense_inf(raw_s),
        }
        for name, fn in combos.items():
            (vm, vv), (tm, tv) = fn()
            emit({"combo": name, **_metrics("val", vm, vv, ds.val_y), **_metrics("test", tm, tv, ds.test_y)})

        if args.prune_thresh > 0:
            for label, raw in (("dense_params", raw_d), ("simplex_params", raw_s)):
                simplex.load_raw(raw)
                cache = simplex.posterior_cache_screened(x, y, generator=sketch(), root_rank=root_rank)
                (vm, vv), (tm, tv) = (simplex.predict_from_cache_screened(cache, x, xe) for xe in (xv, xt))
                d_eff = d if cache["keep"] is None else len(cache["keep"])
                emit({"combo": f"{label}/pruned_lattice_inf", "d_eff": d_eff, "prune_thresh": args.prune_thresh,
                      **_metrics("val", vm, vv, ds.val_y), **_metrics("test", tm, tv, ds.test_y)})

        # The discretization at each parameter set: the NLML gap and the MVM's error against the dense kernel.
        v = torch.from_numpy(np.random.default_rng(3).normal(size=(n, 8)).astype(np.float32)).to(dev)
        for label, raw in (("dense_params", raw_d), ("simplex_params", raw_s)):
            simplex.load_raw(raw)
            dense.load_raw(raw)
            with torch.no_grad():
                params = simplex.constrained()
                nl_d = float(dense.nlml(x, y))
                nl_s = float(simplex.nlml(x, y, generator=torch.Generator(device=dev).manual_seed(7)))
                kv_lat = params["outputscale"] * lattice_filter_exact_grad(v, x * params["inv_ell"], simplex.dk)
                kv_dense = dense._kmat(params, x, x) @ v
                norm_lat, norm_dense = torch.linalg.norm(kv_lat), torch.linalg.norm(kv_dense)
                emit({"phase": f"discretization@{label}", "nlml_dense": nl_d, "nlml_lattice": nl_s,
                      "nlml_gap": nl_s - nl_d, "mvm_rel_err": float(torch.linalg.norm(kv_lat - kv_dense) / norm_dense),
                      "mvm_cos": float((kv_lat * kv_dense).sum() / (norm_lat * norm_dense)),
                      "mean_lengthscale": float(np.mean(1.0 / params["inv_ell"].cpu().numpy())),
                      "noise": float(params["noise"])})
    return records


if __name__ == "__main__":
    main()
