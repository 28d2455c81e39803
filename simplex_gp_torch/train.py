"""Simplex-GP trainer: ``python -m simplex_gp_torch.train``.

Port of experiments/train_simplexgp.py and the trainer loop of
experiments/common.py (``run_training``, :116-319): load a dataset, build the
model, take ``--epochs`` Adam steps on the NLML; every ``--log-int`` epochs
(and at the last) build the posterior cache and predict the validation
rows, step the early stopper on the validation RMSE, write
``model_best.pkl`` at a new best and a checkpoint; then predict the test
rows from the best epoch's cache and write ``model_final.pkl``.  Files go to
``<--out>/simplexgp_<dataset>_s<seed>/`` (``runs/torch`` by default): ``metrics.jsonl`` opens with a
config line, then one record per epoch with JAX's keys (``epoch``,
``train/mll``, ``train/loss_ts``, ``hyp/*``, and ``val/*`` at eval epochs),
then ``early_stop`` if it fired and the ``test/*`` record.  Standard output
carries the same lines, with the CG iteration counts added (``cg_iters``,
``val/cg_iters``, ``test/cg_iters``).  The model files are pickles of the
raw numpy parameter dict, the JAX trainer's format; the checkpoint
(``checkpoint.pt``) is torch's own: raw parameters, Adam state, epoch, the
generator's state and the stopper's.  ``--resume`` continues from it.

``--plan-capacity``: 0 keeps the training plan untrimmed (n(d+1) rows), a
value above 0 bounds it, and -1 counts the occupancy at the initial
lengthscale (K8) and takes ceil(1.25 occ / 8192) 8192 rows, at most
n(d+1) (train_simplexgp.py:53-67).  ``--kernel mixture`` (with
``--mix-components``, 8 by default) fits the mixture weights on a 1,024-row
subset at the initial lengthscales (train_simplexgp.py:88-93) and keeps
them for the run; they appear in the config line's model and on a line of
their own.  Its plans ignore the capacity (counted with the Matern taps,
as JAX counts it).  The houseelectric configuration of the
round-5 run (runs/r5/simplexgp_houseelectric_s0)::

    python -m simplex_gp_torch.train --dataset houseelectric --kernel matern \\
        --nu 1.5 --order 1 --min-noise 0.1 --ls-init median --plan-capacity -1 \\
        --log-int 10 --epochs 30

``--device`` has no fallback: ``cuda`` (the default) without a card is an
error.  Not ported: ``predict_padded``'s power-of-two padding of the eval
rows (common.py:206-227), a trick for XLA's compile buckets whose duplicate
rows change no real row; ``--host-loop`` (a TPU compile workaround); and
``--prune-thresh`` (ARD screening).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import pickle
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .convert import raw_params_to_numpy
from .linalg.mll import BBMMConfig
from .models.components import init_raw_params
from .models.exact_gp import SimplexGP
from .ops.kernels import matern_kernel, rbf_kernel
from .ops.lattice import count_lattice_points
from .utils.data import load_dataset
from .utils.device import resolve_device
from .utils.training import EarlyStopper

__all__ = ["main", "run_training", "add_common_args", "add_device_arg", "init_lengthscale", "median_lengthscale",
           "regression_metrics", "trim_capacity"]


def add_common_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The trainers' shared flags, experiments/common.py::add_common_args (:27-78) without ``--host-loop``."""
    p.add_argument("--dataset", default="snelson")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-int", type=int, default=5, help="evaluate every k epochs (and at the last)")
    p.add_argument("--patience", type=int, default=20, help="evals without a better val RMSE before stopping")
    p.add_argument("--min-noise", type=float, default=1e-4)
    p.add_argument("--out", default="runs/torch",
                   help="runs go to <out>/<model>_<dataset>_s<seed>/ (the JAX trainer's runs/ is left alone)")
    p.add_argument("--max-n", type=int, default=0, help="optional training-subset cap")
    p.add_argument("--ls-init", default="default", choices=["default", "median"],
                   help="lengthscale init: softplus(0) = 0.693, or the median pairwise distance / sqrt(2)")
    p.add_argument("--plan-capacity", type=int, default=0,
                   help="training plan rows: 0 = n(d+1), -1 = 1.25x the occupancy at the initial "
                        "lengthscale, rounded up to 8192 (an overflow makes the loss NaN), >0 = explicit; "
                        "lattice models only")
    p.add_argument("--no-eval", action="store_true", help="skip the val and test predictions")
    p.add_argument("--resume", action="store_true", help="continue from the run directory's checkpoint.pt")
    return p


def add_device_arg(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("--device", default="cuda", help="cuda (default; an error without a card) or cpu")
    return p


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m simplex_gp_torch.train", description=__doc__.split("\n")[0])
    add_common_args(p)
    p.add_argument("--kernel", default="rbf", choices=["rbf", "matern", "mixture"],
                   help="mixture: Gaussian-mixture lattice targeting Matern-nu, weights subset-fit at the "
                        "initial lengthscales")
    p.add_argument("--nu", type=float, default=1.5)
    p.add_argument("--order", type=int, default=1)
    p.add_argument("--mix-components", type=int, default=8)
    p.add_argument("--cg-tol", type=float, default=1.0)
    p.add_argument("--cg-iter", type=int, default=500)
    p.add_argument("--lanc-iter", type=int, default=100)
    p.add_argument("--pre-size", type=int, default=100)
    p.add_argument("--num-probes", type=int, default=10)
    add_device_arg(p)
    args = p.parse_args(argv)
    if args.plan_capacity < -1:
        p.error("--plan-capacity takes -1, 0 or a positive row count")
    return args


def median_lengthscale(x: np.ndarray) -> float:
    """Median pairwise distance of 2,000 seeded rows over sqrt(2) (common.py:95-103)."""
    sub = x[np.random.default_rng(0).permutation(x.shape[0])[:2000]]
    d2 = ((sub[:, None, :] - sub[None, :, :]) ** 2).sum(-1)
    return float(np.sqrt(np.median(d2[d2 > 0]))) / np.sqrt(2.0)


def trim_capacity(occupancy: int, n: int, d: int) -> int:
    """1.25x the occupancy rounded up to a multiple of 8192, at most n(d+1) (train_simplexgp.py:65)."""
    return min(-(-int(occupancy * 1.25) // 8192) * 8192, n * (d + 1))


def regression_metrics(mean: np.ndarray, var: np.ndarray, y: np.ndarray) -> dict:
    err = mean - y
    return {
        "rmse": float(np.sqrt((err**2).mean())),
        "mae": float(np.abs(err).mean()),
        "nll": float(0.5 * (np.log(2 * np.pi * var) + err**2 / var).mean()),
    }


def hyp_summary(model) -> dict:
    """The per-epoch hyperparameter record, of the keys the model's parameters have (common.py:240-260)."""
    with torch.no_grad():
        p = model.constrained()
    out = {f"hyp/{k}": float(p[k]) for k in ("noise", "outputscale") if k in p}
    if "inv_ell" in p:
        inv = p["inv_ell"].detach().cpu().numpy().astype(np.float64).ravel()
        ell = 1.0 / np.maximum(inv, 1e-12)
        out.update({"hyp/ell_mean": float(ell.mean()), "hyp/ell_min": float(ell.min()),
                    "hyp/ell_max": float(ell.max()), "hyp/d_eff_30": int((inv >= 0.3 * inv.max()).sum())})
    return out


def _plan_capacity(args, x: torch.Tensor, dk, ell: float) -> Optional[int]:
    """The training plan's capacity from ``--plan-capacity`` (train_simplexgp.py:53-69)."""
    if args.plan_capacity == 0:
        return None
    if args.plan_capacity > 0:
        return args.plan_capacity
    n, d = x.shape
    occ = int(count_lattice_points(x / ell, dk.variance, dk.coeffs))
    cap = trim_capacity(occ, n, d)
    print(json.dumps({"plan_capacity": cap, "occupancy": occ, "worst_case": n * (d + 1)}), flush=True)
    return cap


def _emit(log_f, rec: dict, extra: Optional[dict] = None):
    """One record: to metrics.jsonl as is, to standard output with ``extra``."""
    log_f.write(json.dumps(rec) + "\n")
    log_f.flush()
    print(json.dumps({**rec, **(extra or {})}), flush=True)


def init_lengthscale(model, args, ds) -> Optional[float]:
    """With ``--ls-init median``, load raw parameters at the median lengthscale (common.py:95-103); returns it."""
    if args.ls_init != "median":
        return None
    ell = median_lengthscale(ds.train_x)
    model.load_raw(init_raw_params(model.num_dims, lengthscale=ell))
    return ell


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train a SimplexGP with periodic evaluation; returns run_training's summary and the plan capacity."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    ds = load_dataset(args.dataset, args.data_dir, args.max_n)
    x = torch.from_numpy(ds.train_x).to(dev)
    bbmm = BBMMConfig(cg_tolerance=args.cg_tol, max_cg_iterations=args.cg_iter,
                      max_lanczos_iterations=args.lanc_iter, precond_rank=args.pre_size,
                      num_probes=args.num_probes)
    model = SimplexGP(num_dims=x.shape[-1], kernel=args.kernel, nu=args.nu, order=args.order,
                      min_noise=args.min_noise, bbmm=bbmm, mix_components=args.mix_components, device=dev)
    ell = init_lengthscale(model, args, ds)
    # A mixture's capacity is counted with the Matern taps (train_simplexgp.py:60); its plans ignore it.
    count_dk = rbf_kernel(args.order) if args.kernel == "rbf" else matern_kernel(args.nu, args.order)
    model.bbmm = dataclasses.replace(bbmm, plan_capacity=_plan_capacity(args, x, count_dk, ell or 0.6931))
    if args.kernel == "mixture":
        model.with_fitted_mixture(x)
        print(json.dumps({"mix_weights": list(model.mix_weights)}), flush=True)
    return {**run_training(model, ds, args, "simplexgp"), "plan_capacity": model.bbmm.plan_capacity}


def run_training(model, ds, args, name: str) -> dict:
    """The Adam loop with periodic evaluation and early stopping (common.py::run_training, :116-319).

    ``model`` is an ``nn.Module`` of raw parameters on its device, with
    ``nlml`` and either ``posterior_cache`` / ``predict_from_cache`` (the
    lattice models: their NLML draws probes from the run's generator and
    reports CG iterations, and an eval builds one cache, reused for the test
    rows at the best epoch) or a one-shot ``predict(x, y, x_eval)`` (SKIP,
    SGPR, the dense GP; common.py:203, :229-231, :310-311).  Files go to
    ``<args.out>/<name>_<dataset>_s<seed>/``.  Returns the epoch records, the
    test record, the run directory and the early-stop epoch.
    """
    dev = next(model.parameters()).device
    x = torch.from_numpy(ds.train_x).to(dev)
    y = torch.from_numpy(ds.train_y).to(dev)
    has_cache = hasattr(model, "posterior_cache")
    out_dir = pathlib.Path(args.out) / f"{name}_{args.dataset}_s{args.seed}"
    out_dir.mkdir(parents=True, exist_ok=True)
    log_f = open(out_dir / "metrics.jsonl", "a")
    _emit(log_f, {"config": vars(args), "model": repr(model)}, {"device": str(dev)})

    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    gen = torch.Generator(device=dev).manual_seed(args.seed)  # NLML probes, then each eval's omega
    stopper = EarlyStopper(patience=args.patience)
    start_epoch = 0
    ckpt_path = out_dir / "checkpoint.pt"
    if args.resume and ckpt_path.exists():
        ck = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        model.load_raw(ck["raw"])
        opt.load_state_dict(ck["opt"])
        gen.set_state(ck["generator"])
        stopper.load_state_dict(ck["stopper"])
        start_epoch = ck["epoch"] + 1
        print(json.dumps({"resumed_from_epoch": ck["epoch"]}), flush=True)

    def raw_cpu() -> dict:
        return {k: v.detach().cpu().clone() for k, v in model.raw().items()}

    def save_params(fname: str, raw: dict):
        with open(out_dir / fname, "wb") as f:
            pickle.dump(raw_params_to_numpy(raw), f)

    def evaluate(x_eval: np.ndarray, cache=None):
        """(cache, mean, var) at x_eval: from ``cache`` or a new one, or the model's one-shot predict."""
        xe = torch.from_numpy(x_eval).to(dev)
        if not has_cache:
            mean, var = model.predict(x, y, xe)
        else:
            cache = cache if cache is not None else model.posterior_cache(x, y, generator=gen)
            mean, var = model.predict_from_cache(cache, x, xe)
        return cache, mean.cpu().numpy(), var.cpu().numpy()

    records, best_cache, stopped_at = [], None, None
    for epoch in range(start_epoch, args.epochs):
        t0 = time.perf_counter()
        stats = {}
        opt.zero_grad(set_to_none=True)
        loss = model.nlml(x, y, generator=gen, stats=stats) if has_cache else model.nlml(x, y)
        loss.backward()
        opt.step()
        loss = float(loss.detach())
        rec = {"epoch": epoch, "train/mll": -loss, "train/loss_ts": time.perf_counter() - t0}
        rec.update(hyp_summary(model))
        extra = {"cg_iters": stats["cg_iters"]} if has_cache else {}

        if ((epoch + 1) % args.log_int == 0 or epoch == args.epochs - 1) and not args.no_eval:
            t0 = time.perf_counter()
            cache, vm, vv = evaluate(ds.val_x)
            rec.update({f"val/{k}": v for k, v in regression_metrics(vm, vv, ds.val_y).items()})
            rec["val/pred_ts"] = time.perf_counter() - t0
            if has_cache:
                extra["val/cg_iters"] = cache["cg_iters"]
            if stopper.step(rec["val/rmse"], raw_cpu()):
                stopped_at = epoch
            if stopper.is_best:
                best_cache = cache
                save_params("model_best.pkl", stopper.best_state)
            torch.save({"raw": raw_cpu(), "opt": opt.state_dict(), "epoch": epoch, "generator": gen.get_state(),
                        "stopper": stopper.state_dict()}, ckpt_path)

        _emit(log_f, rec, extra)
        records.append({**rec, **extra})
        if stopped_at is not None:
            _emit(log_f, {"early_stop": epoch})
            break

    if stopper.best_state is not None:
        model.load_raw(stopper.best_state)
    final = {}
    if not args.no_eval:
        t0 = time.perf_counter()
        # The best epoch's val cache is the posterior at the best parameters.
        cache, tm, tv = evaluate(ds.test_x, best_cache)
        final = {f"test/{k}": v for k, v in regression_metrics(tm, tv, ds.test_y).items()}
        final["test/pred_ts"] = time.perf_counter() - t0
        _emit(log_f, final, {"test/cg_iters": cache["cg_iters"]} if has_cache else None)
    log_f.close()
    save_params("model_final.pkl", model.raw())
    return {"records": records, "final": final, "out_dir": str(out_dir), "early_stop": stopped_at}


if __name__ == "__main__":
    main()
