"""SGPR trainer: ``python -m simplex_gp_torch.train_sgpr``.

Port of experiments/train_sgpr.py: the sparse GP with ``--num-inducing``
inducing points (models/sgpr.py), drawn from the training rows with the
seed and trained with the kernel's parameters, by
:func:`simplex_gp_torch.train.run_training`, with the JAX trainer's flags
and defaults (``--plan-capacity`` accepted and unused).  The draw uses
torch's generator, so the rows differ from JAX's.  Runs go to
``<--out>/sgpr_<dataset>_s<seed>/``; the model files hold ``inducing``
beside the raw parameters, as JAX's do.  The round-5 precipitation run
(runs/r5/sgpr_precipitation_s0)::

    python -m simplex_gp_torch.train_sgpr --dataset precipitation --kernel matern --nu 1.5 \\
        --min-noise 0.1 --ls-init median --max-n 65536

``--device cuda`` (the default) is an error without a card.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from .models.sgpr import SGPR
from .train import add_common_args, add_device_arg, init_lengthscale, run_training
from .utils.data import load_dataset
from .utils.device import resolve_device

__all__ = ["main", "parse_args"]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m simplex_gp_torch.train_sgpr", description=__doc__.split("\n")[0])
    add_common_args(p)
    p.add_argument("--kernel", default="rbf", choices=["rbf", "matern"])
    p.add_argument("--nu", type=float, default=1.5)
    p.add_argument("--num-inducing", type=int, default=512)
    add_device_arg(p)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    ds = load_dataset(args.dataset, args.data_dir, args.max_n)
    model = SGPR(num_dims=ds.train_x.shape[-1], num_inducing=args.num_inducing, kernel=args.kernel, nu=args.nu,
                 min_noise=args.min_noise, device=dev)
    model.init_inducing(torch.from_numpy(ds.train_x).to(dev), seed=args.seed)
    init_lengthscale(model, args, ds)
    return run_training(model, ds, args, "sgpr")


if __name__ == "__main__":
    main()
