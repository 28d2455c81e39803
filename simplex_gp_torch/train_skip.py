"""SKIP trainer: ``python -m simplex_gp_torch.train_skip``.

Port of experiments/train_skip.py: the product-structure KISS-GP baseline
(models/ski.py; per-dimension grid of ``--grid-size`` points, root of rank
``--rank``) trained by :func:`simplex_gp_torch.train.run_training`, with
the flags and defaults of the JAX trainer (``--plan-capacity`` is accepted
and unused, as there).  Runs go to ``<--out>/skip_<dataset>_s<seed>/``.
The round-5 precipitation run (runs/r5/skip_precipitation_s0)::

    python -m simplex_gp_torch.train_skip --dataset precipitation --kernel matern --nu 1.5 \\
        --min-noise 0.1 --ls-init median --max-n 65536

``--device cuda`` (the default) is an error without a card.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from .models.ski import SKIP
from .train import add_common_args, add_device_arg, init_lengthscale, run_training
from .utils.data import load_dataset
from .utils.device import resolve_device

__all__ = ["main", "parse_args"]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m simplex_gp_torch.train_skip", description=__doc__.split("\n")[0])
    add_common_args(p)
    p.add_argument("--kernel", default="rbf", choices=["rbf", "matern"])
    p.add_argument("--nu", type=float, default=1.5)
    p.add_argument("--grid-size", type=int, default=100)
    p.add_argument("--rank", type=int, default=64)
    add_device_arg(p)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    ds = load_dataset(args.dataset, args.data_dir, args.max_n)
    model = SKIP(num_dims=ds.train_x.shape[-1], grid_size=args.grid_size, rank=args.rank, kernel=args.kernel,
                 nu=args.nu, min_noise=args.min_noise, device=dev)
    init_lengthscale(model, args, ds)
    return run_training(model, ds, args, "skip")


if __name__ == "__main__":
    main()
