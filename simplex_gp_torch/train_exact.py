"""Dense exact-GP trainer: ``python -m simplex_gp_torch.train_exact``.

Port of experiments/train_exact.py: the Cholesky exact GP
(``models/exact_gp.py::DenseGP``, O(n^2) memory: cap the rows with
``--max-n``) trained by :func:`simplex_gp_torch.train.run_training`, with
the JAX trainer's flags and defaults (``--plan-capacity`` accepted and
unused).  Runs go to ``<--out>/exact_<dataset>_s<seed>/``.  The round-5
precipitation run (runs/r5/exact_precipitation_s0)::

    python -m simplex_gp_torch.train_exact --dataset precipitation --kernel matern --nu 1.5 \\
        --min-noise 0.1 --ls-init median --max-n 16384 --patience 30

``--device cuda`` (the default) is an error without a card.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from .models.exact_gp import DenseGP
from .train import add_common_args, add_device_arg, init_lengthscale, run_training
from .utils.data import load_dataset
from .utils.device import resolve_device

__all__ = ["main", "parse_args"]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m simplex_gp_torch.train_exact", description=__doc__.split("\n")[0])
    add_common_args(p)
    p.add_argument("--kernel", default="rbf", choices=["rbf", "matern"])
    p.add_argument("--nu", type=float, default=1.5)
    add_device_arg(p)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    ds = load_dataset(args.dataset, args.data_dir, args.max_n)
    model = DenseGP(num_dims=ds.train_x.shape[-1], kernel=args.kernel, nu=args.nu, min_noise=args.min_noise,
                    device=dev)
    init_lengthscale(model, args, ds)
    return run_training(model, ds, args, "exact")


if __name__ == "__main__":
    main()
