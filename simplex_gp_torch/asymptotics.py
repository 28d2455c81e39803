"""The filter's time against n and against d: ``python -m simplex_gp_torch.asymptotics``.

Port of experiments/asymptotics.py, the measurement behind the reference's
log-log fits (notebooks/asymptotics.ipynb; SURVEY.md section 6: the MVM
about linear in n and a low-order polynomial in d).  It times the one-shot
filter ``filter_once`` (K4 on the card; rbf taps of ``--order``) on seeded
standard-normal positions and one column, over ``--ns`` at ``--fixed-d`` and
over ``--ds`` at ``--fixed-n``, and prints one JSON line with JAX's keys:
the sizes, the times in ms and the fitted exponents ``exponent_n`` and
``exponent_d`` (the slopes of log time on log size).  Each time is the
median of ``--reps`` calls after one warm-up, by CUDA events on a card and
by the host clock on the CPU; the TPU timing workaround of the JAX script
(its sync floor) is not ported.  ``--device`` has no fallback: ``cuda`` (the
default) without a card is an error.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch

from .mvm_err import _seconds
from .ops.kernels import rbf_kernel
from .ops.lattice import filter_once
from .utils.device import resolve_device

__all__ = ["main"]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m simplex_gp_torch.asymptotics", description=__doc__.split("\n")[0])
    p.add_argument("--order", type=int, default=1)
    p.add_argument("--ns", type=int, nargs="*", default=[2000, 4000, 8000, 16000, 32000])
    p.add_argument("--ds", type=int, nargs="*", default=[2, 4, 8, 12, 16])
    p.add_argument("--fixed-n", type=int, default=8000)
    p.add_argument("--fixed-d", type=int, default=8)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--device", default="cuda", help="cuda (default; an error without a card) or cpu")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Time, fit, print one JSON line and return it as a dict."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    dk = rbf_kernel(args.order)
    rng = np.random.default_rng(0)

    def time_filter(n: int, d: int) -> float:
        x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dev)
        v = torch.from_numpy(rng.normal(size=(n, 1)).astype(np.float32)).to(dev)
        with torch.no_grad():
            return max(_seconds(lambda: filter_once(v, x, dk.coeffs, dk.variance), args.reps, dev), 1e-6)

    t_n = [time_filter(n, args.fixed_d) for n in args.ns]
    t_d = [time_filter(args.fixed_n, d) for d in args.ds]
    record = {
        "order": args.order,
        "ns": args.ns,
        "t_n_ms": [round(t * 1e3, 2) for t in t_n],
        "ds": args.ds,
        "t_d_ms": [round(t * 1e3, 2) for t in t_d],
        "exponent_n": round(float(np.polyfit(np.log(args.ns), np.log(t_n), 1)[0]), 3),
        "exponent_d": round(float(np.polyfit(np.log(args.ds), np.log(t_d), 1)[0]), 3),
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
