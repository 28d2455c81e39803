"""Data-parallel scaling: sharded filter MVMs/s and NLML steps/s against the number of ranks.

The counterpart of experiments/scaling.py.  For each P of the doubling
ladder 1, 2, 4, ... up to the group's size, on the first P ranks, it times

  * the full sharded filter: the plan build (K1, the all-gather of the
    hashes, K11a) and one apply (K11b) of a (n, cols) block;
  * one data-parallel NLML loss and gradient (``data_parallel_loss_fn``);

and prints one JSON record per P with experiments/scaling.py's keys, plus
the backend and the measured transport time of one filter (``comm_ms``:
the collectives' host-clock time with the device synchronised around each;
the rest of ``filter_full_ms`` is the kernels and the host).  Times are
CUDA events on the card (the slowest rank's), the host clock on the CPU,
after one warm-up call.

    torchrun --nproc-per-node P -m simplex_gp_torch.scaling --rows 16384 -d 3 --cols 8

Without a launcher it runs one rank itself.  ``--device cuda`` is the
default (NCCL; an error without a card), ``--device cpu`` runs gloo on the
CPU.  One card holds one NCCL rank: two ranks on one card need gloo
(``--backend gloo``), and then the transport goes through host memory.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

__all__ = ["records", "main"]


def _timer(device: torch.device):
    """``ms(fn, reps)``: mean milliseconds per call after one warm-up, by CUDA events on a card."""

    def ms(fn, reps: int) -> float:
        fn()
        if device.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            return 1e3 * (time.perf_counter() - t0) / reps
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / reps

    return ms


def _one_size(ax, args, device) -> dict:
    """The record of one axis size (every rank of ``ax`` runs it; the values are the slowest rank's)."""
    from .linalg.mll import BBMMConfig
    from .models.exact_gp import SimplexGP
    from .ops.kernels import rbf_kernel
    from .ops.lattice import apply_plan_join
    from .parallel import build_plan_sharded_join, data_parallel_loss_fn, replicate, shard_batch

    size = ax.size
    n = args.rows * (size if args.weak else 1)
    n = (n // size) * size
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, args.dim)).astype(np.float32)
    v = rng.normal(size=(n, args.cols)).astype(np.float32)
    y = rng.normal(size=(n,)).astype(np.float32)
    x_loc, v_loc, y_loc = shard_batch(ax, x, v, y, device=device)
    dk = rbf_kernel(args.order)
    ms = _timer(device)

    def full():
        plan = build_plan_sharded_join(x_loc, dk.coeffs, dk.variance, ax)
        return apply_plan_join(plan, v_loc, dk.coeffs, axis=ax)

    n_lattice = int(build_plan_sharded_join(x_loc, dk.coeffs, dk.variance, ax).n_lattice)
    t_full = ms(full, args.reps)
    ax.timing = True
    ax.reset_stats()
    full()
    comm_s, comm_calls = ax.stats["seconds"], ax.stats["calls"]
    ax.timing = False

    model = SimplexGP(num_dims=args.dim, kernel="rbf", order=args.order, device=device,
                      bbmm=BBMMConfig(cg_tolerance=1.0, max_cg_iterations=100, max_lanczos_iterations=30,
                                      num_probes=8))
    replicate(ax, model)
    step = data_parallel_loss_fn(model, ax)
    t_step = ms(lambda: step(x_loc, y_loc, seed=0), max(2, args.reps // 2))
    slowest = ax.pmax(torch.tensor([t_full, t_step, 1e3 * comm_s], dtype=torch.float64, device=device)).tolist()
    t_full, t_step, comm_ms = slowest
    cpad = -(-args.cols // size) * size
    return {
        "devices": size,
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "backend": ax.backend,
        "transport": ax.transport if device.type == "cuda" else ax.backend,
        "n": n,
        "d": args.dim,
        "cols": args.cols,
        "mode": "weak" if args.weak else "strong",
        # Per apply each rank sends (P-1)/P of the (n_lattice, c_pad) table of
        # the live rows in the reduce-scatter and receives as much in the
        # all-gather; the plan build gathers the 8-byte hash pair of every vertex.
        "comm_table_bytes": n_lattice * cpad * 4,
        "comm_per_device_bytes_per_mvm": int(2 * n_lattice * cpad * 4 * (size - 1) / size),
        "comm_plan_build_bytes": n * (args.dim + 1) * 8,
        "filter_full_ms": t_full,
        "filter_mvm_per_s": 1e3 / t_full,
        "comm_ms": comm_ms,
        "comm_calls": comm_calls,
        "nlml_step_ms": t_step,
        "nlml_step_per_s": 1e3 / t_step,
    }


def records(axis, argv: list) -> list:
    """The ladder's records, on every rank of ``axis`` (a rank outside a size's subgroup waits)."""
    from .parallel import make_mesh
    from .parallel.distributed import local_device

    args = _parser().parse_args(argv)
    device = local_device()
    out, base = [], None
    size = 1
    while size <= axis.size:
        ax = axis if size == axis.size else make_mesh(size)
        if ax is not None:
            rec = _one_size(ax, args, device)
            base = base or rec
            if base["devices"] == 1:  # the ranks past the first hold no one-rank record
                rec["mvm_speedup_vs_1dev"] = base["filter_full_ms"] / rec["filter_full_ms"]
                rec["mvm_parallel_efficiency"] = rec["mvm_speedup_vs_1dev"] / (1 if args.weak else size)
                rec["step_speedup_vs_1dev"] = base["nlml_step_ms"] / rec["nlml_step_ms"]
            out.append(rec)
        axis.psum(torch.zeros(1, device=device))  # the ranks outside wait here
        size *= 2
    return out


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m simplex_gp_torch.scaling", description=__doc__.split("\n")[0])
    # experiments/scaling.py's --n; torchrun would read --n as an abbreviation of its own options.
    p.add_argument("--rows", type=int, default=16384, help="global data size (the records' n)")
    p.add_argument("-d", "--dim", type=int, default=3)
    p.add_argument("--order", type=int, default=1)
    p.add_argument("--cols", type=int, default=8, help="value columns per MVM")
    p.add_argument("--weak", action="store_true", help="weak scaling: --rows rows per rank instead of global")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--backend", default=None, help="nccl (the default on the card) or gloo")
    p.add_argument("--out", default=None, help="append the JSON records to this file as well")
    return p


def main(argv=None) -> list:
    import sys

    from .parallel import initialize_distributed, launch, make_mesh

    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    joined = not torch.distributed.is_initialized()  # a group this call joins, it also leaves
    if initialize_distributed(backend=args.backend, device=args.device):
        try:
            recs = records(make_mesh(), argv)
            rank0 = torch.distributed.get_rank() == 0
        finally:
            if joined:
                torch.distributed.destroy_process_group()
    else:  # no launcher: one rank of our own
        recs, rank0 = launch(records, 1, (argv,), backend=args.backend, device=args.device, timeout=3600)[0], True
    if rank0:
        for rec in recs:
            print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.writelines(json.dumps(rec) + "\n" for rec in recs)
    return recs


if __name__ == "__main__":
    main()
