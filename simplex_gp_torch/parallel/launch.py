"""Start P ranks on this machine, run one function on each, and gather the results.

``launch(fn, nprocs, args)`` spawns ``nprocs`` processes (``torch.multiprocessing``,
the ``spawn`` start method), joins them into one process group through a
``file://`` rendezvous in a fresh temporary directory (no port to pick or
collide on), runs ``fn(axis, *args)`` on each with the group's
:class:`~simplex_gp_torch.parallel.comm.DataAxis`, and returns the ranks'
return values in rank order.  It raises if any rank raises (with that rank's
traceback) or if ``timeout`` seconds pass, and then terminates every rank: a
rank that died leaves the others blocked in a collective, and the deadline
turns that hang into an error.  ``fn`` must be importable by name in a fresh
process (a module-level function), and its arguments and return value
picklable; return CPU tensors or numpy arrays.

For ranks on the card the kernel library is built here, before the spawn,
so the ranks load it instead of running nvcc P times.
"""

from __future__ import annotations

import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional

__all__ = ["launch"]


def _rank_main(fn, rank, nprocs, backend, init_method, device, args, threads, results):
    import torch
    import torch.distributed as dist

    from .distributed import initialize_distributed
    from .mesh import make_mesh

    try:
        if threads is not None:
            torch.set_num_threads(threads)
        initialize_distributed(backend=backend, init_method=init_method, rank=rank, world_size=nprocs,
                               device=device)
        results.put((rank, True, fn(make_mesh(), *args)))
    except Exception:  # the parent reports it and stops the other ranks
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, nprocs: int, args: tuple = (), backend: Optional[str] = None,
           device: str = "cuda", timeout: float = 600.0, threads: Optional[int] = None) -> list:
    """Run ``fn(axis, *args)`` on ``nprocs`` ranks; their return values in rank order.

    ``backend`` defaults to NCCL on the card and gloo on the CPU
    (:func:`~simplex_gp_torch.parallel.distributed.initialize_distributed`);
    ranks on one card beyond the first need gloo.  ``threads`` sets each
    rank's torch intra-op threads.
    """
    import torch.multiprocessing as mp

    if device == "cuda":
        from ..kernels import build

        build.library()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="sgp_rendezvous_")
    init_method = "file://" + os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, nprocs, backend, init_method, device, args, threads, results))
             for r in range(nprocs)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        out = {}
        while len(out) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"launch: {nprocs - len(out)} of {nprocs} ranks still running after "
                                   f"{timeout:.0f} s (ranks done: {sorted(out)})")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(f"launch: rank(s) {dead} exited with codes "
                                       f"{[procs[r].exitcode for r in dead]} before reporting")
                continue
            if not ok:
                raise RuntimeError(f"launch: rank {rank} of {nprocs} raised:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return [out[r] for r in range(nprocs)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
