"""The data axis of the sharded engine: a process group and its collectives.

The port's stand-in for JAX's ``axis_name`` inside ``shard_map``.  A
:class:`DataAxis` holds a ``torch.distributed`` process group, this process's
``rank`` in it and its ``size``, and the collectives the data-parallel
engine uses, each over the group:

  * :meth:`psum` (all_reduce sum) and :meth:`pmax` (all_reduce max);
  * :meth:`all_gather`, tiled along dim 0 (JAX's ``all_gather(tiled=True)``);
  * :meth:`psum_scatter` of a ``(P, ...)`` block buffer over its leading
    dimension (``reduce_scatter``): rank r receives the sum of every rank's
    block r;
  * :meth:`all_gather_blocks`, the inverse layout: ``(P, ...)`` with rank r's
    tensor in block r;
  * :meth:`broadcast` from the group's first rank.

Every rank must call each collective in the same order.  A result is the same
bits on every rank (NCCL and gloo both reduce each element once and send the
result to all), which is what keeps the CG's host-side stop decisions in
step across ranks.

NCCL takes CUDA tensors; gloo takes CPU tensors and, for CUDA tensors, this
class stages them through host memory (a copy to the host, the collective,
a copy back), which is how gloo moves device data in any case.  Two ranks
can share one card only over gloo: NCCL refuses two ranks on one device.

Set ``timing = True`` to count the collectives' calls, bytes and host-clock
seconds in ``stats`` (each timed call synchronises the device first, so the
time is the transport's alone); it is off by default and then costs nothing.
``axis=None`` everywhere in the package means one process with no group.
"""

from __future__ import annotations

import time
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["DataAxis"]


class DataAxis:
    """One data axis: ``group`` (None: the default group), ``rank`` and ``size`` in it."""

    def __init__(self, group=None):
        if not dist.is_initialized():
            raise RuntimeError("DataAxis needs an initialized process group (initialize_distributed)")
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        self._root = 0 if group is None else dist.get_global_rank(group, 0)
        self.timing = False
        self.stats = {"calls": 0, "bytes": 0, "seconds": 0.0}

    def __repr__(self) -> str:
        return f"DataAxis(rank={self.rank}, size={self.size}, backend={self.backend!r})"

    @property
    def transport(self) -> str:
        """How a CUDA tensor travels: ``nccl``, or ``gloo via host memory``."""
        return "nccl" if self.backend == "nccl" else f"{self.backend} via host memory"

    def n_global(self, n_local: int) -> int:
        """Rows over all ranks: the shards are equal (:func:`shard_batch`), so n_local * size."""
        return n_local * self.size

    def reset_stats(self) -> None:
        self.stats = {"calls": 0, "bytes": 0, "seconds": 0.0}

    def _run(self, op, out: torch.Tensor, inp: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``op(out)`` in place, or ``op(out, inp)``, over the group; gloo stages CUDA tensors on the host."""
        t0 = None
        if self.timing:
            if out.is_cuda:
                torch.cuda.synchronize(out.device)
            t0 = time.perf_counter()
        if out.is_cuda and self.backend != "nccl":
            host = (out.cpu(),) if inp is None else (torch.empty(out.shape, dtype=out.dtype), inp.cpu())
            op(*host)
            out.copy_(host[0])
        else:
            op(*((out,) if inp is None else (out, inp)))
        if t0 is not None:
            if out.is_cuda:
                torch.cuda.synchronize(out.device)
            self.stats["calls"] += 1
            self.stats["bytes"] += out.numel() * out.element_size()
            self.stats["seconds"] += time.perf_counter() - t0
        return out

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of ``t`` over the ranks (a new tensor)."""
        out = t.detach().clone()
        return self._run(lambda o: dist.all_reduce(o, op=dist.ReduceOp.SUM, group=self.group), out)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise maximum of ``t`` over the ranks (a new tensor)."""
        out = t.detach().clone()
        return self._run(lambda o: dist.all_reduce(o, op=dist.ReduceOp.MAX, group=self.group), out)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along dim 0 in rank order."""
        return self.all_gather_blocks(t).reshape(self.size * t.shape[0], *t.shape[1:])

    def all_gather_blocks(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked into a ``(size, *t.shape)`` block buffer, rank r in block r."""
        flat = t.detach().contiguous().reshape(-1)
        out = torch.empty(self.size * flat.numel(), dtype=t.dtype, device=t.device)
        return self._run(lambda o, i: dist.all_gather_into_tensor(o, i, group=self.group), out,
                         flat).reshape(self.size, *t.shape)

    def psum_scatter(self, blocks: torch.Tensor) -> torch.Tensor:
        """Block ``rank`` of the sum over ranks of a ``(size, ...)`` block buffer."""
        if blocks.shape[0] != self.size:
            raise ValueError(f"psum_scatter: {blocks.shape[0]} blocks for {self.size} ranks")
        flat = blocks.detach().contiguous().reshape(-1)
        out = torch.empty(flat.numel() // self.size, dtype=blocks.dtype, device=blocks.device)
        return self._run(lambda o, i: dist.reduce_scatter_tensor(o, i, op=dist.ReduceOp.SUM, group=self.group),
                         out, flat).reshape(blocks.shape[1:])

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Overwrite ``t`` in place with the group's first rank's value; returns ``t``."""
        return self._run(lambda o: dist.broadcast(o, src=self._root, group=self.group), t)

