"""The data axis, data sharding and data-parallel GP training.

Port of simplex_gp_tpu/parallel/mesh.py (:33-93) to ``torch.distributed``.
The parallel axis of the workload is the data axis n of the kernel MVM and
the CG: x, y, the probes and every CG / Lanczos vector hold each rank's
rows; the splat's partial lattice tables are reduce-scattered by column
blocks, blurred a block per rank and all-gathered back
(parallel/shard_filter.py, the sharded sort chain); the CG, Lanczos and NLML
reductions over n are all-reduces.  JAX runs this inside ``shard_map``;
here every rank runs the same eager program on its own rows.

``gspmd_loss_fn`` (XLA's partitioner over the single-device program) has no
counterpart and is not ported (ROADMAP "Not to port").
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .comm import DataAxis
from .distributed import local_device

__all__ = ["make_mesh", "shard_batch", "replicate", "data_parallel_loss_fn"]


def make_mesh(n: Optional[int] = None) -> Optional[DataAxis]:
    """The :class:`DataAxis` of the whole group, or of a subgroup of its first ``n`` ranks.

    Every rank must call it (a subgroup is made collectively); a rank outside
    the first ``n`` gets None.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group (initialize_distributed first)")
    world = dist.get_world_size()
    if n is None or n == world:
        return DataAxis()
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh: {n} ranks of a group of {world}")
    group = dist.new_group(ranks=list(range(n)))
    return DataAxis(group) if dist.get_rank() < n else None


def shard_batch(axis: DataAxis, *arrays, remainder: str = "truncate", device=None):
    """This rank's rows of arrays whose leading axis is the data axis, as tensors on ``device``.

    The leading axis is cut to a multiple of the axis size: the remainder
    rows are dropped (``remainder="truncate"``), never zero-padded, which
    would add fake data points to the GP (mesh.py:41-59); ``"error"``
    requires exact divisibility.  Rank r takes the r-th contiguous block.
    ``device`` defaults to :func:`~simplex_gp_torch.parallel.distributed.local_device`.
    """
    if remainder not in ("truncate", "error"):
        raise ValueError(f"shard_batch: remainder {remainder!r} (truncate or error)")
    n = min(a.shape[0] for a in arrays)
    n_loc = n // axis.size
    if n_loc * axis.size != n and remainder == "error":
        raise ValueError(f"leading axis {n} not divisible by the axis size {axis.size}")
    device = local_device() if device is None else device
    lo = axis.rank * n_loc
    out = [torch.as_tensor(a[lo:lo + n_loc]).to(device) for a in arrays]
    return out[0] if len(out) == 1 else tuple(out)


@torch.no_grad()
def replicate(axis: DataAxis, module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast the module's parameters from the axis's first rank, in place."""
    for p in module.parameters():
        axis.broadcast(p.data)
    return module


def data_parallel_loss_fn(model, axis: DataAxis):
    """``fn(x_local, y_local, seed=0, probes=None, stats=None) -> (loss, grads)`` over ``axis``.

    Each rank passes its own rows.  The loss is already global (the engine
    all-reduces it); each rank's parameter gradients are partial sums over
    its rows and get one all-reduce at the end (mesh.py:77-84), after which
    they are the same bits on every rank.  They are written into the
    parameters' ``.grad``, so an optimizer step follows directly, and
    returned by name.  Without ``probes`` each rank draws its own from
    (``seed``, rank) (``SimplexGP.nlml``).
    """

    def fn(x_local, y_local, seed: int = 0, probes: Optional[torch.Tensor] = None,
           stats: Optional[dict] = None):
        model.zero_grad(set_to_none=True)
        loss = model.nlml(x_local, y_local, probes=probes, stats=stats, axis=axis, seed=seed)
        loss.backward()
        named = list(model.named_parameters())
        flat = axis.psum(torch.cat([p.grad.reshape(-1) for _, p in named]))
        grads, k = {}, 0
        for name, p in named:
            p.grad = flat[k:k + p.numel()].reshape(p.shape).clone()
            grads[name] = p.grad
            k += p.numel()
        return loss.detach(), grads

    return fn
