"""Process-group set-up for the data-parallel engine, on ``torch.distributed``.

Port of simplex_gp_tpu/parallel/distributed.py (:38-109).  Every rank runs
the same program; :func:`initialize_distributed` joins the group, and a
:class:`~simplex_gp_torch.parallel.comm.DataAxis` over it
(:func:`~simplex_gp_torch.parallel.mesh.make_mesh`) carries the sharded
engine's collectives.  Each rank holds its own rows of the data
(:func:`host_local_batch`).

Launchers: ``torchrun`` sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``, which are read when the arguments are not
given; :func:`simplex_gp_torch.parallel.launch.launch` passes them itself,
with a ``file://`` rendezvous.  The default backend is NCCL for ranks on the
card and gloo on the CPU; two ranks that share one card need gloo.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["initialize_distributed", "is_distributed", "local_device", "host_local_batch"]

_DEVICE = {"type": "cuda"}


def initialize_distributed(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    device: str = "cuda",
) -> bool:
    """Join the process group (idempotent); True once a group is up.

    ``rank`` / ``world_size`` default to ``RANK`` / ``WORLD_SIZE``, and
    ``init_method`` to ``env://`` when ``MASTER_ADDR`` is set.  With none of
    them (no launcher), it does nothing and returns False, as JAX's does
    (distributed.py:71-72): a plain single-process run.  ``device`` is where
    this rank's tensors live, ``cuda`` (the card ``LOCAL_RANK`` modulo the
    card count; NCCL by default) or ``cpu`` (gloo by default).  There is no
    fallback: ``cuda`` without a card raises.  A group of world size 1 (as
    ``torchrun --nproc-per-node 1`` gives) counts as up.
    """
    if dist.is_initialized():
        return True
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if init_method is None and "MASTER_ADDR" in os.environ:
        init_method = "env://"
    if init_method is None:
        return False  # single-process run
    if rank is None or world_size is None:
        raise ValueError("initialize_distributed: a rendezvous without RANK / WORLD_SIZE (or rank=, world_size=)")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"initialize_distributed: device {device!r} (cuda or cpu)")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed: device cuda, but torch.cuda.is_available() is false")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count())
    _DEVICE["type"] = device
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)
    return True


def is_distributed() -> bool:
    """True when a process group of more than one rank is up (JAX: process_count() > 1)."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def local_device() -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK % device_count``, or ``cpu`` for a CPU group."""
    if _DEVICE["type"] == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("local_device: torch.cuda.is_available() is false")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def host_local_batch(*arrays, device=None):
    """This rank's rows, as tensors on ``device`` (default :func:`local_device`).

    The counterpart of JAX's host_local_batch (:94): each process passes only
    its own rows, and they stay its shard, so no mesh is needed; the result
    equals :func:`~simplex_gp_torch.parallel.mesh.shard_batch` of the
    concatenated rows.  Every rank must pass the same number of rows.
    """
    device = local_device() if device is None else device
    out = [torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a).to(device) for a in arrays]
    return out[0] if len(out) == 1 else tuple(out)
