"""Solver configuration and the preconditioner builder of the BBMM engine.

Port of simplex_gp_tpu/linalg/mll.py::BBMMConfig and build_precond
(:52-156).  The marginal-likelihood engine itself (lattice_nlml and its
closed-form backward) belongs to the training path and is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .pivoted_cholesky import Preconditioner, make_preconditioner, pivoted_cholesky_features

__all__ = ["BBMMConfig", "build_precond"]


@dataclasses.dataclass(frozen=True)
class BBMMConfig:
    """Solver budget, mirroring the reference's gpytorch settings
    (train_simplexgp.py:34-37)."""

    cg_tolerance: float = 1.0
    max_cg_iterations: int = 500
    max_lanczos_iterations: int = 100
    # Pivoted-Cholesky preconditioner rank; 0 disables.  Clamped to n - 1.
    precond_rank: int = 100
    num_probes: int = 10


def build_precond(dk, config: BBMMConfig, params: dict, ref: torch.Tensor, n_global: int) -> Optional[Preconditioner]:
    """Rank-k pivoted-Cholesky preconditioner of K_hat from exact kernel columns.

    Returns None when disabled or when rank >= n (dense regime).
    """
    rank = min(config.precond_rank, n_global - 1)
    if rank <= 0:
        return None
    s, noise = params["outputscale"], params["noise"]
    diag = s * torch.ones(ref.shape[0], dtype=torch.float32, device=ref.device)
    pc = pivoted_cholesky_features(ref, diag, dk.nu, s, rank)
    return make_preconditioner(pc.L, noise, n_global)
