"""Batched Lanczos tridiagonalization and stochastic Lanczos quadrature.

Port of simplex_gp_tpu/linalg/lanczos.py: every probe runs
its Lanczos recurrence at once as one (n, p) block, with CGS2 full
reorthogonalization and the breakdown freeze of the JAX package.  The
quadrature of the small tridiagonals, e1^T log(T) e1 with the eigenvalues
clamped at 1e-10, is K14 (``kernels/slq.py``): on a card one launch on the
band or on the CG record itself, on the CPU batched float32
``torch.linalg.eigh`` of the dense (p, m, m) T, as JAX computes it.
``logdet_from_cg_tridiag`` reads the
tridiagonals that ``cg_solve(..., tridiag_m=m)`` records, which is the
training path's log-det (slq_mode "cg").  With ``axis`` (a DataAxis) the
rows are sharded: every reduction over n is an all-reduce (lanczos.py:50-51,
:134-135), so the recurrence's scalars are the same on every rank.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .. import trace
from ..kernels.slq import slq_quadrature, slq_quadrature_cg

__all__ = [
    "LanczosResult",
    "lanczos",
    "tridiag_matrices",
    "slq_logdet",
    "logdet_from_cg_tridiag",
    "lanczos_root",
]


class LanczosResult(NamedTuple):
    alphas: torch.Tensor  # (p, m) tridiagonal diagonal
    betas: torch.Tensor  # (p, m-1) off-diagonal
    vecs: torch.Tensor  # (m, n, p) Lanczos basis (per probe)


def lanczos(
    matmul: Callable[[torch.Tensor], torch.Tensor],
    z: torch.Tensor,
    num_iters: int,
    reorthogonalize: bool = True,
    axis=None,
) -> LanczosResult:
    """Run ``num_iters`` Lanczos steps for every column of z (n, p) at once (lanczos.py:32)."""
    n, p = z.shape
    m = num_iters
    z = z.to(torch.float32)

    def rowsum(t):  # a sum over the (sharded) rows
        return t if axis is None else axis.psum(t)

    q = z / torch.sqrt(rowsum((z * z).sum(dim=0, keepdim=True)))
    q_prev = torch.zeros_like(q)
    beta_prev = torch.zeros(p, dtype=torch.float32, device=z.device)
    alive = torch.ones(p, dtype=torch.bool, device=z.device)
    basis = torch.zeros((m, n, p), dtype=torch.float32, device=z.device)
    alphas, betas = [], []
    for i in range(m):
        aq = matmul(q)
        alpha = rowsum((q * aq).sum(dim=0))
        r = aq - alpha * q - beta_prev * q_prev
        if reorthogonalize:
            # CGS2: r <- r - V (V^T r), twice (lanczos.py:61-68).
            for _ in range(2):
                coeff = rowsum(torch.einsum("mnp,np->mp", basis, r))
                r = r - torch.einsum("mnp,mp->np", basis, coeff)
        beta = torch.sqrt(rowsum((r * r).sum(dim=0)))
        # Breakdown freeze: a column whose Krylov space is exhausted records
        # alpha 1 / beta 0 from there on (lanczos.py:70-82).
        aq_norm = torch.sqrt(rowsum((aq * aq).sum(dim=0)))
        alive_next = alive & (beta > 1e-3 * torch.clamp(aq_norm, min=1e-30))
        alphas.append(torch.where(alive, alpha, 1.0))
        beta_rec = torch.where(alive_next, beta, 0.0)
        betas.append(beta_rec)
        q_next = torch.where(alive_next, r / torch.where(beta == 0, 1.0, beta), 0.0)
        basis[i] = torch.where(alive, q, 0.0)
        q_prev, q, beta_prev, alive = q, q_next, beta_rec, alive_next
    return LanczosResult(
        alphas=torch.stack(alphas, dim=1),  # (p, m)
        betas=torch.stack(betas, dim=1)[:, : m - 1],
        vecs=basis,
    )


def tridiag_matrices(alphas: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """Assemble (p, m, m) tridiagonal matrices from Lanczos coefficients (lanczos.py:101)."""
    return torch.diag_embed(alphas) + torch.diag_embed(betas, offset=1) + torch.diag_embed(betas, offset=-1)


def slq_logdet(
    matmul: Callable[[torch.Tensor], torch.Tensor],
    z: torch.Tensor,
    num_iters: int = 100,
    axis=None,
) -> torch.Tensor:
    """Stochastic Lanczos quadrature estimate of log|A| from probes z (n, p) (lanczos.py:113)."""
    with trace.span("slq"):
        res = lanczos(matmul, z, num_iters, axis=axis)
        quad = slq_quadrature(res.alphas, res.betas)
        z_norm2 = (z * z).sum(dim=0)
        return ((z_norm2 if axis is None else axis.psum(z_norm2)) * quad).mean()


def logdet_from_cg_tridiag(
    alphas: torch.Tensor,
    betas: torch.Tensor,
    tmask: torch.Tensor,
    z_norm2: torch.Tensor,
) -> torch.Tensor:
    """SLQ log-det estimate from CG's recorded (m, p) coefficients (lanczos.py:139).

    T[k,k] = 1/alpha_k + beta_{k-1}/alpha_{k-1}, T[k,k+1] = sqrt(beta_k)/alpha_k
    on live steps; dead steps (tmask False) pad T with a decoupled identity,
    whose quadrature weight is zero.  Add log|P| for log|K_hat| when the CG
    was preconditioned.
    """
    with trace.span("slq"):
        return (z_norm2 * slq_quadrature_cg(alphas, betas, tmask)).mean()


def lanczos_root(
    matmul: Callable[[torch.Tensor], torch.Tensor],
    z: torch.Tensor,
    num_iters: int,
):
    """(Q (n, m), T (m, m)): a rank-m A ~= Q T Q^T from a single probe z (n, 1) (lanczos.py:184)."""
    res = lanczos(matmul, z, num_iters)
    Q = res.vecs[:, :, 0].T
    T = tridiag_matrices(res.alphas[:1], res.betas[:1])[0]
    return Q, T
