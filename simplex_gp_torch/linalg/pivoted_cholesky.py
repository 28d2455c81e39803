"""Partial pivoted Cholesky preconditioner for preconditioned CG.

Port of simplex_gp_tpu/linalg/pivoted_cholesky.py for one device: the factor
is built from exact kernel columns, s * k(||ref_i - ref_piv||^2), one pivot
at a time by K6 (:mod:`simplex_gp_torch.kernels.pivot`).  The k x k
eigendecompositions and the (n, k) products stay torch.linalg / torch.matmul,
as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.pivot import pivot_column

__all__ = [
    "PivotedCholesky",
    "pivoted_cholesky_features",
    "Preconditioner",
    "make_preconditioner",
    "precond_solve",
    "precond_inv_sqrt",
    "precond_sqrt",
]


class PivotedCholesky(NamedTuple):
    L: torch.Tensor  # (n, k) partial Cholesky factor of K (without noise)
    pivots: torch.Tensor  # (k,) int64 chosen pivot indices


def pivoted_cholesky_features(
    ref: torch.Tensor,
    diag: torch.Tensor,
    nu: float,
    outputscale: torch.Tensor,
    rank: int,
) -> PivotedCholesky:
    """Pivoted Cholesky of ``outputscale * k(d2(ref, ref))``.

    Args:
      ref: (n, d) feature rows (inputs already divided by lengthscales).
      diag: (n,) kernel diagonal (= outputscale for these kernels).
      nu: 0.0 for rbf, else the Matern smoothness.
      outputscale: 0-d tensor s.
      rank: number of pivots.

    A pivot whose residual diagonal is at most 1e-6 of the largest initial
    diagonal gets a zero column (the relative threshold of the JAX package).
    """
    n = ref.shape[0]
    ref = ref.to(torch.float32).contiguous()
    L = torch.zeros((n, rank), dtype=torch.float32, device=ref.device)
    pivots = torch.zeros(rank, dtype=torch.int64, device=ref.device)
    d = diag.to(torch.float32).contiguous()
    d0_max = d.max()
    s = outputscale.to(torch.float32).reshape(())
    for j in range(rank):
        d = pivot_column(ref, L, d, torch.argmax(d), j, s, d0_max, nu, pivots)
    return PivotedCholesky(L=L, pivots=pivots)


class Preconditioner(NamedTuple):
    """P = U diag(s2) U^T + noise I with U^T U ~= I; see the JAX class.

    ``gamma`` = lambda_max(U^T U) >= 1 divides every U-term, which keeps the
    applied operator SPD despite the f32 orthonormality defect of U.
    """

    U: torch.Tensor  # (n, k) near-orthonormal columns
    s2: torch.Tensor  # (k,) eigenvalues of L L^T
    noise: torch.Tensor  # ()
    logdet: torch.Tensor  # () log|P|
    gamma: torch.Tensor  # () SPD guard


def make_preconditioner(L: torch.Tensor, noise: torch.Tensor, n_global: int) -> Preconditioner:
    """Diagonalize L L^T + noise I: one k x k eigh, a Newton-Schulz polish, gamma."""
    s2, V = torch.linalg.eigh(L.T @ L)
    s2 = torch.clamp(s2, min=0.0)
    denom = torch.sqrt(torch.clamp(s2, min=1e-12))
    U = L @ (V / denom[None, :])
    G2 = U.T @ U
    k = G2.shape[0]
    U = U @ (1.5 * torch.eye(k, dtype=U.dtype, device=U.device) - 0.5 * G2)
    gamma = torch.clamp(torch.linalg.eigvalsh(U.T @ U)[-1], min=1.0)
    logdet = torch.log1p(s2 / noise).sum() + n_global * torch.log(noise)
    return Preconditioner(U=U, s2=s2, noise=noise, logdet=logdet, gamma=gamma)


def precond_solve(P: Preconditioner, V: torch.Tensor) -> torch.Tensor:
    """P^{-1} V via Woodbury in the eigenbasis, U-term divided by gamma: O(n k t)."""
    w = P.s2 / (P.noise * (P.noise + P.s2)) / P.gamma
    return V / P.noise - P.U @ (w[:, None] * (P.U.T @ V))


def precond_inv_sqrt(P: Preconditioner, V: torch.Tensor) -> torch.Tensor:
    """P^{-1/2} V = noise^{-1/2} V + U ((noise+s2)^{-1/2} - noise^{-1/2}) / gamma U^T V."""
    w = (torch.rsqrt(P.noise + P.s2) - torch.rsqrt(P.noise)) / P.gamma
    return V * torch.rsqrt(P.noise) + P.U @ (w[:, None] * (P.U.T @ V))


def precond_sqrt(P: Preconditioner, V: torch.Tensor) -> torch.Tensor:
    """P^{1/2} V = noise^{1/2} V + U (sqrt(noise+s2) - sqrt(noise)) / gamma U^T V."""
    w = (torch.sqrt(P.noise + P.s2) - torch.sqrt(P.noise)) / P.gamma
    return V * torch.sqrt(P.noise) + P.U @ (w[:, None] * (P.U.T @ V))
