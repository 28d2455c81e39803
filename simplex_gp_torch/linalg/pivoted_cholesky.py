"""Partial pivoted Cholesky preconditioner for preconditioned CG.

Port of simplex_gp_tpu/linalg/pivoted_cholesky.py: the factor is built from
exact kernel columns, s * k(||ref_i - ref_piv||^2), one pivot at a time by
K6 (:mod:`simplex_gp_torch.kernels.pivot`).  The k x k eigendecompositions
and the (n, k) products stay torch.linalg / torch.matmul, as the JAX package
leaves them to XLA.

With ``axis`` (a DataAxis) the rows are sharded (JAX's ``axis_name``,
:129-140, :168-169, :219, :235-238): each pivot all-gathers one candidate
per rank, (its local largest residual diagonal, that row of ref, that row
of L), every rank takes the first largest in rank order -- the global
argmax, ties to the lowest global index as on one device -- and K6 writes
the column against the winner's rows (K6'), without a read back to the
host.  The initial maximum is a pmax, the Gram matrices L^T L and U^T U and
every U^T V are all-reduces, and each rank keeps its own rows of L and U.

:func:`pivoted_cholesky` is JAX's generic column-oracle form (:56-103), for
operators without feature structure and as the tests' oracle;
:func:`woodbury_solve` and :func:`woodbury_logdet` (:289-305) solve with
and take the log-determinant of L L^T + noise I directly from a factor.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..kernels.pivot import column_major, pivot_column, pivot_factor

__all__ = [
    "PivotedCholesky",
    "pivoted_cholesky",
    "pivoted_cholesky_features",
    "sharded_pivot",
    "Preconditioner",
    "make_preconditioner",
    "precond_solve",
    "precond_inv_sqrt",
    "precond_sqrt",
    "woodbury_solve",
    "woodbury_logdet",
]


class PivotedCholesky(NamedTuple):
    L: torch.Tensor  # (n, k) partial Cholesky factor of K (without noise)
    pivots: torch.Tensor  # (k,) int64 chosen pivot indices


def pivoted_cholesky(diag: torch.Tensor, col_fn: Callable[[torch.Tensor], torch.Tensor],
                     rank: int) -> PivotedCholesky:
    """Rank-``rank`` pivoted Cholesky of an SPSD matrix given by its columns (pivoted_cholesky.py:56-103).

    ``diag`` (n,) is the matrix diagonal and ``col_fn(i)`` its column i as
    an (n,) tensor, for a 0-d int64 index tensor (no read back to the
    host).  A pivot whose residual diagonal is at most 1e-6 of the largest
    initial diagonal gets a zero column, as in
    :func:`pivoted_cholesky_features`.
    """
    n = diag.shape[0]
    d = diag.to(torch.float32)
    L = torch.zeros((n, rank), dtype=torch.float32, device=diag.device)
    pivots = torch.zeros(rank, dtype=torch.int64, device=diag.device)
    d0_max = d.max()
    rows = torch.arange(n, device=diag.device)
    for j in range(rank):
        piv = torch.argmax(d)
        mask = (torch.arange(rank, device=diag.device) < j).to(L.dtype)
        col = col_fn(piv).to(torch.float32) - (L * (L[piv] * mask)[None, :]).sum(dim=-1)
        pivot_val = d[piv]
        alive = pivot_val > 1e-6 * d0_max
        root = torch.sqrt(torch.clamp(pivot_val, min=1e-12))
        ell = torch.where(alive, col / root, 0.0)
        ell = torch.where(rows == piv, torch.where(alive, root, 0.0), ell)
        L[:, j] = ell
        d = torch.where(rows == piv, 0.0, torch.clamp(d - ell * ell, min=0.0))
        pivots[j] = piv
    return PivotedCholesky(L=L, pivots=pivots)


def pivoted_cholesky_features(
    ref: torch.Tensor,
    diag: torch.Tensor,
    nu: float,
    outputscale: torch.Tensor,
    rank: int,
    axis=None,
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
    ``L`` is column-major: the (n, rank) view of a contiguous (rank, n)
    tensor.  On one device the factor is K6's one host call
    (:func:`~simplex_gp_torch.kernels.pivot.pivot_factor`).  With ``axis``,
    ref and diag are this rank's rows, so is L, and ``pivots[j]`` is the
    pivot's index among this rank's rows, or -1 where another rank holds it;
    each step is K6' with one all-gather.
    """
    s = outputscale.to(torch.float32).reshape(())
    if axis is None:
        L, pivots = pivot_factor(ref, diag, s, nu, rank)
        return PivotedCholesky(L=L, pivots=pivots)
    n = ref.shape[0]
    ref = column_major(ref.to(torch.float32))
    L = torch.zeros((rank, n), dtype=torch.float32, device=ref.device).T
    pivots = torch.zeros(rank, dtype=torch.int64, device=ref.device)
    d = diag.to(torch.float32).contiguous()
    d0_max = axis.pmax(d.max())
    arg = torch.argmax(d)  # this rank's candidate; then each step's fused argmax
    for j in range(rank):
        piv, row = sharded_pivot(ref, L, d, axis, arg)
        d = pivot_column(ref, L, d, piv, j, s, d0_max, nu, pivots, row, next_piv=arg)
    return PivotedCholesky(L=L, pivots=pivots)


def sharded_pivot(ref: torch.Tensor, L: torch.Tensor, d: torch.Tensor, axis, arg=None):
    """The next pivot of a sharded factor: (its index in this rank's rows or -1, its rows for K6').

    One all-gather of a (1 + dim + k) candidate per rank -- the local largest
    residual diagonal (``arg``, the step's fused argmax, or torch.argmax(d)),
    that row of ref, that row of L (a column of the column-major L^T) --
    and the first largest in rank order wins, on every rank alike (:129-140).
    """
    dim = ref.shape[1]
    if arg is None:
        arg = torch.argmax(d)
    at = arg.reshape(1)
    cands = axis.all_gather(torch.cat([d.index_select(0, at), ref.index_select(0, at)[0],
                                       L.index_select(0, at)[0]])[None])  # (P, 1 + dim + k)
    win = torch.argmax(cands[:, 0])  # the first largest, in rank order
    c = cands.index_select(0, win.reshape(1))[0]
    return torch.where(win == axis.rank, arg, -1), (c[1:1 + dim], c[1 + dim:], c[:1])


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


def _rowsum(t: torch.Tensor, axis) -> torch.Tensor:
    """A sum over the rows that ``axis`` shards (unchanged without one)."""
    return t if axis is None else axis.psum(t)


def make_preconditioner(L: torch.Tensor, noise: torch.Tensor, n_global: int, axis=None) -> Preconditioner:
    """Diagonalize L L^T + noise I: one k x k eigh, a Newton-Schulz polish, gamma.

    With ``axis``, L holds this rank's rows and the Gram matrices are all-reduced (:217-219).  The CG's
    Woodbury passes over U take the ranks that ``BBMMConfig.precond_rank`` states (kernels/cg.py::u_layout).
    """
    s2, V = torch.linalg.eigh(_rowsum(L.T @ L, axis))
    s2 = torch.clamp(s2, min=0.0)
    denom = torch.sqrt(torch.clamp(s2, min=1e-12))
    U = L @ (V / denom[None, :])
    G2 = _rowsum(U.T @ U, axis)
    k = G2.shape[0]
    U = U @ (1.5 * torch.eye(k, dtype=U.dtype, device=U.device) - 0.5 * G2)
    gamma = torch.clamp(torch.linalg.eigvalsh(_rowsum(U.T @ U, axis))[-1], min=1.0)
    logdet = torch.log1p(s2 / noise).sum() + n_global * torch.log(noise)
    return Preconditioner(U=U, s2=s2, noise=noise, logdet=logdet, gamma=gamma)


def precond_solve(P: Preconditioner, V: torch.Tensor, axis=None) -> torch.Tensor:
    """P^{-1} V via Woodbury in the eigenbasis, U-term divided by gamma: O(n k t)."""
    w = P.s2 / (P.noise * (P.noise + P.s2)) / P.gamma
    return V / P.noise - P.U @ (w[:, None] * _rowsum(P.U.T @ V, axis))


def precond_inv_sqrt(P: Preconditioner, V: torch.Tensor, axis=None) -> torch.Tensor:
    """P^{-1/2} V = noise^{-1/2} V + U ((noise+s2)^{-1/2} - noise^{-1/2}) / gamma U^T V."""
    w = (torch.rsqrt(P.noise + P.s2) - torch.rsqrt(P.noise)) / P.gamma
    return V * torch.rsqrt(P.noise) + P.U @ (w[:, None] * _rowsum(P.U.T @ V, axis))


def precond_sqrt(P: Preconditioner, V: torch.Tensor, axis=None) -> torch.Tensor:
    """P^{1/2} V = noise^{1/2} V + U (sqrt(noise+s2) - sqrt(noise)) / gamma U^T V."""
    w = (torch.sqrt(P.noise + P.s2) - torch.sqrt(P.noise)) / P.gamma
    return V * torch.sqrt(P.noise) + P.U @ (w[:, None] * _rowsum(P.U.T @ V, axis))


def woodbury_solve(L: torch.Tensor, noise: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """(L L^T + noise I)^{-1} V by Woodbury, O(n k^2 + n k t) (pivoted_cholesky.py:289-296)."""
    k = L.shape[1]
    inner = noise * torch.eye(k, dtype=L.dtype, device=L.device) + L.T @ L
    sol = torch.cholesky_solve(L.T @ V, torch.linalg.cholesky(inner))
    return (V - L @ sol) / noise


def woodbury_logdet(L: torch.Tensor, noise: torch.Tensor, n: int) -> torch.Tensor:
    """log|L L^T + noise I| by the matrix determinant lemma (pivoted_cholesky.py:299-305)."""
    k = L.shape[1]
    chol = torch.linalg.cholesky(torch.eye(k, dtype=L.dtype, device=L.device) + (L.T @ L) / noise)
    return 2.0 * torch.log(torch.diagonal(chol)).sum() + n * torch.log(noise)
