"""Batched preconditioned conjugate gradients in PyTorch.

Port of simplex_gp_tpu/linalg/cg.py::cg_solve (:43), with every stopping
rule of the JAX solver: the iteration floor, the "mean" and "column" stop
modes, the stall guard, the breakdown freeze on pap <= 0 or rz < 0, the
best-residual iterate, and no convergence at iteration 0.  The loop is a
Python ``while`` over torch ops; its condition reads one boolean back from
the device per iteration.  With ``tridiag_m`` it also records the CG step
and conjugacy coefficients of every column (the Lanczos tridiagonal the SLQ
log-det of the training path reads), with JAX's liveness mask.

With ``axis`` (a DataAxis) the rows are sharded over the ranks: every
column dot product is an all-reduce (cg.py:113-115), and every stop
decision reads only values derived from those sums, which are the same bits
on every rank, so all ranks run the same number of iterations; a rank that
stopped alone would leave the others waiting in a collective.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["CGResult", "cg_solve"]


class CGResult(NamedTuple):
    x: torch.Tensor  # (n, t) best-residual iterate per column
    iterations: int  # iterations actually run
    residual_norm: torch.Tensor  # (t,) best relative residual norms
    # Tridiagonal record (when tridiag_m > 0), as in the JAX CGResult:
    # tmask[k, j] marks step k of column j as a live Lanczos step; dead
    # steps keep (alpha 1, beta 0), a decoupled identity pad of T.
    alphas: Optional[torch.Tensor] = None  # (m, t) step sizes rz/pAp
    betas: Optional[torch.Tensor] = None  # (m, t) conjugacy coefficients rz'/rz
    tmask: Optional[torch.Tensor] = None  # (m, t) bool live-step mask


def cg_solve(
    matmul: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    tol: float = 1.0,
    max_iters: int = 500,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    min_iters: int = 10,
    stop_mode: str = "mean",
    stall_window: int = 50,
    tridiag_m: int = 0,
    axis=None,
) -> CGResult:
    """Solve ``A x = b`` for an SPD implicit operator, all columns at once.

    Arguments as in the JAX ``cg_solve``: ``matmul`` maps (n, t) to A @ V,
    ``tol`` is the relative-residual tolerance, ``min_iters`` the floor before
    the tolerance may stop a column, ``stop_mode`` "mean" (stop the whole
    solve when the mean relative residual is below ``tol``; a column freezes
    alone only once res < 1e-10) or "column" (each column at its own
    tolerance), and ``stall_window`` the number of iterations past the floor
    without a 1% gain in the mean best residual after which the solve stops
    (0 disables).  ``tridiag_m`` > 0 records the first ``tridiag_m``
    coefficients per column (cg.py:191-205): T[k,k] = 1/alpha_k +
    beta_{k-1}/alpha_{k-1}, T[k,k+1] = sqrt(beta_k)/alpha_k.  ``axis``: b
    holds this rank's rows, and ``matmul`` and ``precond`` must be the
    sharded operators.
    """
    if stop_mode not in ("mean", "column"):
        raise ValueError(f"unknown stop_mode {stop_mode!r}")
    if precond is None:
        precond = lambda v: v

    def dot(u, v):
        s = (u * v).sum(dim=0)
        return s if axis is None else axis.psum(s)

    b = b.to(torch.float32)
    b_norm = torch.sqrt(dot(b, b))
    b_norm = torch.where(b_norm == 0, 1.0, b_norm)

    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = dot(r, z)
    floor = min(min_iters, max_iters)

    it = 0
    # Never mark a column converged at iteration zero (cg.py:207-219).
    done = torch.zeros(b.shape[1], dtype=torch.bool, device=b.device)
    x_best = x
    res_best = torch.sqrt(dot(r, r)) / b_norm
    best_mean = torch.tensor(float("inf"), device=b.device)
    since = torch.zeros((), dtype=torch.int32, device=b.device)
    if tridiag_m:
        t = b.shape[1]
        A = torch.ones((tridiag_m, t), dtype=torch.float32, device=b.device)
        B = torch.zeros((tridiag_m, t), dtype=torch.float32, device=b.device)
        TM = torch.zeros((tridiag_m, t), dtype=torch.bool, device=b.device)
        t_alive = torch.ones(t, dtype=torch.bool, device=b.device)
    while it < max_iters and not bool(done.all()):
        done_before = done
        ap = matmul(p)
        pap = dot(p, ap)
        # Column breakdown (pap <= 0, or rz < 0 below) freezes the column at
        # its best iterate instead of stepping along a divergent direction.
        broken = ~done & (pap <= 0)
        alpha = torch.where(done | (pap <= 0), 0.0, rz / torch.where(pap <= 0, 1.0, pap))
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = dot(r, z)
        broken = broken | (~done & (rz_new < 0))
        beta = torch.where(done | broken | (rz == 0), 0.0, rz_new / torch.where(rz == 0, 1.0, rz))
        p = z + beta * p
        res = torch.sqrt(dot(r, r)) / b_norm
        better = res < res_best
        x_best = torch.where(better[None, :], x, x_best)
        res_best = torch.minimum(res, res_best)
        m_best = res_best.mean()
        improved = m_best < 0.99 * best_mean
        best_mean = torch.where(improved, m_best, best_mean)
        since = torch.where(improved, 0, since + 1)
        if stall_window:
            stalled = (since >= stall_window) & (it + 1 >= floor)
        else:
            stalled = torch.zeros((), dtype=torch.bool, device=b.device)
        if stop_mode == "mean":
            stop_all = (res.mean() < tol) & (it + 1 >= floor)
            done = done | stop_all | stalled | (res < 1e-10) | broken
        else:
            done = done | ((res < tol) & (it + 1 >= floor)) | stalled | broken
        if tridiag_m:
            # A step is a valid Lanczos step only while the column has never
            # converged or broken down; once either happens the record of
            # that column stops for good (cg.py:192-204).
            ok = t_alive & ~done_before & (pap > 0) & (rz > 0)
            if it < tridiag_m:
                A[it] = torch.where(ok, alpha, A[it])
                B[it] = torch.where(ok, beta, B[it])
                TM[it] = TM[it] | ok
            t_alive = ok
        rz = rz_new
        it += 1
    if tridiag_m:
        return CGResult(x=x_best, iterations=it, residual_norm=res_best, alphas=A, betas=B, tmask=TM)
    return CGResult(x=x_best, iterations=it, residual_norm=res_best)
