"""The solver in plain PyTorch: pivoted Cholesky, the Woodbury preconditioner, CG and the SLQ log-det.

Written from the definitions the program states, with its rules:
- the rank-k pivoted Cholesky of s k(d2) from exact Matern columns, each
  pivot the first largest residual diagonal, a zero column at a residual
  of at most 1e-6 of the largest initial one
  (simplex_gp_torch/kernels/pivot.py:28-80, :161-175);
- P = U diag(s2) U^T + noise I from one k x k eigh, a Newton-Schulz
  polish and the SPD guard gamma (linalg/pivoted_cholesky.py:145-198);
- preconditioned CG over all columns with the "mean" stop, the floor of 10
  iterations, the stall guard of 50, the breakdown freeze, the best
  iterate and the Lanczos record (linalg/cg.py:63-110,
  kernels/cg.py:303-318, :495-588);
- the SLQ log-det from that record (linalg/lanczos.py:89-131).

``q`` rounds the operands of products (see :mod:`gpbench.reference.lattice`).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from .lattice import ident

__all__ = ["matern_value", "pivot_factor", "Precond", "precond", "cg", "logdet_from_record"]


def matern_value(d2: torch.Tensor, nu: float) -> torch.Tensor:
    """The exact Matern-nu kernel of squared distance (kernels/pivot.py:28-43)."""
    d = torch.sqrt(torch.clamp(d2, min=1e-30))
    e = torch.exp(-math.sqrt(2.0 * nu) * d)
    if nu == 0.5:
        return e
    if nu == 1.5:
        return (1.0 + math.sqrt(3.0) * d) * e
    return (1.0 + math.sqrt(5.0) * d + (5.0 / 3.0) * d2) * e


def pivot_factor(ref: torch.Tensor, s: torch.Tensor, nu: float, rank: int, q: Callable = ident,
                 pivots: Optional[torch.Tensor] = None) -> tuple:
    """(L (n, rank), pivots, gap): the pivoted Cholesky of s k(|ref_i - ref_j|^2).

    Each pivot is the first largest residual diagonal, or, given ``pivots``,
    the given one; ``gap`` is then how far below the largest residual diagonal
    the given pivots' lie, the worst step's, relative to it (0 for its own).
    """
    n = ref.shape[0]
    chosen = torch.zeros(rank, dtype=torch.long, device=ref.device)
    gap = torch.zeros((), device=ref.device)
    L = torch.zeros((n, rank), dtype=torch.float32, device=ref.device)
    diag = s * torch.ones(n, dtype=torch.float32, device=ref.device)
    d0_max = diag.max()
    rows = torch.arange(n, device=ref.device)
    for j in range(rank):
        piv = torch.argmax(diag)
        if pivots is not None:
            gap = torch.maximum(gap, (diag[piv] - diag[pivots[j]]) / diag[piv])
            piv = pivots[j]
        chosen[j] = piv
        diff = q(ref - ref[piv][None, :])
        col = s * matern_value((diff * diff).sum(-1), nu)
        if j:
            col = col - (q(L[:, :j]) * q(L[piv, :j])[None, :]).sum(-1)
        pv = diag[piv]
        alive = pv > 1e-6 * d0_max
        root = torch.sqrt(torch.clamp(pv, min=1e-12))
        ell = torch.where(alive, col / root, 0.0)
        ell = torch.where(rows == piv, torch.where(alive, root, 0.0), ell)
        L[:, j] = ell
        diag = torch.where(rows == piv, 0.0, torch.clamp(diag - ell * ell, min=0.0))
    return L, chosen, float(gap)


class Precond(NamedTuple):
    U: torch.Tensor
    s2: torch.Tensor
    noise: torch.Tensor
    logdet: torch.Tensor
    gamma: torch.Tensor
    q: Callable

    def _mm_t(self, V):  # U^T V
        return self.q(self.U).T @ self.q(V)

    def _mm(self, G):  # U G
        return self.q(self.U) @ self.q(G)

    def solve(self, V):
        """P^{-1} V."""
        w = self.s2 / (self.noise * (self.noise + self.s2)) / self.gamma
        return V / self.noise - self._mm(w[:, None] * self._mm_t(V))

    def sqrt(self, V):
        """P^{1/2} V."""
        w = (torch.sqrt(self.noise + self.s2) - torch.sqrt(self.noise)) / self.gamma
        return V * torch.sqrt(self.noise) + self._mm(w[:, None] * self._mm_t(V))


def precond(L: torch.Tensor, noise: torch.Tensor, n: int, q: Callable = ident) -> Precond:
    """P = L L^T + noise I, diagonalized: one eigh, a Newton-Schulz polish, gamma."""
    s2, V = torch.linalg.eigh(q(L).T @ q(L))
    s2 = torch.clamp(s2, min=0.0)
    U = q(L) @ q(V / torch.sqrt(torch.clamp(s2, min=1e-12))[None, :])
    k = s2.shape[0]
    G2 = q(U).T @ q(U)
    U = q(U) @ q(1.5 * torch.eye(k, dtype=U.dtype, device=U.device) - 0.5 * G2)
    gamma = torch.clamp(torch.linalg.eigvalsh(q(U).T @ q(U))[-1], min=1.0)
    logdet = torch.log1p(s2 / noise).sum() + n * torch.log(noise)
    return Precond(U, s2, noise, logdet, gamma, q)


class CGOut(NamedTuple):
    x: torch.Tensor  # (n, t) the best iterate of each column
    iterations: int
    residual: torch.Tensor  # (t,) best relative residuals
    alphas: torch.Tensor  # (m, t)
    betas: torch.Tensor
    tmask: torch.Tensor


# The program's iteration floor and stall window (linalg/cg.py::cg_solve's min_iters and stall_window).
FLOOR, STALL = 10, 50


def cg(mv: Callable, b: torch.Tensor, P: Optional[Precond], tol: float, max_iters: int, m: int = 0,
       q: Callable = ident) -> CGOut:
    """Solve mv(X) = b for every column; ``m`` > 0 records the first m Lanczos coefficients of each column."""
    n, t = b.shape
    dev = b.device
    dot = lambda u, v: (q(u) * q(v)).sum(0)
    x, x_best, r = torch.zeros_like(b), torch.zeros_like(b), b.clone()
    norm = torch.sqrt(dot(b, b))
    b_norm = torch.where(norm == 0, 1.0, norm)
    res_best = norm / b_norm
    z = r if P is None else P.solve(r)
    p, rz = z.clone(), dot(r, z)
    A = torch.ones((max(m, 1), t), device=dev)
    B = torch.zeros((max(m, 1), t), device=dev)
    TM = torch.zeros((max(m, 1), t), dtype=torch.bool, device=dev)
    done = torch.zeros(t, dtype=torch.bool, device=dev)
    alive = torch.ones(t, dtype=torch.bool, device=dev)
    best_mean, since, it = float("inf"), 0, 0
    floor = min(FLOOR, max_iters)
    while it < max_iters:
        ap = mv(p)
        pap = dot(p, ap)
        alpha = torch.where(done | (pap <= 0), 0.0, rz / torch.where(pap <= 0, 1.0, pap))
        x = x + alpha * p
        r = r - alpha * ap
        z = r if P is None else P.solve(r)
        rz_new, rr = dot(r, z), dot(r, r)
        broken = ~done & ((pap <= 0) | (rz_new < 0))
        beta = torch.where(done | broken | (rz == 0), 0.0, rz_new / torch.where(rz == 0, 1.0, rz))
        res = torch.sqrt(rr) / b_norm
        x_best = torch.where((res < res_best)[None, :], x, x_best)
        res_best = torch.minimum(res, res_best)
        ok = alive & ~done & (pap > 0) & (rz > 0)
        if m and it < m:
            A[it] = torch.where(ok, alpha, A[it])
            B[it] = torch.where(ok, beta, B[it])
            TM[it] = ok
        alive = ok
        p = z + beta * p
        m_best = float(res_best.mean())
        if m_best < 0.99 * best_mean:
            best_mean, since = m_best, 0
        else:
            since += 1
        past_floor = it + 1 >= floor
        done = done | broken | (since >= STALL and past_floor) | (res < 1e-10)
        done = done | bool(float(res.mean()) < tol and past_floor)
        rz = rz_new
        it += 1
        if bool(done.all()):
            break
    return CGOut(x_best, it, res_best, A[:m], B[:m], TM[:m])


def logdet_from_record(A: torch.Tensor, B: torch.Tensor, TM: torch.Tensor, z_norm2: torch.Tensor) -> torch.Tensor:
    """The SLQ estimate of log|A| from CG's (m, p) record (linalg/lanczos.py:109-131)."""
    m, p = A.shape
    live_next = torch.cat([TM[1:], torch.zeros((1, p), dtype=torch.bool, device=TM.device)])
    inv_a = 1.0 / torch.where(TM, A, 1.0)
    b_over_a = torch.where(TM, B, 0.0) * inv_a
    prev = torch.cat([torch.zeros((1, p), device=A.device), b_over_a[:-1]])
    diag = torch.where(TM, inv_a + prev, 1.0)
    off = torch.where(TM & live_next, torch.sqrt(torch.clamp(B, min=0.0)) * inv_a, 0.0)[:-1]
    T = torch.diag_embed(diag.T) + torch.diag_embed(off.T, offset=1) + torch.diag_embed(off.T, offset=-1)
    evals, evecs = torch.linalg.eigh(T.double())
    quad = (evecs[:, 0, :] ** 2 * torch.log(torch.clamp(evals, min=1e-10))).sum(-1)
    return (z_norm2.double() * quad).mean().float()
