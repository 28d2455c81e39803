"""Batched preconditioned conjugate gradients in PyTorch.

Port of simplex_gp_tpu/linalg/cg.py::cg_solve (:43), with every stopping
rule of the JAX solver: the iteration floor, the "mean" and "column" stop
modes, the stall guard, the breakdown freeze on pap <= 0 or rz < 0, the
best-residual iterate, and no convergence at iteration 0.  With
``tridiag_m`` it also records the CG step and conjugacy coefficients of
every column (the Lanczos tridiagonal the SLQ log-det of the training path
reads), with JAX's liveness mask.

On one device the loop body is K10 (``kernels/cg.py``, ``csrc/cg.cu``):
five kernels around the caller's MVM and the Woodbury preconditioner's two
products with U, with the state (the stop flag, the iteration counter, the
stall guard, the record) on the device.  The loop reads one flag back per
iteration, as JAX's ``while_loop`` tests its condition.  On the CPU the same
loop runs the kernels' plain twins, which sum in the kernels' order, so a
solve repeats bit for bit on either device.  With ``graph`` (a card only)
the first iteration runs as launched, the second is captured in a CUDA
graph, and every later one is a replay of it, with the same reads of the
stop flag, so the count and the bits are the launched loop's.

With ``axis`` (a DataAxis) the rows are sharded over the ranks: every
column dot product is an all-reduce (cg.py:113-115), and every stop
decision reads only values derived from those sums, which are the same bits
on every rank, so all ranks run the same number of iterations; a rank that
stopped alone would leave the others waiting in a collective.  This engine
still runs the body as eager torch ops (K10's sharded form is not ported).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch

from ..kernels import cg as K10
from .pivoted_cholesky import Preconditioner, precond_solve

__all__ = ["CGResult", "CGLoop", "cg_solve", "capture"]


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
    precond: Union[None, Preconditioner, Callable[[torch.Tensor], torch.Tensor]] = None,
    min_iters: int = 10,
    stop_mode: str = "mean",
    stall_window: int = 50,
    tridiag_m: int = 0,
    axis=None,
    shift: Optional[tuple] = None,
    graph: bool = False,
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
    beta_{k-1}/alpha_{k-1}, T[k,k+1] = sqrt(beta_k)/alpha_k.

    ``precond`` is None, a callable V -> P^{-1} V, or a :class:`Preconditioner`,
    whose Woodbury solve K10 runs itself around two products with U.
    ``shift`` = (scale, noise), two 0-d tensors, makes the operator
    ``scale * matmul(V) + noise * V`` with the shift inside K10's first
    kernel.  ``graph`` replays the iterations from a CUDA graph (ignored on
    the CPU): it pays where a solve runs many iterations on one plan (the
    eval CG), not at the training CG's 10-13.  ``axis``: b holds this
    rank's rows, and ``matmul`` and
    ``precond`` must be the sharded operators.
    """
    if stop_mode not in ("mean", "column"):
        raise ValueError(f"unknown stop_mode {stop_mode!r}")
    if axis is not None:
        return _cg_solve_sharded(matmul, b, tol, max_iters, precond, min_iters, stop_mode, stall_window, tridiag_m,
                                 axis, shift)
    loop = CGLoop(matmul, b, tol, max_iters, precond, min_iters, stop_mode, stall_window, tridiag_m, shift)
    loop.run(graph)
    return loop.result()


cg_solve.graph_replays = 0  # iterations run as replays of a captured one (their kernels bypass the wrappers)


class CGLoop:
    """One single-device solve: K10's device state, its static buffers, and one iteration.

    :func:`cg_solve` builds one and runs it; ``chip_smoke.py`` steps one to
    hold each K10 kernel against its plain twin from a saved state.  The
    buffers are updated in place (x, r, p, z, the best iterate, the block
    partials), so an iteration captured in a CUDA graph replays on them.
    """

    def __init__(self, matmul, b, tol=1.0, max_iters=500, precond=None, min_iters=10, stop_mode="mean",
                 stall_window=50, tridiag_m=0, shift=None):
        b = b.to(torch.float32).contiguous()
        n, t = b.shape
        dev = b.device
        self.matmul, self.precond, self.shift = matmul, precond, shift
        f32 = dict(dtype=torch.float32, device=dev)
        rp, nb = K10.cg_layout(n, t)
        self.fs, self.is_ = K10.cg_state(t, dev)
        self.part_pap, self.part_rr, self.part_rz, self.part_bb = (torch.empty((nb, t), **f32) for _ in range(4))
        self.x, self.x_best, self.r = torch.zeros_like(b), torch.zeros_like(b), b.clone()
        m = tridiag_m
        self.A = torch.ones((m, t), **f32) if m else None
        self.B = torch.zeros((m, t), **f32) if m else None
        self.TM = torch.zeros((m, t), dtype=torch.int32, device=dev) if m else None
        self.rules = K10.CGRules(float(tol), min(min_iters, max_iters), int(max_iters), int(stall_window),
                                 stop_mode == "column", m)
        if shift is not None:
            self.scale, self.noise = (torch.as_tensor(v, dtype=torch.float32, device=dev).detach().reshape(())
                                      .contiguous() for v in shift)
            self.ap = torch.empty_like(b)
        if isinstance(precond, Preconditioner):
            self.U = precond.U.contiguous()
            self.w = (precond.s2 / (precond.noise * (precond.noise + precond.s2)) / precond.gamma).contiguous()
            self.p_noise = precond.noise.to(torch.float32).reshape(()).contiguous()
            k = self.U.shape[1]
            self.G, self.G2 = torch.empty((k, t), **f32), torch.empty((k, t), **f32)
            self.H, self.z = torch.empty_like(b), torch.empty_like(b)
        K10.cg_dot(b, b, self.part_bb)
        if precond is None:
            z, self.part_rz = self.r, self.part_bb
        else:
            z = self._precondition()
        self.p = z.clone()
        K10.cg_init(self.part_bb, self.part_rz, self.fs, self.is_, self.rules.max_iters)

    def _precondition(self) -> torch.Tensor:
        """z = P^{-1} r and the block partials of r . z (a Woodbury P: pivoted_cholesky.py::precond_solve)."""
        r = self.r
        if isinstance(self.precond, Preconditioner):
            torch.mm(self.U.T, r, out=self.G)
            K10.cg_scale(self.G, self.w, self.G2)
            torch.mm(self.U, self.G2, out=self.H)
            K10.cg_precond(r, self.H, self.p_noise, self.z, self.part_rz)
            return self.z
        z = self.precond(r).to(torch.float32).contiguous()
        K10.cg_dot(r, z, self.part_rz)
        return z

    def iteration(self) -> None:
        """One CG iteration (cg.py:133-205), launched without a host read."""
        p = self.p
        kp = self.matmul(p).to(torch.float32).contiguous()
        if self.shift is not None:
            K10.cg_dot(p, kp, self.part_pap, self.scale, self.noise, self.ap)
            ap = self.ap
        else:
            K10.cg_dot(p, kp, self.part_pap)
            ap = kp
        K10.cg_step_x(self.part_pap, self.x, self.r, p, ap, self.fs, self.is_, self.part_rr)
        if self.precond is None:
            z, part_rz = self.r, self.part_rr
        else:
            z, part_rz = self._precondition(), self.part_rz
        K10.cg_step_p(part_rz, self.part_rr, self.x, z, p, self.x_best, self.fs, self.is_, self.A, self.B, self.TM,
                      self.rules)

    def stopped(self) -> bool:
        """The device's stop flag (one read back)."""
        return bool(int(K10.state_views(self.fs, self.is_).stop))

    def run(self, graph: bool = False) -> None:
        """Iterate until the stop flag is set; with ``graph`` on a card, replay the second iteration's capture."""
        replay = None
        while not self.stopped():
            if replay is not None:
                replay.replay()
                cg_solve.graph_replays += 1
                continue
            self.iteration()
            if graph and self.x.is_cuda and not self.stopped():
                replay = capture(self.iteration)

    def result(self) -> CGResult:
        st = K10.state_views(self.fs, self.is_)
        res_best, iters = st.res_best.clone(), int(st.it)
        if self.rules.m:
            return CGResult(x=self.x_best, iterations=iters, residual_norm=res_best, alphas=self.A, betas=self.B,
                            tmask=self.TM.bool())
        return CGResult(x=self.x_best, iterations=iters, residual_norm=res_best)


def capture(fn) -> "torch.cuda.CUDAGraph":
    """``fn``'s launches captured (not run) in a CUDA graph on a side stream; replay() runs them."""
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin()
        fn()
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    return graph


def _cg_solve_sharded(matmul, b, tol, max_iters, precond, min_iters, stop_mode, stall_window, tridiag_m, axis,
                      shift) -> CGResult:
    """The data-sharded solve: the same rules as eager torch ops, every column dot all-reduced."""
    if isinstance(precond, Preconditioner):
        P = precond
        precond = lambda v: precond_solve(P, v, axis)
    elif precond is None:
        precond = lambda v: v
    if shift is not None:
        mv, (scale, noise) = matmul, shift
        matmul = lambda v: scale * mv(v) + noise * v

    def dot(u, v):
        return axis.psum((u * v).sum(dim=0))

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
