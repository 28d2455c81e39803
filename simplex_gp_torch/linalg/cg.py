"""Batched preconditioned conjugate gradients in PyTorch.

Port of simplex_gp_tpu/linalg/cg.py::cg_solve (:43), with every stopping
rule of the JAX solver: the iteration floor, the "mean" and "column" stop
modes, the stall guard, the breakdown freeze on pap <= 0 or rz < 0, the
best-residual iterate, and no convergence at iteration 0.  With
``tridiag_m`` it also records the CG step and conjugacy coefficients of
every column (the Lanczos tridiagonal the SLQ log-det of the training path
reads), with JAX's liveness mask.

On one device the loop body is K10 (``kernels/cg.py``, ``csrc/cg.cu``):
four kernels around the caller's MVM, and for a Woodbury preconditioner
three more that read U themselves (U^T r's block partials, their fold with
w, then z = r / noise - U G2 with r . z), with the state (the stop flag,
the iteration counter, the stall guard, the record) on the device.  The
loop reads one flag back per iteration, as JAX's ``while_loop`` tests its
condition, and the whole state once at its end, which gives the iteration
count and the reason it stopped (:func:`_stop_reason`); a solve records the
span ``cg``, one ``cg.stop.<reason>`` and its reads
(:mod:`simplex_gp_torch.trace`).  On the CPU the same
loop runs the kernels' plain twins, which sum in the kernels' order, so a
solve repeats bit for bit on either device.  With ``graph`` (a card only)
the first iteration runs as launched, the second is captured in a CUDA
graph, and every later one is a replay of it, with the same reads of the
stop flag, so the count and the bits are the launched loop's.

With ``axis`` (a DataAxis) the rows are sharded over the ranks (K10', JAX's
``axis_name``: every dot a ``psum``, cg.py:113-115) and the loop is the same
K10 loop: each kernel that ends in a dot writes this rank's (nb, t) block
partials, the ranks' partials are all-gathered into a (P, nb, t) buffer,
and the kernel that needs the dot folds each rank's partials, then adds the
ranks in rank order.  So every rank reduces the same bytes, every stop
decision is the same bits on every rank whatever the backend's own
reduction order, and all ranks run the same iterations; a rank that stopped
alone would leave the others waiting in a collective.  An iteration makes
three collectives (pap; the Woodbury product U^T r, each rank's folded;
r . r and r . z together), the init three (the layout check; U^T b;
b . b and r0 . z0), besides the MVM's own.  A one-rank axis is the single-device solve bit for
bit.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch

from .. import trace
from ..kernels import cg as K10
from .pivoted_cholesky import Preconditioner

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
    stop: Optional[str] = None  # why the solve stopped (:func:`_stop_reason`)


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
    whose Woodbury solve K10 runs itself in two passes over U (cg_utr, then
    cg_precond) with the fold of U^T r between them.
    ``shift`` = (scale, noise), two 0-d tensors, makes the operator
    ``scale * matmul(V) + noise * V`` with the shift inside K10's first
    kernel.  ``graph`` replays the iterations from a CUDA graph (ignored on
    the CPU): it pays where a solve runs many iterations on one plan (the
    eval CG), not at the training CG's 10-13.  ``axis``: b holds this
    rank's rows, ``matmul`` and a callable ``precond`` must be the sharded
    operators, and a :class:`Preconditioner` holds this rank's rows of U;
    ``graph`` is refused (a gloo collective cannot be captured).
    """
    if stop_mode not in ("mean", "column"):
        raise ValueError(f"unknown stop_mode {stop_mode!r}")
    if graph and axis is not None:
        raise ValueError("cg_solve: graph=True takes no axis (the sharded loop's collectives are not captured)")
    with trace.span("cg"):
        loop = CGLoop(matmul, b, tol, max_iters, precond, min_iters, stop_mode, stall_window, tridiag_m, shift, axis)
        loop.run(graph)
        result = loop.result()
        trace.count(f"cg.stop.{result.stop}")
        trace.count("host_read.cg_stop", loop.reads)
        trace.count("host_read.cg_state")
    return result


cg_solve.graph_replays = 0  # iterations run as replays of a captured one (their kernels bypass the wrappers)


class CGLoop:
    """One solve: K10's device state, its static buffers, and one iteration.

    :func:`cg_solve` builds one and runs it; ``chip_smoke.py`` steps one to
    hold each K10 kernel against its plain twin from a saved state.  The
    buffers are updated in place (x, r, p, z, the best iterate, the block
    partials), so an iteration captured in a CUDA graph replays on them.
    ``part_rr`` and ``part_rz`` are views of the two halves of one (2, NB, t)
    buffer, which the sharded loop (``axis``) gathers in one collective:
    r . r's nb block partials (``kernels/cg.py::cg_layout``) and r . z's,
    cg_precond's nbu (``u_layout``) with a Woodbury preconditioner, else nb.
    """

    def __init__(self, matmul, b, tol=1.0, max_iters=500, precond=None, min_iters=10, stop_mode="mean",
                 stall_window=50, tridiag_m=0, shift=None, axis=None):
        b = b.to(torch.float32).contiguous()
        n, t = b.shape
        dev = b.device
        self.matmul, self.precond, self.shift, self.axis = matmul, precond, shift, axis
        self.reads = 0  # reads of the stop flag
        f32 = dict(dtype=torch.float32, device=dev)
        rp, nb = K10.cg_layout(n, t)
        if axis is not None:  # the ranks' partials stack only if every rank has the same layout
            layouts = axis.all_gather(torch.tensor([[n, nb]], device=dev)).tolist()
            trace.count("host_read.cg_layout")
            if any(lay != [n, nb] for lay in layouts):
                raise ValueError(f"cg_solve: the ranks' (rows, blocks) {layouts} differ; shard the rows equally")
        self.fs, self.is_ = K10.cg_state(t, dev)
        woodbury = isinstance(precond, Preconditioner)
        self.nb, self.nb_rz = nb, K10.u_layout(n, precond.U.shape[1], t).nb if woodbury else nb
        self.part_pap, self.part2 = torch.empty((nb, t), **f32), torch.empty((2, max(nb, self.nb_rz), t), **f32)
        self.part_rr, self.part_rz = self.part2[0, :nb], self.part2[1, :self.nb_rz]
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
        if woodbury:
            self.U = precond.U.contiguous()
            self.w = (precond.s2 / (precond.noise * (precond.noise + precond.s2)) / precond.gamma).contiguous()
            self.p_noise = precond.noise.to(torch.float32).reshape(()).contiguous()
            k = self.U.shape[1]
            self.part_g = torch.empty((self.nb_rz, k, t), **f32)
            self.G2, self.z = torch.empty((k, t), **f32), torch.empty_like(b)
            if axis is not None:
                self.G, self.ones = torch.empty((k, t), **f32), torch.ones(k, **f32)
        K10.cg_dot(b, b, self.part_rr)  # b . b in r . r's half until the first iteration: one gather with r0 . z0
        if precond is None:
            self.p = self.r.clone()
            part_bb = part_rz = self._gathered(self.part_rr)
        else:
            self.p = self._precondition().clone()
            part_bb, part_rz = self._pair()
        K10.cg_init(part_bb, part_rz, self.fs, self.is_, self.rules.max_iters)

    def _gathered(self, part: torch.Tensor) -> torch.Tensor:
        """Every rank's ``part`` stacked (P, ...) in one collective; without an axis ``part`` itself."""
        return part if self.axis is None else self.axis.all_gather_blocks(part)

    def _pair(self) -> tuple:
        """The partials of r . r and r . z (every rank's, from one gather of ``part2``, with an axis)."""
        if self.axis is None:
            return self.part_rr, self.part_rz
        rr, rz = self.axis.all_gather_blocks(self.part2).transpose(0, 1)
        return rr[:, :self.nb], rz[:, :self.nb_rz]

    def _precondition(self) -> torch.Tensor:
        """z = P^{-1} r and the block partials of r . z (a Woodbury P: pivoted_cholesky.py::precond_solve)."""
        r = self.r
        if isinstance(self.precond, Preconditioner):
            K10.cg_utr(self.U, r, self.part_g)
            if self.axis is None:
                K10.cg_fold(self.part_g, self.w, self.G2)
            else:
                # U^T r over every rank's rows: each rank folds its own partials (w = 1), the ranks' G are
                # all-gathered and added in rank order, not psum'd, so G2 is the same bits on every rank
                # whatever the backend's reduction.
                K10.cg_fold(self.part_g, self.ones, self.G)
                K10.cg_fold(self.axis.all_gather_blocks(self.G)[:, None], self.w, self.G2)
            K10.cg_precond(self.U, self.G2, r, self.p_noise, self.z, self.part_rz)
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
        K10.cg_step_x(self._gathered(self.part_pap), self.x, self.r, p, ap, self.fs, self.is_, self.part_rr)
        if self.precond is None:
            z = self.r
            part_rz = part_rr = self._gathered(self.part_rr)
        else:
            z = self._precondition()
            part_rr, part_rz = self._pair()
        K10.cg_step_p(part_rz, part_rr, self.x, z, p, self.x_best, self.fs, self.is_, self.A, self.B, self.TM,
                      self.rules)

    def stopped(self) -> bool:
        """The device's stop flag (one read back)."""
        self.reads += 1
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
        """The solve's result, from one read back of the whole state: the iterations and the stop reason."""
        res_best = K10.state_views(self.fs, self.is_).res_best.clone()
        fs, is_ = torch.cat([self.fs.view(torch.int32), self.is_]).cpu().split([self.fs.shape[0], self.is_.shape[0]])
        st = K10.state_views(fs.view(torch.float32), is_)
        iters, stop = int(st.it), _stop_reason(self.rules, st)
        if self.rules.m:
            return CGResult(x=self.x_best, iterations=iters, residual_norm=res_best, alphas=self.A, betas=self.B,
                            tmask=self.TM.bool(), stop=stop)
        return CGResult(x=self.x_best, iterations=iters, residual_norm=res_best, stop=stop)


def _stop_reason(rules: K10.CGRules, st) -> str:
    """Why a solve stopped, from its final state (host copies of K10's views): "max_iters" when a column
    was still running at the cap; else "tolerance" when the best iterate meets the tolerance (the mean best
    residual below ``tol``, or every column's below it in the "column" mode, or every column below 1e-10,
    where a column freezes alone); else "stall" when the stall guard fired (``stall_window`` iterations past
    the floor without a 1% gain); else "breakdown" (the columns left froze on pap <= 0 or rz < 0)."""
    if not bool(st.done.bool().all()):
        return "max_iters"
    res = st.res_best
    met = bool((res < rules.tol).all()) if rules.column_mode else float(res.double().mean()) < rules.tol
    if met or bool((res < 1e-10).all()):
        return "tolerance"
    if rules.stall_window > 0 and int(st.since) >= rules.stall_window and int(st.it) >= rules.floor:
        return "stall"
    return "breakdown"


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

