"""Marginal-likelihood engine: inv_quad + logdet with stochastic gradients.

Port of simplex_gp_tpu/linalg/mll.py.  For
K_hat = s K + noise I:

  forward:  inv_quad = y^T K_hat^{-1} y   by preconditioned batched CG
            logdet   = log|K_hat|         by stochastic Lanczos quadrature
  backward: d(inv_quad) = -alpha^T dK_hat alpha          (alpha = K_hat^{-1} y)
            d(logdet)  ~= (1/p) sum_i (K_hat^{-1} b_i)^T dK_hat (P^{-1} b_i)

Both backward terms are u^T dK_hat v forms with U = [-a alpha | (b/p) Z] and
V = [alpha | P^{-1} b]; :class:`LatticeInvQuadLogdet` evaluates them in
closed form (_iql_bwd, :243-272), with no nested autograd, in one of two
ways (``BBMMConfig.grad_mode``):
  * "exact": one forward apply of V that keeps its table, one transposed
    apply of s U, and K5 -- on a join plan of the same positions, built
    afresh with its row lists, as JAX's backward filters afresh
    (mll.py:262-265; the CG's chain plan has no transpose and keeps no
    table).  The two applies are K9's over one window (the row-order splat
    and the live-row blur), so the gradient repeats bit for bit, as JAX's
    autodiff through the sort chain does;
  * "deriv_filter" (the reference's gradient, JAX's ``lattice_filter``):
    K V by the one-shot filter K4, as JAX's forward inside the vjp runs it,
    and the position gradient from the derivative-tap filter K7 with the
    cotangent s U.
The forward runs with no graph, as JAX's custom VJP does, so no gradient
flows through the preconditioner or the CG.

The single-device CG runs on the sort-chain plan (K3'), JAX's engine of
record (mll.py:172, filter.py:186-193).  ``BBMMConfig.plan_capacity``
bounds the training plan's table (JAX's mll.py:65-71): the CG's chain
plan, and the exact backward's join plan of the same positions; the
"deriv_filter" backward filters untrimmed, as JAX's ``lattice_filter``.  An
overflow (more occupied lattice points than the capacity, e.g. after the
lengthscales shrank) makes every apply on either plan NaN.  The NLML does
not become NaN, in JAX as here: every CG residual is NaN, so the best
iterate stays the zero start and the loss a finite value of no meaning;
the exact backward's outputscale gradient is NaN (as JAX's host loop gives
it, host_loop.py:222-224).

``BBMMConfig.axis`` (a DataAxis; JAX's ``axis_name``) runs the engine
data-sharded: x, y and the probes hold this rank's rows, the plan is the
sharded one (ops/lattice.py::build_plan_sharded_join), every reduction
over n is an all-reduce, n is the global count, and the loss is global on
every rank while the backward returns this rank's partial gradients, which
``parallel.mesh.data_parallel_loss_fn`` all-reduces once.  As in JAX, the
sharded engine ignores two settings: ``grad_mode="deriv_filter"`` runs the
exact gradient (mll.py:95-106), and ``plan_capacity`` is not applied
(mll.py:161-172).

A MixtureKernel (JAX :100-110) takes the stacked mixture plan and K12 for
every apply, ignores ``plan_capacity``, and always runs the exact gradient,
whatever ``grad_mode`` says: the backward re-applies through the CG's
MixturePlan, saved for it (K12, transposed K12, K5 on the stacked
problem), as the sharded engine reuses its sharded plan.  Its
preconditioner's exact columns are those of its Matern target
(``dk.nu``).  The sharded engine takes a mixture as JAX's does (:100-104,
:164-168): one sharded join plan per component at ``ref * alpha_j`` (no
capacity), the components' K11b applies summed in component order, and in
the backward each component's K11b transpose and K5 on this rank's points
(ops/filter.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from ..ops.filter import (
    _filter_plain,
    _plan_from_tensors,
    _plan_tensors,
    apply_plan_any,
    build_plan_any,
    build_wide_plan_any,
    deriv_filter_grad,
    filter_backward,
    lattice_filter,
    lattice_filter_any,
    lattice_filter_exact_grad,
)
from ..ops.kernels import MixtureKernel
from ..ops.lattice import ChainPlan, build_plan_sharded_join
from .cg import cg_solve
from .lanczos import logdet_from_cg_tridiag, slq_logdet
from .pivoted_cholesky import (
    Preconditioner,
    make_preconditioner,
    pivoted_cholesky_features,
    precond_inv_sqrt,
    precond_solve,
    precond_sqrt,
)

__all__ = [
    "BBMMConfig",
    "build_precond",
    "LatticeInvQuadLogdet",
    "lattice_inv_quad_logdet",
    "lattice_nlml",
]


@dataclasses.dataclass(frozen=True)
class BBMMConfig:
    """Solver budget, mirroring the reference's gpytorch settings
    (train_simplexgp.py:34-37).

    ``slq_mode`` "cg" recovers the SLQ tridiagonals from the preconditioned
    CG that gives the solves (GPyTorch's single pass); "lanczos" runs the
    explicit reorthogonalized Lanczos.  ``grad_mode`` "exact" differentiates
    the operator actually applied (K5); "deriv_filter" is the reference's
    derivative-tap estimate of the dense kernel's gradient (K4 + K7).
    ``plan_capacity`` (None: n(d+1)) bounds the training plan's lattice
    table; measure the occupancy once (count_lattice_points) and leave
    headroom for lengthscale drift.  ``axis`` (a DataAxis, default None: one
    process) shards the rows over its ranks.
    """

    cg_tolerance: float = 1.0
    max_cg_iterations: int = 500
    max_lanczos_iterations: int = 100
    # Pivoted-Cholesky preconditioner rank; 0 disables.  Clamped to n - 1.  The CG's passes over the
    # preconditioner's U (kernels/cg.py::u_layout) take rank + num_probes + 1 <= 1024 and at most 256 groups
    # of outputs, ceil(rank / 4) (rank, if not a multiple of 4) times ceil((num_probes + 1) / 12): at 10
    # probes a rank up to 1,012 that is a multiple of 4, any other rank up to 255.  Past that the CG raises.
    precond_rank: int = 100
    num_probes: int = 10
    grad_mode: str = "exact"
    slq_mode: str = "cg"
    plan_capacity: Optional[int] = None
    axis: Optional[object] = None

    def __post_init__(self):
        if self.slq_mode not in ("cg", "lanczos"):
            raise ValueError(f"unknown slq_mode {self.slq_mode!r} (cg or lanczos)")
        if self.grad_mode not in ("exact", "deriv_filter"):
            raise ValueError(f"unknown grad_mode {self.grad_mode!r} (exact or deriv_filter)")


def build_precond(dk, config: BBMMConfig, params: dict, ref: torch.Tensor, n_global: int) -> Optional[Preconditioner]:
    """Rank-k pivoted-Cholesky preconditioner of K_hat from exact kernel columns.

    The columns are those of ``dk.nu``'s kernel (0: rbf, else Matern-nu); a
    MixtureKernel's nu is its Matern target, as JAX's kernel_value_jnp
    gives it (kernels.py:281-282).  Returns None when disabled or when rank
    >= n (dense regime).  With ``config.axis``, ref holds this rank's rows
    and n_global counts all.
    """
    rank = min(config.precond_rank, n_global - 1)
    if rank <= 0:
        return None
    s, noise = params["outputscale"], params["noise"]
    diag = s * torch.ones(ref.shape[0], dtype=torch.float32, device=ref.device)
    pc = pivoted_cholesky_features(ref, diag, dk.nu, s, rank, config.axis)
    return make_preconditioner(pc.L, noise, n_global, config.axis)


def _khat_matmul_diff(params: dict, x: torch.Tensor, dk, V: torch.Tensor, grad_mode: str = "exact",
                      capacity: Optional[int] = None, axis=None) -> torch.Tensor:
    """Differentiable K_hat(params) @ V; the filter's gradient per ``grad_mode`` (mll.py:92-113).

    With ``axis`` the sharded filter, always with the exact gradient
    (:95-106); a mixture always takes the exact gradient (:107-110).
    """
    ref = x * params["inv_ell"]
    if axis is not None:
        ky = lattice_filter_exact_grad(V, ref, dk, axis=axis)
    elif grad_mode == "exact" or isinstance(dk, MixtureKernel):
        ky = lattice_filter_any(V, ref, dk, capacity)
    else:
        ky = lattice_filter(V, ref, dk)
    return params["outputscale"] * ky + params["noise"] * V


class _System(NamedTuple):
    solves: torch.Tensor  # (n, 1+p): alpha and the probe solves
    logdet: torch.Tensor  # () log|K_hat| estimate
    probes_right: torch.Tensor  # (n, p) right vectors of the trace backward
    plan: tuple  # the CG's plan: a ChainPlan, a MixturePlan, a sharded WidePlan, or a mixture's tuple of them
    iterations: int  # CG iterations
    residual: torch.Tensor  # (1+p,) best relative residuals


def _n_global(config: BBMMConfig, n: int) -> int:
    """Rows over every rank (mll.py:178-180, :287-288)."""
    return n if config.axis is None else config.axis.n_global(n)


def _solve_system(dk, config: BBMMConfig, params: dict, x: torch.Tensor, y: torch.Tensor,
                  probes: torch.Tensor) -> _System:
    """Plan, preconditioner, CG solves and the log-det estimate (mll.py:159-240)."""
    axis = config.axis
    ref = x * params["inv_ell"]
    if axis is None:
        plan = build_plan_any(ref, dk, config.plan_capacity)
    elif isinstance(dk, MixtureKernel):  # one sharded plan per component, no capacity (mll.py:164-168)
        plan = tuple(build_plan_sharded_join(ref * a, dk.base.coeffs, dk.base.variance, axis) for a in dk.alphas)
    else:  # JAX's sharded plan has no capacity (mll.py:161-172)
        plan = build_plan_sharded_join(ref, dk.coeffs, dk.variance, axis)
    s, noise = params["outputscale"], params["noise"]

    def mv(V):
        return s * apply_plan_any(plan, V, dk, axis=axis) + noise * V

    n = _n_global(config, x.shape[0])
    P = build_precond(dk, config, params, ref, n)
    m = min(config.max_lanczos_iterations, n)
    if config.slq_mode == "cg":
        # One preconditioned CG over [y | P^{1/2} z] gives every solve and the
        # SLQ tridiagonals; log|K_hat| = log|P| + quadrature.  K10 applies the
        # shift s K + noise I and the Woodbury solve of P itself.
        b_probes = probes if P is None else precond_sqrt(P, probes, axis)
        res = cg_solve(lambda V: apply_plan_any(plan, V, dk, axis=axis), torch.cat([y[:, None], b_probes], dim=-1),
                       tol=config.cg_tolerance, max_iters=config.max_cg_iterations, precond=P,
                       tridiag_m=min(m, config.max_cg_iterations), axis=axis, shift=(s, noise))
        z_norm2 = (probes * probes).sum(dim=0)
        logdet = logdet_from_cg_tridiag(res.alphas[:, 1:], res.betas[:, 1:], res.tmask[:, 1:],
                                        z_norm2 if axis is None else axis.psum(z_norm2))
        if P is not None:
            logdet = logdet + P.logdet
        # E[(P^{-1} b) b^T] = I makes (K_hat^{-1} b)^T dK_hat (P^{-1} b) unbiased.
        probes_right = probes if P is None else precond_solve(P, b_probes, axis)
        return _System(res.x, logdet, probes_right, plan, res.iterations, res.residual_norm)

    res = cg_solve(lambda V: apply_plan_any(plan, V, dk, axis=axis), torch.cat([y[:, None], probes], dim=-1),
                   tol=config.cg_tolerance, max_iters=config.max_cg_iterations, precond=P, axis=axis,
                   shift=(s, noise))
    if P is None:
        logdet = slq_logdet(mv, probes, m, axis)
    else:
        # Preconditioned SLQ: log|K_hat| = log|P| + log|P^{-1/2} K_hat P^{-1/2}|.
        def mv_pre(V):
            return precond_inv_sqrt(P, mv(precond_inv_sqrt(P, V, axis)), axis)

        logdet = P.logdet + slq_logdet(mv_pre, probes, m, axis)
    return _System(res.x, logdet, probes, plan, res.iterations, res.residual_norm)


class LatticeInvQuadLogdet(torch.autograd.Function):
    """(y^T K_hat^{-1} y, log|K_hat|) with the closed-form backward of _iql_bwd.

    Differentiable in inv_ell (d,), outputscale (), noise () and the
    centered targets y (n,); x (n, d) and the Rademacher probes (n, p) get
    no gradient.  ``stats``, when a dict, receives the CG iteration count
    and mean final residual of the forward.  With ``config.axis`` both
    outputs are global and the backward's gradients are this rank's partial
    sums (JAX mll.py:267-269): the ranks' gradients add up to the whole.
    """

    @staticmethod
    def forward(ctx, inv_ell, outputscale, noise, y, x, probes, dk, config: BBMMConfig,
                stats: Optional[dict] = None):
        params = {"inv_ell": inv_ell, "outputscale": outputscale, "noise": noise}
        sys_ = _solve_system(dk, config, params, x, y, probes)
        alpha = sys_.solves[:, 0]
        if stats is not None:
            stats["cg_iters"] = sys_.iterations
            stats["cg_res"] = float(sys_.residual.mean())
        ctx.dk = dk
        ctx.grad_mode = config.grad_mode
        ctx.axis = config.axis
        ctx.capacity = config.plan_capacity
        ctx.plan_type = type(sys_.plan)
        # A chain plan is not kept: the exact backward builds a join plan (JAX re-filters).
        kept = () if isinstance(sys_.plan, ChainPlan) else _plan_tensors(sys_.plan)
        ctx.save_for_backward(inv_ell, outputscale, x, alpha, sys_.solves[:, 1:], sys_.probes_right, *kept)
        inv_quad = (y * alpha).sum()
        return inv_quad if config.axis is None else config.axis.psum(inv_quad), sys_.logdet

    @staticmethod
    def backward(ctx, a, b):
        inv_ell, s, x, alpha, z_solves, probes_right, *kept = ctx.saved_tensors
        p = probes_right.shape[-1]
        U = torch.cat([(-a) * alpha[:, None], (b / p) * z_solves], dim=-1)
        V = torch.cat([alpha[:, None], probes_right], dim=-1).contiguous()
        ref = x * inv_ell
        if ctx.grad_mode == "exact" or ctx.axis is not None or isinstance(ctx.dk, MixtureKernel):
            if kept:
                plan = _plan_from_tensors(ctx.plan_type, kept)
            else:  # the same positions and capacity as the CG's chain plan; an overflow trips both
                plan = build_wide_plan_any(ref.detach().contiguous(), ctx.dk, ctx.capacity)
            KV, table_f = apply_plan_any(plan, V, ctx.dk, return_table=True, axis=ctx.axis)
            # d/dref of s * K(ref) V against U: K5 with the cotangent s U.
            _, grad_ref = filter_backward(plan, ref, ctx.dk, V, s * U, table_f, ctx.axis)
        else:
            # lattice_filter's forward and derivative-tap backward, as JAX's
            # vjp of _khat_matmul_diff runs them: K4, then K7 against s U.
            KV = _filter_plain(V, ref, ctx.dk)
            grad_ref = deriv_filter_grad(ref, ctx.dk, V, s * U)
        grad_inv_ell = (x * grad_ref).sum(dim=0)
        grad_s = (U * KV).sum()
        grad_noise = (U * V).sum()
        grad_y = 2.0 * a * alpha
        return grad_inv_ell, grad_s, grad_noise, grad_y, None, None, None, None, None


def lattice_inv_quad_logdet(dk, config: BBMMConfig, params: dict, x: torch.Tensor, y: torch.Tensor,
                            probes: torch.Tensor, stats: Optional[dict] = None):
    """(y^T K_hat^{-1} y, log|K_hat|) for centered y; differentiable in params and y."""
    return LatticeInvQuadLogdet.apply(params["inv_ell"], params["outputscale"], params["noise"], y,
                                      x, probes, dk, config, stats)


def lattice_nlml(dk, config: BBMMConfig, params: dict, x: torch.Tensor, y: torch.Tensor,
                 probes: torch.Tensor, mean: Optional[torch.Tensor] = None,
                 stats: Optional[dict] = None) -> torch.Tensor:
    """Negative log marginal likelihood per datapoint (mll.py:278-292).

    The mean is subtracted outside the Function, so autograd carries
    d/d mean through the centered targets.  n is the global row count.
    """
    n = _n_global(config, y.shape[0])
    mu = params.get("mean", 0.0) if mean is None else mean
    inv_quad, logdet = lattice_inv_quad_logdet(dk, config, params, x, y - mu, probes, stats)
    return 0.5 * (inv_quad + logdet + n * math.log(2.0 * math.pi)) / n
