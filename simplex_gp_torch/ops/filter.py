"""The lattice filter's entry points and its autograd bridges (reference L2).

Port of simplex_gp_tpu/ops/filter.py.  :func:`_filter_plain` keeps JAX's
dispatch (:120-140): values of up to ``_WIDE_COLS`` = 16 columns go to the
one-shot filter K4 (``filter_once``); wider ones to the join plan (K1 + K2
build, K3 apply), or, above ``_JOIN_MAX_ROWS`` contribution rows n(d+1), to one plan applied
``_WIDE_CHUNK`` columns at a time by K9 (:func:`lattice_filter_wide_chunked`,
:func:`make_wide_filter`; JAX's chunked sort-chain filter, here the join
plan, so the same operator up to 64-bit hash collisions).  ``capacity``
bounds the plan's table as in JAX (:143-193).

Two gradients of ``K(ref, ref) @ src``:
  * :class:`LatticeFilterExactGrad` is the exact gradient of the operator
    actually applied, as JAX gets it by autodiff in
    ``lattice_filter_exact_grad`` (:143), written out: the gradient in the
    values is the transposed apply (K3 with the axis blurs reversed), and
    the gradient in the positions is K5 (``lattice_filter_grad``), which
    reads the forward's and the transposed apply's blurred tables.
  * :class:`LatticeFilter` (``lattice_filter``, :241-294) is the
    reference-parity gradient: grad_src is one more forward filter of the
    cotangent, and grad_ref is K7 (``lattice_deriv_grad``), one
    derivative-tap filter of [g, g*ref, src, src*ref] on a second plan,
    combined with the constant 2 k'(0) (JAX's fix of the reference's -2).

A :class:`~simplex_gp_torch.ops.kernels.MixtureKernel` takes the mixture
branches of the entry points, dispatched on its type as in JAX (:167-220):
its plan is the stacked :class:`~simplex_gp_torch.ops.lattice.MixturePlan`
of the J components at ``ref * alpha_j`` (untrimmed: mixtures ignore
``capacity``), applied by K12; its gradient is always the exact one, the
transposed K12 and K5 on the stacked problem, with the position gradient
sum_j w_j alpha_j K5_j.  A wide value block above ``_JOIN_MAX_ROWS`` goes
through K9 one component at a time, as JAX's make_wide_filter_any.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels.lattice import lattice_deriv_grad, lattice_filter_grad
from .kernels import DiscretizedKernel, MixtureKernel
from .lattice import (
    SLICE_NORM,
    LatticePlan,
    MixturePlan,
    apply_plan_cols,
    apply_plan_join,
    apply_plan_mixture,
    build_plan_join,
    build_plan_mixture,
    build_plan_sharded_join,
    build_rotation,
    filter_once,
    mixture_component,
    mixture_positions,
)

# Widest value block for the one-shot filter; wider blocks take the join plan
# (filter.py:54, :133).
_WIDE_COLS = 16
# Above this many contribution rows n(d+1) a wide block is applied in
# _WIDE_CHUNK-column windows (filter.py:61-62): two (M, 101) tables of the
# houseelectric eval would take 16 GB, two (M, 8) ones 1.3 GB.
_JOIN_MAX_ROWS = 4 * 1024 * 1024
_WIDE_CHUNK = 8

__all__ = [
    "build_plan_any",
    "apply_plan_any",
    "apply_plan_wide",
    "lattice_filter_wide_chunked",
    "make_wide_filter",
    "filter_backward",
    "mixture_position_grad",
    "LatticeFilterExactGrad",
    "lattice_filter_exact_grad",
    "lattice_filter_any",
    "lattice_filter_rect",
    "deriv_filter_grad",
    "LatticeFilter",
    "lattice_filter",
]


def build_plan_any(ref: torch.Tensor, dk, capacity: Optional[int] = None):
    """Reusable filter plan of ``dk`` at positions ``ref``; pair with :func:`apply_plan_any`.

    A LatticePlan, or for a MixtureKernel the stacked MixturePlan of its
    components, which ignores ``capacity`` (filter.py:186-193).
    """
    if isinstance(dk, MixtureKernel):
        return build_plan_mixture(ref, dk.alphas, dk.base.coeffs, dk.base.variance)
    return build_plan_join(ref, dk.coeffs, dk.variance, capacity)


def apply_plan_any(plan, V: torch.Tensor, dk, transpose: bool = False, return_table: bool = False, axis=None):
    """K @ V (or K^T @ V) through a plan from :func:`build_plan_any`, or a sharded plan with ``axis``.

    No outputscale or noise.  A mixture applies all its components by K12
    (filter.py:196-204); the sharded engine takes no mixture.
    """
    if isinstance(dk, MixtureKernel):
        if axis is not None:
            raise NotImplementedError("the sharded filter takes one DiscretizedKernel, not a mixture")
        return apply_plan_mixture(plan, V, dk.base.coeffs, dk.weights, transpose, return_table)
    return apply_plan_join(plan, V, dk.coeffs, transpose, return_table, axis)


def _chunked(n: int, d: int, c: int) -> bool:
    """JAX's third branch (filter.py:133-135): more than 16 columns over more than _JOIN_MAX_ROWS rows."""
    return c > _WIDE_COLS and n * (d + 1) > _JOIN_MAX_ROWS


def apply_plan_wide(plan, V: torch.Tensor, dk) -> torch.Tensor:
    """K @ V through a plan, engine by JAX's dispatch: K9 for a wide block on a large plan, else K3.

    A mixture's plan goes to K12, or above ``_JOIN_MAX_ROWS`` to K9 one
    component at a time (make_wide_filter_any, filter.py:207-220).
    """
    n, dp1 = plan.seg_ids.shape[-2:]
    chunked = _chunked(n, dp1 - 1, V.shape[-1])
    if isinstance(dk, MixtureKernel):
        if not chunked:
            return apply_plan_mixture(plan, V, dk.base.coeffs, dk.weights)
        return sum(w * apply_plan_cols(mixture_component(plan, j), V, dk.base.coeffs, _WIDE_CHUNK)
                   for j, w in enumerate(dk.weights))
    if chunked:
        return apply_plan_cols(plan, V, dk.coeffs, _WIDE_CHUNK)
    return apply_plan_join(plan, V, dk.coeffs)


def lattice_filter_wide_chunked(src: torch.Tensor, ref: torch.Tensor, dk: DiscretizedKernel,
                                capacity: Optional[int] = None) -> torch.Tensor:
    """K(ref, ref) @ src for a wide src at very large n (filter.py:65-84): one plan, K9.

    Peak memory is the plan and two (M, _WIDE_CHUNK) tables, whatever the
    column count.  No gradient (the differentiable route is
    :func:`lattice_filter_exact_grad`, which takes the same branch).
    """
    return apply_plan_cols(build_plan_any(ref, dk, capacity), src, dk.coeffs, _WIDE_CHUNK)


def make_wide_filter(ref: torch.Tensor, dk, capacity: Optional[int] = None):
    """Reusable ``mv(V) -> K(ref, ref) @ V`` for wide value blocks (filter.py:87-117).

    One plan, built now: above ``_JOIN_MAX_ROWS`` with ``capacity`` and
    applied by K9; below, untrimmed and applied by K3, as JAX's join branch.
    A mixture builds its stacked plan (K12), or above ``_JOIN_MAX_ROWS`` one
    untrimmed K9 filter per component (make_wide_filter_any, :207-220).
    """
    large = ref.shape[0] * (ref.shape[-1] + 1) > _JOIN_MAX_ROWS
    if isinstance(dk, MixtureKernel) and large:
        mvs = [make_wide_filter(ref * a, dk.base) for a in dk.alphas]
        return lambda V: sum(w * f(V) for w, f in zip(dk.weights, mvs))
    plan = build_plan_any(ref, dk, capacity if large else None)
    return lambda V: apply_plan_wide(plan, V, dk)


def mixture_position_grad(plan: MixturePlan, ref: torch.Tensor, dk: MixtureKernel, src: torch.Tensor,
                          g: torch.Tensor, table_f: torch.Tensor, table_b: torch.Tensor) -> torch.Tensor:
    """The gradient of ``<g, K_mix(ref) @ src>`` in ref (n, d): K5 on the stacked problem.

    K5 runs once over the J n stacked points ``ref * alpha_j`` with the
    stacked seg ids (j M + row) into the stacked blurred tables of the
    forward (``table_f`` = B_j S_j src) and the transposed apply
    (``table_b`` = B_j^T S_j g), both unweighted, and src and g repeated per
    component.  Component j's gradient enters with its weight w_j and,
    through the scaled positions, alpha_j: grad_ref = sum_j w_j alpha_j
    K5_j, as JAX's autodiff of sum_j w_j filter(src, ref * alpha_j) gives.
    """
    J, n, dp1 = plan.seg_ids.shape
    d = dp1 - 1
    E = torch.from_numpy(build_rotation(d, dk.base.variance)).to(ref.device)
    src = src.to(torch.float32).contiguous()
    stacked = lattice_filter_grad(mixture_positions(ref, dk.alphas), E, plan.seg_ids.reshape(J * n, dp1),
                                  src.repeat(J, 1), g.repeat(J, 1), table_f, table_b, SLICE_NORM(d))
    scale = torch.tensor([w * a for w, a in zip(dk.weights, dk.alphas)], dtype=torch.float32, device=ref.device)
    return (scale[:, None, None] * stacked.reshape(J, n, d)).sum(dim=0)


def filter_backward(plan, ref: torch.Tensor, dk, src: torch.Tensor, g: torch.Tensor, table_f: torch.Tensor,
                    axis=None):
    """(grad_src, grad_ref) of ``<g, K(ref) @ src>``: transposed K3, then K5.

    ``table_f`` is the blurred table of the forward apply of ``src`` on
    ``plan`` (``apply_plan_any(..., return_table=True)``).  With ``axis``
    the plan is sharded: the transposed apply is K11b's, which splats every
    rank's g, and K5 runs on this rank's points against the two global
    tables, so grad_ref holds this rank's rows of the whole gradient.  A
    mixture runs the transposed K12 and :func:`mixture_position_grad`.
    """
    d = ref.shape[1]
    g = g.to(torch.float32).contiguous()
    grad_src, table_b = apply_plan_any(plan, g, dk, transpose=True, return_table=True, axis=axis)
    if isinstance(dk, MixtureKernel):
        return grad_src, mixture_position_grad(plan, ref, dk, src, g, table_f, table_b)
    E = torch.from_numpy(build_rotation(d, dk.variance)).to(ref.device)
    grad_ref = lattice_filter_grad(ref.to(torch.float32).contiguous(), E, plan.seg_ids,
                                   src.to(torch.float32).contiguous(), g, table_f, table_b, SLICE_NORM(d))
    return grad_src, grad_ref


class LatticeFilterExactGrad(torch.autograd.Function):
    """K(ref, ref) @ src with its exact gradient in both src and ref.

    Forward: one plan build and one apply that keeps its blurred table, or,
    for a wide src above ``_JOIN_MAX_ROWS``, K9, which keeps none.
    Backward: :func:`filter_backward` on the same plan, so the positions are
    not hashed twice; after K9 it runs per ``_WIDE_CHUNK``-column window
    (each window's apply again, for its table), and the position gradients
    of the windows add up.  With ``axis`` (a DataAxis; src and ref this
    rank's rows) the plan is the sharded one and the applies are K11b's, the
    transposed one included, as JAX's autodiff transposes the collectives
    of filter_sharded (shard_filter.py:146-155); no capacity, no chunking.
    A MixtureKernel builds its stacked plan and applies it by K12, keeping
    the stacked table; no capacity, no chunking (:func:`lattice_filter_exact_grad`
    sends a wide block above ``_JOIN_MAX_ROWS`` elsewhere).  Second
    derivatives are not defined (as in JAX's custom VJP filter).
    """

    @staticmethod
    def forward(ctx, src: torch.Tensor, ref: torch.Tensor, dk, capacity: Optional[int] = None, axis=None):
        if isinstance(dk, MixtureKernel):
            plan = build_plan_any(ref, dk)
            out, table_f = apply_plan_any(plan, src, dk, return_table=True)
        elif axis is not None:
            plan = build_plan_sharded_join(ref, dk.coeffs, dk.variance, axis)
            out, table_f = apply_plan_any(plan, src, dk, return_table=True, axis=axis)
        else:
            plan = build_plan_any(ref, dk, capacity)
            if _chunked(*ref.shape, src.shape[-1]):
                out, table_f = apply_plan_cols(plan, src, dk.coeffs, _WIDE_CHUNK), None
            else:
                out, table_f = apply_plan_any(plan, src, dk, return_table=True)
        ctx.dk = dk
        ctx.axis = axis
        ctx.plan_type = type(plan)
        ctx.save_for_backward(src, ref, table_f, *plan)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        src, ref, table_f, *plan = ctx.saved_tensors
        plan = ctx.plan_type(*plan)
        if table_f is not None:
            grad_src, grad_ref = filter_backward(plan, ref, ctx.dk, src, g, table_f, ctx.axis)
            return grad_src, grad_ref, None, None, None
        grad_src, grad_ref = [], 0.0
        for c0 in range(0, src.shape[-1], _WIDE_CHUNK):
            s_k = src[:, c0:c0 + _WIDE_CHUNK].to(torch.float32).contiguous()
            _, t_k = apply_plan_any(plan, s_k, ctx.dk, return_table=True)
            gs_k, gr_k = filter_backward(plan, ref, ctx.dk, s_k, g[:, c0:c0 + _WIDE_CHUNK], t_k)
            grad_src.append(gs_k)
            grad_ref = grad_ref + gr_k
        return torch.cat(grad_src, dim=-1), grad_ref, None, None, None


def lattice_filter_exact_grad(src: torch.Tensor, ref: torch.Tensor, dk, capacity: Optional[int] = None,
                              axis=None) -> torch.Tensor:
    """K(ref, ref) @ src, differentiable in src and ref by the exact operator gradient.

    With ``axis``, src and ref are this rank's rows and the filter is the
    sharded one (``capacity`` does not apply).  A mixture with a wide src
    above ``_JOIN_MAX_ROWS`` is the weighted sum of its components' filters
    at ``ref * alpha_j`` (each K9), differentiated by autograd through the
    sum and the scaling (filter.py:177-182).
    """
    if isinstance(dk, MixtureKernel) and axis is None and _chunked(*ref.shape, src.shape[-1]):
        return sum(w * LatticeFilterExactGrad.apply(src, ref * a, dk.base, None, None)
                   for w, a in zip(dk.weights, dk.alphas))
    return LatticeFilterExactGrad.apply(src, ref, dk, capacity, axis)


def lattice_filter_any(src: torch.Tensor, ref: torch.Tensor, dk, capacity: Optional[int] = None) -> torch.Tensor:
    """K(ref, ref) @ src for a DiscretizedKernel or a MixtureKernel: one plan build and one apply.

    Differentiable by the exact operator gradients in both cases
    (filter.py:167-183); ``capacity`` applies to a single kernel's plan only.
    """
    return lattice_filter_exact_grad(src, ref, dk, capacity)


def lattice_filter_rect(src: torch.Tensor, x_from: torch.Tensor, x_to: torch.Tensor, dk) -> torch.Tensor:
    """Cross-covariance MVM ``K(x_to, x_from) @ src`` via the zero-pad trick.

    Joint-filters ``[src; 0]`` over the concatenated positions
    ``[x_from; x_to]`` and keeps the x_to rows (the reference's
    RectangularLazyLattice._matmul, bilateral_kernel.py:150-156).
    """
    n_from = x_from.shape[0]
    x_large = torch.cat([x_from, x_to], dim=0)
    v_large = torch.cat([src, src.new_zeros((x_to.shape[0], src.shape[-1]))], dim=0)
    return lattice_filter_any(v_large, x_large, dk)[n_from:]


def _filter_plain(src: torch.Tensor, ref: torch.Tensor, dk: DiscretizedKernel) -> torch.Tensor:
    """K(ref, ref) @ src, untrimmed, engine by width and size (filter.py:120-140).

    K4 up to 16 columns; wider, K9 above ``_JOIN_MAX_ROWS`` rows, else a
    join plan and K3.  JAX's ``capacity`` argument is left out: no caller
    here trims these filters.
    """
    if src.shape[-1] > _WIDE_COLS:
        if _chunked(*ref.shape, src.shape[-1]):
            return lattice_filter_wide_chunked(src, ref, dk)
        return apply_plan_join(build_plan_join(ref, dk.coeffs, dk.variance), src, dk.coeffs)
    return filter_once(src, ref, dk.coeffs, dk.variance)


def deriv_filter_grad(ref: torch.Tensor, dk: DiscretizedKernel, src: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The reference-parity gradient of ``<g, K(ref) @ src>`` in ref (n, d) (filter.py:269-290).

    Builds the derivative plan (K1 + K2 with ``dk.deriv_coeffs`` and
    ``dk.deriv_variance``) and runs K7 with the constant 2 k'(0).
    """
    ref = ref.to(torch.float32).contiguous()
    plan = build_plan_join(ref, dk.deriv_coeffs, dk.deriv_variance)
    return lattice_deriv_grad(plan.seg_ids, plan.weights, plan.neighbors, plan.n_lattice, ref,
                              src.to(torch.float32).contiguous(), g.to(torch.float32).contiguous(),
                              [float(c) for c in dk.deriv_coeffs], SLICE_NORM(ref.shape[1]),
                              2.0 * dk.dk0)


class LatticeFilter(torch.autograd.Function):
    """K(ref, ref) @ src with the reference's gradients (filter.py:241-294).

    Forward: :func:`_filter_plain`.  Backward, each half only when asked for:
    grad_src = K g, one more forward filter with the forward taps (JAX's fix
    2: the reference reuses the derivative filter, exact only for RBF), and
    grad_ref from :func:`deriv_filter_grad`.  Second derivatives are not
    defined.
    """

    @staticmethod
    def forward(ctx, src: torch.Tensor, ref: torch.Tensor, dk: DiscretizedKernel):
        ctx.dk = dk
        ctx.save_for_backward(src, ref)
        return _filter_plain(src, ref, dk)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        src, ref = ctx.saved_tensors
        grad_src = _filter_plain(g, ref, ctx.dk) if ctx.needs_input_grad[0] else None
        grad_ref = deriv_filter_grad(ref, ctx.dk, src, g) if ctx.needs_input_grad[1] else None
        return grad_src, grad_ref, None


def lattice_filter(src: torch.Tensor, ref: torch.Tensor, dk: DiscretizedKernel) -> torch.Tensor:
    """K(ref, ref) @ src, differentiable in src and ref by the reference-parity gradients."""
    return LatticeFilter.apply(src, ref, dk)
