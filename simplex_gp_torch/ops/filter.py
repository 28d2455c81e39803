"""The lattice filter's entry points and its autograd bridges (reference L2).

Port of simplex_gp_tpu/ops/filter.py.  :func:`build_plan_any` keeps JAX's
dispatch (:186-193): the reusable plan of the CG solves is the sort-chain
plan (K1 + K3'a build, K3'b-d apply) for a DiscretizedKernel, and for a
MixtureKernel a tuple of J untrimmed chain plans, one a component at
``ref * alpha_j``; :func:`apply_plan_any` applies a plan by its type.
:func:`_filter_plain` keeps JAX's one-shot dispatch (:120-140): values of
up to ``_WIDE_COLS`` = 16 columns go to the one-shot filter K4
(``filter_once``); wider ones to the join plan (K1 + K2 build, K9 on its
row lists, one window of all the columns), or, above ``_JOIN_MAX_ROWS``
contribution rows n(d+1), to JAX's chunked chain: one chain plan, applied
to ``_WIDE_CHUNK``-column blocks by K3'b-d (:func:`lattice_filter_wide_chunked`,
:func:`make_wide_filter`).  ``capacity`` bounds the plan's table as in JAX
(:143-193).  :func:`make_wide_filter`, the range sketch's reusable filter,
applies a join plan by K9 on the plan's row lists below ``_JOIN_MAX_ROWS``
and the chunked chain above it (no atomics either way: two sketches give
the same bits).

Two gradients of ``K(ref, ref) @ src``:
  * :class:`LatticeFilterExactGrad` is the exact gradient of the operator
    actually applied, as JAX gets it by autodiff in
    ``lattice_filter_exact_grad`` (:143), written out: the gradient in the
    values is the transposed apply (K9 with the axis blurs reversed), and
    the gradient in the positions is K5 (``lattice_filter_grad``), which
    reads the forward's and the transposed apply's blurred tables.
    :func:`filter_backward` runs the same two on a sort-chain plan (JAX's
    autodiff through apply_plan_chain, lattice.py:943): the transposed
    chain apply (K3'c transposed) and K5 on the plan's ``slice_idx``, both
    tables in the chain's final row order.
  * :class:`LatticeFilter` (``lattice_filter``, :241-294) is the
    reference-parity gradient: grad_src is one more forward filter of the
    cotangent, and grad_ref is K7 (``lattice_deriv_grad``), one
    derivative-tap filter of [g, g*ref, src, src*ref] on a second plan,
    combined with the constant 2 k'(0) (JAX's fix of the reference's -2).

A :class:`~simplex_gp_torch.ops.kernels.MixtureKernel` takes the mixture
branches of the entry points, dispatched on its type as in JAX (:167-220).
The CG's plan is JAX's: one chain plan per component at ``ref * alpha_j``
(untrimmed: mixtures ignore ``capacity``), applied as the weighted sum of
the components' chain applies in component order, and differentiated per
component by the transposed chain apply and K5 at the component's
slice_idx, the position gradient sum_j w_j alpha_j K5_j
(:func:`_mixture_chain_backward`).  With ``axis`` the same on the sharded
chain (JAX's build_plan_sharded, ops/lattice.py::build_plan_sharded_chain;
mll.py:100-104, :164-168).  Where JAX's mixture takes a join plan (the
one-shot exact filter and the rect predict, the range sketch below
``_JOIN_MAX_ROWS``), the port takes the stacked
:class:`~simplex_gp_torch.ops.lattice.MixturePlan` of the components with
its row lists, applied by K12, its gradient the transposed K12 and K5 on
the stacked problem (:func:`mixture_position_grad`).  Above
``_JOIN_MAX_ROWS`` a wide block goes through one untrimmed chunked chain
per component, as JAX's make_wide_filter_any.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels.lattice import JoinRows, lattice_deriv_grad, lattice_filter_grad
from .kernels import DiscretizedKernel, MixtureKernel
from .lattice import (
    SLICE_NORM,
    ChainPlan,
    MixturePlan,
    WidePlan,
    _lattice_constants,
    apply_plan_chain,
    apply_plan_cols,
    apply_plan_join,
    apply_plan_rows,
    apply_plan_mixture,
    build_plan,
    build_plan_join,
    build_plan_mixture,
    build_plan_sharded_chain,
    build_wide_plan_join,
    filter_once,
    mixture_positions,
)

# Widest value block for the one-shot filter; wider blocks take the join plan
# (filter.py:54, :133).
_WIDE_COLS = 16
# Above this many contribution rows n(d+1) a wide block is applied by one
# chain plan in _WIDE_CHUNK-column blocks (filter.py:56-62): at the houseelectric
# eval's [train; val] plan of 19.7M rows the join plan's two (M, 101) tables
# would take 16 GB, two (M, 16) chain blocks 2.5 GB.
_JOIN_MAX_ROWS = 4 * 1024 * 1024
# JAX's blocks are 8 columns (filter.py:62); these are 16, K3'b's widest single
# pass.  Columns do not interact, so the output is the 8-column loop's bit for
# bit, and on an H100 the houseelectric eval's blocks (c = 100 and 101) took
# 7-8% less time (chip_smoke.py phase 15; PERF.md section 6).  Below
# _JOIN_MAX_ROWS it sets K9's window, k9_window(16) = 32 columns.
_WIDE_CHUNK = 16

__all__ = [
    "build_plan_any",
    "build_wide_plan_any",
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

    The sort-chain ChainPlan (JAX's build_plan), or for a MixtureKernel a
    tuple of J ChainPlans, one a component at ``ref * alpha_j``, untrimmed:
    mixture plans ignore ``capacity`` (filter.py:186-193, :174-176).
    """
    if isinstance(dk, MixtureKernel):
        return tuple(build_plan(ref * a, dk.base.coeffs, dk.base.variance) for a in dk.alphas)
    return build_plan(ref, dk.coeffs, dk.variance, capacity)


def build_wide_plan_any(ref: torch.Tensor, dk, capacity: Optional[int] = None):
    """The join-engine plan of ``dk`` at ``ref`` with its row lists: a WidePlan (K1, then K2 and the rows
    from one host call, :func:`~simplex_gp_torch.ops.lattice.build_wide_plan_join`), or a mixture's
    stacked MixturePlan, which holds its rows and ignores ``capacity``.

    The plan that K9 or K12 applies more than once, and :class:`LatticeFilterExactGrad`'s.
    """
    if isinstance(dk, MixtureKernel):
        return build_plan_mixture(ref, dk.alphas, dk.base.coeffs, dk.base.variance)
    return build_wide_plan_join(ref, dk.coeffs, dk.variance, capacity)


def apply_plan_any(plan, V: torch.Tensor, dk, transpose: bool = False, return_table: bool = False, axis=None):
    """K @ V (or K^T @ V) through a plan from :func:`build_plan_any` or :func:`build_wide_plan_any`.

    No outputscale or noise.  A ChainPlan applies by K3'b-d (apply_plan,
    lattice.py:1305-1314), transposed by K3'c transposed, its table in
    final row order; with ``axis`` it is this rank's part of a sharded chain
    plan and applies by the sharded chain apply (K3'b by column blocks, the
    collectives, K3'c on this rank's block, K3'd).  A mixture's tuple of
    chain plans applies as the weighted sum of its components' chain
    applies (:func:`_apply_mixture_chains`, filter.py:196-204).  A WidePlan
    (a join plan with its row lists) applies by K9 over one window of all
    V's columns, with no atomics; a mixture's stacked MixturePlan by K12.
    """
    if isinstance(dk, MixtureKernel) and not isinstance(plan, MixturePlan):
        return _apply_mixture_chains(plan, V, dk, transpose, return_table, axis)
    if axis is not None:
        return apply_plan_chain(plan, V, dk.coeffs, transpose, return_table, axis)
    if isinstance(plan, ChainPlan):
        return apply_plan_chain(plan, V, dk.coeffs, transpose, return_table)
    if isinstance(plan, WidePlan):
        return apply_plan_rows(plan, V, dk.coeffs, transpose, return_table)
    if isinstance(plan, MixturePlan):
        return apply_plan_mixture(plan, V, dk.base.coeffs, dk.weights, transpose, return_table)
    return apply_plan_join(plan, V, dk.coeffs, transpose, return_table)


def _weighted_sum(weights, terms) -> torch.Tensor:
    """sum_j w_j term_j, added in component order as JAX's mixture loops (filter.py:178-182, :199-203)."""
    out = None
    for w, term in zip(weights, terms):
        out = w * term if out is None else out + w * term
    return out


def _apply_mixture_chains(plans: tuple, V: torch.Tensor, dk: MixtureKernel, transpose: bool, return_table: bool,
                          axis):
    """sum_j w_j K_j @ V (or K_j^T) over a mixture's chain plans, one device's or this rank's sharded parts,
    summed in component order as JAX's apply_plan_any (filter.py:196-204); with ``return_table`` also the
    components' final-order tables, unweighted, as a tuple."""
    if not return_table:
        return _weighted_sum(dk.weights, (apply_plan_chain(plan, V, dk.base.coeffs, transpose, False, axis)
                                          for plan in plans))
    res = [apply_plan_chain(plan, V, dk.base.coeffs, transpose, True, axis) for plan in plans]
    return _weighted_sum(dk.weights, (out for out, _ in res)), tuple(table for _, table in res)


def _chunked(n: int, d: int, c: int) -> bool:
    """JAX's third branch (filter.py:133-135): more than 16 columns over more than _JOIN_MAX_ROWS rows."""
    return c > _WIDE_COLS and n * (d + 1) > _JOIN_MAX_ROWS


def _apply_chain_blocks(plan: ChainPlan, V: torch.Tensor, coeffs: tuple) -> torch.Tensor:
    """K @ V through one chain plan, ``_WIDE_CHUNK`` columns at a time (JAX's lax.map over the blocks,
    filter.py:77-84): each block copied contiguous, applied by K3'b-d and written into its columns of the
    output.  Columns do not interact, so the blocks give the apply of all the columns bit for bit; the
    peak is the plan and one block's two (Mc, _WIDE_CHUNK) tables."""
    out = torch.empty(V.shape, dtype=torch.float32, device=V.device)
    for c0 in range(0, V.shape[-1], _WIDE_CHUNK):
        out[:, c0:c0 + _WIDE_CHUNK] = apply_plan_chain(plan, V[:, c0:c0 + _WIDE_CHUNK], coeffs)
    return out


def apply_plan_wide(plan, V: torch.Tensor, dk) -> torch.Tensor:
    """K @ V for a wide V through the plan :func:`make_wide_filter` built, by its type.

    A ChainPlan (above ``_JOIN_MAX_ROWS``) by K3'b-d in ``_WIDE_CHUNK``-column
    blocks, a mixture's tuple of them as the weighted sum of the components'
    block applies (make_wide_filter_any, filter.py:207-220).  Below it a
    :class:`WidePlan` (a join plan with its row lists) by K9 in windows of
    K9_WINDOW columns, and a mixture's MixturePlan by K12 on its row lists.
    JAX applies its join branch whole; the operator is the same, and on an
    H100 windows of 32 took the elevators range sketch (c = 100) 0.86-0.87
    ms against 0.90-0.91 for one window of 100 (kernel_times.py
    --mixture-sketch; PERF.md section 6).
    """
    if isinstance(plan, ChainPlan):
        return _apply_chain_blocks(plan, V, dk.coeffs)
    if type(plan) is tuple:
        return _weighted_sum(dk.weights, (_apply_chain_blocks(p, V, dk.base.coeffs) for p in plan))
    if isinstance(plan, MixturePlan):
        return apply_plan_mixture(plan, V, dk.base.coeffs, dk.weights)
    return apply_plan_cols(plan, V, dk.coeffs, _WIDE_CHUNK)


def lattice_filter_wide_chunked(src: torch.Tensor, ref: torch.Tensor, dk: DiscretizedKernel,
                                capacity: Optional[int] = None) -> torch.Tensor:
    """K(ref, ref) @ src for a wide src at very large n (filter.py:65-84): one chain plan, untrimmed unless
    given ``capacity``, applied in ``_WIDE_CHUNK``-column blocks.

    Peak memory is the plan and one block's two (Mc, _WIDE_CHUNK) tables,
    whatever the column count.  No gradient (the differentiable route is
    :func:`lattice_filter_exact_grad`, which takes the same branch).
    """
    return _apply_chain_blocks(build_plan(ref, dk.coeffs, dk.variance, capacity), src, dk.coeffs)


def make_wide_filter(ref: torch.Tensor, dk, capacity: Optional[int] = None):
    """Reusable ``mv(V) -> K(ref, ref) @ V`` for wide value blocks (filter.py:87-117, :207-220).

    One plan, built now, so the range sketch's two MVMs share one build,
    applied by :func:`apply_plan_wide`.  Above ``_JOIN_MAX_ROWS`` the chain
    plan with ``capacity``, or a mixture's J untrimmed chain plans, applied
    in ``_WIDE_CHUNK``-column blocks; below it, untrimmed as JAX's join
    branch, a join plan with its row lists (a :class:`WidePlan`, K9) or a
    mixture's stacked plan, rows and all (K12).
    """
    if ref.shape[0] * (ref.shape[-1] + 1) > _JOIN_MAX_ROWS:
        plan = build_plan_any(ref, dk, capacity)
    else:
        plan = build_wide_plan_any(ref, dk)
    return lambda V: apply_plan_wide(plan, V, dk)


def mixture_position_grad(plan: MixturePlan, ref: torch.Tensor, dk: MixtureKernel, src: torch.Tensor,
                          g: torch.Tensor, table_f: torch.Tensor, table_b: torch.Tensor) -> torch.Tensor:
    """The gradient of ``<g, K_mix(ref) @ src>`` in ref (n, d) on a stacked MixturePlan: K5 on the stacked problem.

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
    E = _lattice_constants(d, dk.base.coeffs, dk.base.variance, ref.device)[0]
    src = src.to(torch.float32).contiguous()
    stacked = lattice_filter_grad(mixture_positions(ref, dk.alphas), E, plan.seg_ids.reshape(J * n, dp1),
                                  src.repeat(J, 1), g.repeat(J, 1), table_f, table_b, SLICE_NORM(d))
    scale = torch.tensor([w * a for w, a in zip(dk.weights, dk.alphas)], dtype=torch.float32, device=ref.device)
    return (scale[:, None, None] * stacked.reshape(J, n, d)).sum(dim=0)


def _plan_tensors(plan) -> tuple:
    """A plan's tensors, flat (for ``save_for_backward``): a WidePlan's or a MixturePlan's four fields, then
    its rows; a tuple of chain plans (a mixture's), one after another."""
    if isinstance(plan, (WidePlan, MixturePlan)):
        return (*plan[:4], *plan.rows)
    if type(plan) is tuple:
        return tuple(t for component in plan for t in _plan_tensors(component))
    return tuple(plan)


# Tensors of one flattened ChainPlan.
_CHAIN_TENSORS = len(ChainPlan._fields)


def _plan_from_tensors(plan_type, tensors) -> tuple:
    """The plan of ``plan_type`` that :func:`_plan_tensors` flattened."""
    if plan_type in (WidePlan, MixturePlan):
        return plan_type(*tensors[:4], JoinRows(*tensors[4:]))
    if plan_type is tuple:
        return tuple(ChainPlan(*tensors[i:i + _CHAIN_TENSORS]) for i in range(0, len(tensors), _CHAIN_TENSORS))
    return plan_type(*tensors)


def _mixture_chain_backward(plans: tuple, ref: torch.Tensor, dk: MixtureKernel, src: torch.Tensor,
                            g: torch.Tensor, tables_f: tuple, axis=None):
    """(grad_src, grad_ref) of ``<g, sum_j w_j K_j(ref alpha_j) @ src>`` on a mixture's chain plans.

    Component by component, in order, as JAX's autodiff of the component sum
    (filter.py:196-204; sharded, mll.py:100-104): the transposed chain apply
    of the cotangent w_j g (K3'c transposed; sharded, it splats every rank's
    rows), then K5 at ref alpha_j, at the component's slice_idx, with that
    cotangent and the component's two final-order tables; the position
    gradient is chained through ref alpha_j, so it is multiplied by alpha_j.
    """
    d = ref.shape[1]
    E = _lattice_constants(d, dk.base.coeffs, dk.base.variance, ref.device)[0]
    src = src.to(torch.float32).contiguous()
    grad_src = grad_ref = None
    for w, a, plan, table_f in zip(dk.weights, dk.alphas, plans, tables_f):
        g_j = (w * g).contiguous()
        gs, table_b = apply_plan_chain(plan, g_j, dk.base.coeffs, True, True, axis)
        gr = a * lattice_filter_grad((ref * a).to(torch.float32).contiguous(), E, plan.slice_idx, src, g_j, table_f,
                                     table_b, SLICE_NORM(d))
        grad_src = gs if grad_src is None else grad_src + gs
        grad_ref = gr if grad_ref is None else grad_ref + gr
    return grad_src, grad_ref


def filter_backward(plan, ref: torch.Tensor, dk, src: torch.Tensor, g: torch.Tensor, table_f: torch.Tensor,
                    axis=None):
    """(grad_src, grad_ref) of ``<g, K(ref) @ src>``: the transposed apply, then K5.

    ``table_f`` is the blurred table of the forward apply of ``src`` on
    ``plan`` (``apply_plan_any(..., return_table=True)``).  A single
    kernel's plan on one device is a :class:`ChainPlan` (the NLML's, the
    CG's own plan) or a :class:`WidePlan`: the transposed apply is the
    chain's (splat, K3'c transposed, slice) or K9's on its row lists, with
    no atomics either way, so the gradient repeats bit for bit (K5 reads
    only live rows, and the row-order splat writes every one).  K5 reads a
    chain plan's tables at ``slice_idx``, both in final row order.  A bare
    join plan takes K3's transposed apply.  With ``axis``
    the plan is this rank's part of a sharded chain plan: the transposed
    apply is the sharded chain's, which splats every rank's g, and K5 runs
    on this rank's points at its slice_idx against the two global
    (n_lattice, c) final-order tables, so grad_ref holds this rank's rows
    of the whole gradient.  A mixture's tuple of chain plans, one device's
    or sharded, runs :func:`_mixture_chain_backward` (``table_f`` the tuple
    of its components' tables); its stacked MixturePlan the transposed K12
    and :func:`mixture_position_grad`.
    """
    d = ref.shape[1]
    g = g.to(torch.float32).contiguous()
    if isinstance(dk, MixtureKernel) and not isinstance(plan, MixturePlan):
        return _mixture_chain_backward(plan, ref, dk, src, g, table_f, axis)
    grad_src, table_b = apply_plan_any(plan, g, dk, transpose=True, return_table=True, axis=axis)
    if isinstance(plan, MixturePlan):
        return grad_src, mixture_position_grad(plan, ref, dk, src, g, table_f, table_b)
    E = _lattice_constants(d, dk.coeffs, dk.variance, ref.device)[0]
    seg_ids = plan.slice_idx if isinstance(plan, ChainPlan) else plan.seg_ids
    grad_ref = lattice_filter_grad(ref.to(torch.float32).contiguous(), E, seg_ids,
                                   src.to(torch.float32).contiguous(), g, table_f, table_b, SLICE_NORM(d))
    return grad_src, grad_ref


class LatticeFilterExactGrad(torch.autograd.Function):
    """K(ref, ref) @ src with its exact gradient in both src and ref.

    Forward: one plan build (with its row lists: a :class:`WidePlan`) and
    one apply that keeps its blurred table (K9 over one window of all
    columns), or, for a wide src above ``_JOIN_MAX_ROWS``, JAX's chunked
    chain: one chain plan applied in ``_WIDE_CHUNK``-column blocks, which
    keeps no table.  Backward: :func:`filter_backward` on the same plan,
    so the positions are not hashed twice and no apply adds with atomics;
    after the chunked chain it runs per block (each block's chain apply
    again, for its table, then the transposed chain apply and K5 at the
    plan's slice_idx), and the position gradients of the blocks add up.
    With ``axis`` (a DataAxis; src and ref this rank's rows) the plan is
    this rank's part of the sharded chain plan and the applies are the
    sharded chain's, the transposed one included, as JAX's autodiff
    transposes the collectives of filter_sharded (shard_filter.py:146-155);
    no capacity, no chunking.  A MixtureKernel builds its stacked plan and
    applies it by K12, keeping the stacked table; no capacity, no chunking
    (:func:`lattice_filter_exact_grad` sends a wide block above
    ``_JOIN_MAX_ROWS`` elsewhere).  Second derivatives are not defined (as
    in JAX's custom VJP filter).
    """

    @staticmethod
    def forward(ctx, src: torch.Tensor, ref: torch.Tensor, dk, capacity: Optional[int] = None, axis=None):
        if isinstance(dk, MixtureKernel):
            plan = build_wide_plan_any(ref, dk)
            out, table_f = apply_plan_any(plan, src, dk, return_table=True)
        elif axis is not None:
            plan = build_plan_sharded_chain(ref, dk.coeffs, dk.variance, axis)
            out, table_f = apply_plan_any(plan, src, dk, return_table=True, axis=axis)
        elif _chunked(*ref.shape, src.shape[-1]):
            plan = build_plan(ref, dk.coeffs, dk.variance, capacity)
            out, table_f = _apply_chain_blocks(plan, src, dk.coeffs), None
        else:
            plan = build_wide_plan_join(ref, dk.coeffs, dk.variance, capacity)
            out, table_f = apply_plan_any(plan, src, dk, return_table=True)
        ctx.dk = dk
        ctx.axis = axis
        ctx.plan_type = type(plan)
        ctx.save_for_backward(src, ref, table_f, *_plan_tensors(plan))
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        src, ref, table_f, *plan = ctx.saved_tensors
        plan = _plan_from_tensors(ctx.plan_type, plan)
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
    sharded one (``capacity`` does not apply).  A mixture with ``axis``, or
    with a wide src above ``_JOIN_MAX_ROWS``, is the weighted sum of its
    components' filters at ``ref * alpha_j`` (each sharded, or the untrimmed
    chunked chain), differentiated by autograd through the sum and the
    scaling (filter.py:177-182; JAX's sharded mixture, mll.py:100-104).
    """
    if isinstance(dk, MixtureKernel) and (axis is not None or _chunked(*ref.shape, src.shape[-1])):
        return _weighted_sum(dk.weights, (LatticeFilterExactGrad.apply(src, ref * a, dk.base, None, axis)
                                          for a in dk.alphas))
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

    K4 up to 16 columns; wider, the chunked chain above ``_JOIN_MAX_ROWS``
    rows, else a join plan with its row lists and K9 over one window of all
    the columns (JAX's join apply; no atomics, so the same bits twice).  JAX's
    ``capacity`` argument is left out: no caller here trims these filters.
    """
    if src.shape[-1] > _WIDE_COLS:
        if _chunked(*ref.shape, src.shape[-1]):
            return lattice_filter_wide_chunked(src, ref, dk)
        return apply_plan_rows(build_wide_plan_join(ref, dk.coeffs, dk.variance), src, dk.coeffs)
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
