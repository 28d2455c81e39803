"""The data-sharded lattice filter: the plan over every rank's points, and its apply.

Port of simplex_gp_tpu/parallel/shard_filter.py (:118-155).  Each of P
ranks holds n_loc of the n = P n_loc input points:

  * the geometry (K1: elevation, simplex, barycentric weights, vertex hash
    pairs) is computed locally;
  * the hash pairs, 8 bytes per vertex, are all-gathered in rank order, so
    every rank holds the same N = n (d+1) global hashes and builds the same
    global plan from them with K11a, whose rows are numbered alike on every
    rank; each rank keeps its own window of the seg ids;
  * each rank lists its own contributions in row order over the global
    plan's n_lattice live rows, once per plan;
  * the apply (K11b) splats each rank's points into a partial table of the
    live rows, reduce-scatters it by column blocks, blurs one block per
    rank and all-gathers the blocks back; the slice reads this rank's
    points.

Per apply each rank sends and receives (P-1)/P of an (n_lattice, c_pad)
table (JAX's carries all M = n (d+1) rows, the dead ones too); per plan
build it gathers 8 bytes per vertex.

JAX's ``build_plan_sharded`` is the sort-chain engine (its column-split
apply_plan_chain branch, lattice.py:1040-1061).  The port's sort chain
(K3') runs on one device only, so the sharded plan here is the join
engine, as JAX's ``build_plan_sharded_join``, which lives beside the
single-device plan builders in ops/lattice.py and is re-exported here; the
sharded chain is queued (ROADMAP section 2).
"""

from __future__ import annotations

import torch

from ..ops.filter import lattice_filter_exact_grad
from ..ops.lattice import WidePlan, build_plan_sharded_join
from .comm import DataAxis

__all__ = ["build_plan_sharded", "build_plan_sharded_join", "filter_sharded"]


def build_plan_sharded(x_local: torch.Tensor, coeffs: tuple, blur_variance: float,
                       axis: DataAxis) -> WidePlan:
    """The sharded plan: :func:`build_plan_sharded_join` (JAX's is the sharded sort chain, not ported)."""
    return build_plan_sharded_join(x_local, coeffs, blur_variance, axis)


def filter_sharded(src_local: torch.Tensor, ref_local: torch.Tensor, dk, axis: DataAxis) -> torch.Tensor:
    """K(ref, ref) @ src with both sharded over ``axis``: this rank's rows of the product.

    Differentiable in src and ref by the exact operator gradient: the
    transposed sharded apply, then K5 on this rank's points
    (ops/filter.py ``LatticeFilterExactGrad``).
    """
    return lattice_filter_exact_grad(src_local, ref_local, dk, axis=axis)
