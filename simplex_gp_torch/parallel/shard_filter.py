"""The data-sharded lattice filter: the plan over every rank's points, and its apply.

Port of simplex_gp_tpu/parallel/shard_filter.py.  Each of P ranks holds
n_loc of the n = P n_loc input points.  :func:`build_plan_sharded` is JAX's
default, the sharded sort chain (:50-115), applied by the column-split
branch of apply_plan_chain (lattice.py:1029-1061):

  * the geometry (K1: elevation, simplex, barycentric weights, vertex hash
    pairs and coordinate sums) is computed locally;
  * the (h1, h2, s) triples, 12 bytes per vertex, are all-gathered in rank
    order, so every rank holds the same N = n (d+1) global triples and
    builds the same global chain plan from them with K3'a (rows, axis
    transitions, taps and n_lattice the same bits on every rank); each rank
    keeps its own contributions' splat lists in the global row order, its
    run ends over the n_lattice live rows, and its slice_idx window
    (ops/lattice.py::build_plan_sharded_chain);
  * the apply splats each rank's points into a partial table of the live
    rows by column blocks (K3'b), reduce-scatters it, runs the d+1 fused
    axes (K3'c) on one block per rank, all-gathers the blocks back,
    rejoins them into one table and slices this rank's points (K3'd)
    (kernels/chain.py::chain_apply_sharded); transposed, the same two
    collectives around the transposed axes.

Per apply each rank sends and receives (P-1)/P of an (n_lattice, c_pad)
table: the chain sorts its dead rows last on every axis, so the live rows
stay together, and JAX's collectives carry all M = n (d+1) rows, the dead
ones too; per plan build it gathers 12 bytes per vertex.

``build_plan_sharded_join`` keeps the join engine, as JAX does (:118), for
differential testing: K1, the all-gather of the hash pairs (8 bytes per
vertex), K11a's global plan with rows numbered alike on every rank, this
rank's row lists over the live rows, applied by K11b
(ops/lattice.py::apply_plan_join with ``axis``).
"""

from __future__ import annotations

import torch

from ..ops.filter import lattice_filter_exact_grad
from ..ops.lattice import ChainPlan, build_plan_sharded_chain, build_plan_sharded_join
from .comm import DataAxis

__all__ = ["build_plan_sharded", "build_plan_sharded_join", "filter_sharded"]


def build_plan_sharded(x_local: torch.Tensor, coeffs: tuple, blur_variance: float,
                       axis: DataAxis) -> ChainPlan:
    """The sharded plan: this rank's part of the sort-chain plan over every rank's points
    (:func:`~simplex_gp_torch.ops.lattice.build_plan_sharded_chain`)."""
    return build_plan_sharded_chain(x_local, coeffs, blur_variance, axis)


def filter_sharded(src_local: torch.Tensor, ref_local: torch.Tensor, dk, axis: DataAxis) -> torch.Tensor:
    """K(ref, ref) @ src with both sharded over ``axis``: this rank's rows of the product.

    Differentiable in src and ref by the exact operator gradient: the
    transposed sharded chain apply, then K5 on this rank's points at its
    slice_idx (ops/filter.py ``LatticeFilterExactGrad``).
    """
    return lattice_filter_exact_grad(src_local, ref_local, dk, axis=axis)
