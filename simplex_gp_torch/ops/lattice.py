"""Permutohedral lattice filter, join formulation, in PyTorch.

The filter computes ``out = SLICE_NORM * S^T B S v``: S splats values onto the
permutohedral lattice with barycentric weights, B is the product of d+1
banded blurs along the lattice axes, and S^T slices back.  It approximates
``K(x, x) @ v`` for a stationary kernel (simplex_gp_tpu/ops/lattice.py).

A :class:`LatticePlan` holds everything that depends only on positions, so
a CG solve builds it once and applies it many times.  The plan is built by
K1 (lattice_geometry: vertex hashes and weights) and K2
(lattice_dedup_neighbors: lattice rows and blur neighbours), and applied by
K3 (lattice_apply), all in :mod:`simplex_gp_torch.kernels.lattice`.  This is
the JAX package's join engine (build_plan_join / apply_plan_join); the TPU's
sort-chain engine is not ported, because the card's gathers and atomics are
fast where the TPU's are not.

:func:`filter_once` is the reference's one-shot ``filter``: K4 builds and
applies in one call, with no plan and an optional capacity bound (JAX's
filter_fused, which runs the sort chain; the same operator up to 64-bit hash
collisions).  :func:`count_lattice_points` is K8, K4's occupancy count.

The host constants below are copied verbatim from the JAX module, where the
tests hold them equal.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..kernels.lattice import (
    lattice_apply,
    lattice_count,
    lattice_dedup_neighbors,
    lattice_filter_once,
    lattice_geometry,
    lattice_simplex,
)

__all__ = [
    "LatticePlan",
    "SLICE_NORM",
    "build_rotation",
    "lattice_simplex",
    "build_plan_join",
    "apply_plan_join",
    "filter_once",
    "count_lattice_points",
]


def SLICE_NORM(d: int) -> float:
    """Slice normalization constant 1/(1 + 2^-d) (permutohedral.h:507)."""
    return 1.0 / (1.0 + 2.0 ** (-d))


def build_rotation(d: int, blur_variance: float) -> np.ndarray:
    """(d+1) x d elevation matrix E with calibrated scale folded in.

    ``elevated = x @ E.T`` reproduces the reference's per-point recurrence
    (permutohedral.h:397-402) with scale factors
    ``(d+1) * sqrt(var + 1/6) / sqrt((i+1)(i+2))`` (permutohedral.h:371-391):
    the lattice spacing is calibrated so splat+blur+slice has the variance of
    a unit Gaussian per input dimension.
    """
    scale = np.array(
        [(d + 1) * math.sqrt(blur_variance + 1.0 / 6.0) / math.sqrt((i + 1) * (i + 2)) for i in range(d)],
        dtype=np.float64,
    )
    E = np.zeros((d + 1, d), dtype=np.float64)
    for j in range(d):
        sx = np.zeros(d)
        sx[j] = scale[j]
        elevated = np.zeros(d + 1)
        elevated[d] = -d * sx[d - 1]
        for i in range(d - 1, 0, -1):
            elevated[i] = elevated[i + 1] - i * sx[i - 1] + (i + 2) * sx[i]
        elevated[0] = elevated[1] + 2 * sx[0]
        E[:, j] = elevated
    return E.astype(np.float32)


def _canonical_simplex(d: int) -> np.ndarray:
    """Canonical simplex vertex table, (d+1) remainders x (d+1) ranks (permutohedral.h:364-369)."""
    can = np.zeros((d + 1, d + 1), dtype=np.int32)
    for i in range(d + 1):
        can[i, : d + 1 - i] = i
        can[i, d + 1 - i :] = i - (d + 1)
    return can


def _hash_vectors(d: int, seed: int = 0x5171) -> np.ndarray:
    """Two independent odd int32 multiplier vectors for multiply-shift hashing."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, size=(2, d), dtype=np.uint32) | 1
    return a.view(np.int32)


def _axis_offsets(d: int, order: int) -> np.ndarray:
    """Neighbor key offsets: (d+1 axes, 2*order taps, d coords).

    Along lattice axis j, the neighbor at signed distance t has key
    ``key - t`` in every stored coordinate except coordinate j, which gets
    ``key[j] + t*d`` (permutohedral.h:539-541; axis j == d touches only the
    implicit last coordinate, so all stored coords get -t).
    """
    taps = [t for t in range(-order, order + 1) if t != 0]
    off = np.zeros((d + 1, len(taps), d), dtype=np.int32)
    for j in range(d + 1):
        for ti, t in enumerate(taps):
            off[j, ti, :] = -t
            if j < d:
                off[j, ti, j] = t * d
    return off


def _offset_hashes(d: int, order: int, a: np.ndarray):
    """Hash pair of every neighbour offset, (d+1, 2r) int32 each (lattice.py:414-418)."""
    offsets = _axis_offsets(d, order).astype(np.int64)
    a64 = a.astype(np.int64)
    wrap = lambda h: ((h & 0xFFFFFFFF).astype(np.uint32)).view(np.int32)
    return wrap((offsets * a64[0]).sum(-1)), wrap((offsets * a64[1]).sum(-1))


class LatticePlan(NamedTuple):
    """Position-dependent, value-independent filter state, reusable across MVMs.

    Shapes: n points, d input dims, M = n*(d+1) lattice capacity, r = order.
      seg_ids:   (n, d+1) int32   lattice row of each splat target
      weights:   (n, d+1) float32 barycentric splat/slice weights
      neighbors: (d+1, M, 2r) int32 blur gather indices (M == missing -> zero)
      n_lattice: () int32         number of occupied lattice points (<= M)
    Row numbering is the engine's own (it differs between the kernel and the
    plain version, and from JAX's); n_lattice and the operator do not.
    """

    seg_ids: torch.Tensor
    weights: torch.Tensor
    neighbors: torch.Tensor
    n_lattice: torch.Tensor


def _lattice_constants(d: int, coeffs: tuple, blur_variance: float, device):
    """(E, a, oh1, oh2) on ``device``: elevation, hash multipliers, neighbour offset hashes."""
    a = _hash_vectors(d)
    E = torch.from_numpy(build_rotation(d, blur_variance)).to(device)
    oh1, oh2 = (torch.from_numpy(o).to(device) for o in _offset_hashes(d, (len(coeffs) - 1) // 2, a))
    return E, torch.from_numpy(a).to(device), oh1, oh2


def build_plan_join(x: torch.Tensor, coeffs: tuple, blur_variance: float) -> LatticePlan:
    """Build the filter plan for positions ``x`` (n, d) on ``x``'s device: K1 + K2."""
    n, d = x.shape
    E, a, oh1, oh2 = _lattice_constants(d, coeffs, blur_variance, x.device)
    h1, h2, weights = lattice_geometry(x.to(torch.float32).contiguous(), E, a)
    seg_ids, neighbors, n_lattice = lattice_dedup_neighbors(h1, h2, oh1, oh2)
    return LatticePlan(seg_ids.reshape(n, d + 1), weights, neighbors, n_lattice)


def apply_plan_join(plan: LatticePlan, v: torch.Tensor, coeffs: tuple, transpose: bool = False,
                    return_table: bool = False):
    """Apply the lattice kernel operator: out ~= K(x, x) @ v, for v (n, c): K3.

    ``transpose`` applies K^T (the axis blurs in reverse order), the
    operator's gradient in v; ``return_table`` returns ``(out, table)`` with
    the blurred (M, c) table before the slice, which the filter's backward
    (K5) reads.
    """
    d = plan.seg_ids.shape[1] - 1
    if len(coeffs) != plan.neighbors.shape[2] + 1:
        raise ValueError(f"{len(coeffs)} taps do not fit a plan of order {plan.neighbors.shape[2] // 2}")
    return lattice_apply(
        plan.seg_ids, plan.weights, plan.neighbors, plan.n_lattice,
        v.to(torch.float32).contiguous(), [float(c) for c in coeffs], SLICE_NORM(d),
        transpose, return_table,
    )


def filter_once(src: torch.Tensor, ref: torch.Tensor, coeffs: tuple, blur_variance: float,
                capacity: Optional[int] = None) -> torch.Tensor:
    """One-shot filter(src, ref, coeffs) of src (n, c) at positions ref (n, d): K4.

    Port of lattice.py::filter_once (:529).  ``capacity`` bounds the lattice
    table (None: n(d+1), the most a filter can occupy); when more points are
    occupied the output is all NaN, as JAX's guard (:1295).  Pick it from
    :func:`count_lattice_points`.
    """
    cs = np.asarray(coeffs, np.float64)
    if not np.allclose(cs, cs[::-1]):
        raise ValueError("one-shot filter requires symmetric filter taps")
    n, d = ref.shape
    M = n * (d + 1)
    E, a, oh1, oh2 = _lattice_constants(d, coeffs, blur_variance, ref.device)
    out, _ = lattice_filter_once(
        ref.to(torch.float32).contiguous(), E, a, oh1, oh2, src.to(torch.float32).contiguous(),
        [float(c) for c in coeffs], SLICE_NORM(d), M if capacity is None else min(capacity, M),
    )
    return out


def count_lattice_points(x: torch.Tensor, blur_variance: float, coeffs: tuple = (0.5, 1.0, 0.5)) -> torch.Tensor:
    """Number of occupied lattice points of positions ``x`` (n, d), a 0-d int32 tensor: K8.

    Port of lattice.py::count_lattice_points (:839), with its signature
    (``coeffs`` does not change the count).
    """
    E, a, _, _ = _lattice_constants(x.shape[1], coeffs, blur_variance, x.device)
    return lattice_count(x.to(torch.float32).contiguous(), E, a)
