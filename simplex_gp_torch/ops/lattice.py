"""Permutohedral lattice filter, join formulation, in PyTorch.

The filter computes ``out = SLICE_NORM * S^T B S v``: S splats values onto the
permutohedral lattice with barycentric weights, B is the product of d+1
banded blurs along the lattice axes, and S^T slices back.  It approximates
``K(x, x) @ v`` for a stationary kernel (simplex_gp_tpu/ops/lattice.py).

A plan holds everything that depends only on positions, so a CG solve
builds it once and applies it many times.  There are two engines, as in JAX:

* the sort chain (:class:`ChainPlan`, :func:`build_plan_chain` /
  :func:`apply_plan_chain`, JAX's default plan and so :func:`build_plan`):
  every lattice axis splits the lattice into 1-D chains that sort into
  adjacent rows, so each axis blur is a stencil over neighbouring rows, and
  the move from one axis order to the next a fixed gather.  Built by K1
  (with the coordinate sums) and K3'a (chain_build), applied by K3'b-d
  (chain_splat, chain_axes: the d+1 axes in one launch, chain_slice), in
  :mod:`simplex_gp_torch.kernels.chain`, with no atomics, so two applies
  give the same bits.  The single-device CG runs on it.
* the join (:class:`LatticePlan`, build_plan_join / apply_plan_join): K1
  and K2 (lattice_dedup_neighbors: lattice rows and blur neighbours) build
  it, K3 (lattice_apply, atomic splat; a yardstick, on no model path)
  applies it; with its row lists (a :class:`WidePlan`, from
  :func:`build_wide_plan_join`: K1, then K2 and the rows in one host call)
  K9 applies it, K9 transposed and K5 differentiate it, all in
  :mod:`simplex_gp_torch.kernels.lattice`; the sharded plan of the
  data-parallel engine is K1, K11a and this rank's row lists over the live
  rows (a WidePlan), applied by K11b (``axis``).

Both compute the same operator (up to 64-bit hash collisions and the chain's
43-bit packed words, lattice.py:583-587), and both take the chain plan's
``capacity`` semantics (JAX's build_plan(capacity), :857-892): the table has
min(capacity, n(d+1)) rows, and an apply returns all NaN when more points
are occupied (:1093-1100).  :func:`apply_plan_cols` is K9, the join apply of
a wide value block a few columns at a time, on the plan's row lists (K9's
and K7's :class:`~simplex_gp_torch.kernels.lattice.JoinRows`); a
:class:`WidePlan` carries them beside a plan that K9 applies more than once.

:func:`filter_once` is the reference's one-shot ``filter``: K4 builds and
applies in one call, with no plan and an optional capacity bound (JAX's
filter_fused, which runs the sort chain; the same operator up to 64-bit hash
collisions).  :func:`count_lattice_points` is K8, K4's occupancy count.

A :class:`MixturePlan` is the plan of a Gaussian-mixture kernel: J
component plans of the scaled positions ``x * alpha_j`` (one K1 launch over
the stacked positions, then K2 per component), stacked into one table, with
the stacked table's row lists, and :func:`apply_plan_mixture` applies all J
components at once by K12 (``kernels/mixture.py``).

The host constants below are copied verbatim from the JAX module, where the
tests hold them equal.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..kernels.lattice import (
    JoinRows,
    join_rows,
    lattice_apply,
    lattice_apply_cols,
    lattice_apply_sharded,
    lattice_count,
    lattice_dedup_neighbors,
    lattice_dedup_ordered,
    lattice_filter_once,
    lattice_geometry,
    lattice_plan_rows,
    lattice_simplex,
    sharded_rows,
)
from ..kernels.chain import ChainPlan, chain_apply, chain_build
from ..kernels.mixture import lattice_mixture_apply, mixture_rows

__all__ = [
    "LatticePlan",
    "WidePlan",
    "ChainPlan",
    "MixturePlan",
    "SLICE_NORM",
    "build_rotation",
    "lattice_simplex",
    "build_plan",
    "apply_plan",
    "build_plan_chain",
    "apply_plan_chain",
    "build_plan_join",
    "build_plan_sharded_join",
    "apply_plan_join",
    "apply_plan_cols",
    "apply_plan_rows",
    "wide_plan",
    "build_wide_plan_join",
    "K9_WINDOW",
    "k9_window",
    "build_plan_mixture",
    "apply_plan_mixture",
    "mixture_component",
    "mixture_positions",
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


# Sort-chain constants (lattice.py:583-593).  s, the coordinate sum, is
# packed into the low 21 bits of the second chain word; its top 11 bits
# still identify the chain (43 hash bits in all).  JAX gives the table's pad
# rows the hash pair (_PAD_H1, _PAD_H2); the port gives them the sort key
# INT64_MAX instead, so that they sort last in every axis order
# (kernels/chain.py).
_S_BITS = 21
_S_BIAS = np.int32(1 << 20)
_S_MASK = np.int32((1 << _S_BITS) - 1)
_TOP_MASK = np.int32(-(1 << _S_BITS))  # ~_S_MASK
_PAD_H1 = np.int32(0x7FFFFFF1)
_PAD_H2 = np.int32(0x7FFFFFF2)


def _axis_dir(d: int):
    """Along-axis +1-tap key offset per lattice axis and its coordinate sum.

    Axis j < d: stored coordinate j moves by +d, all others by -1 (coordinate
    sum +1).  Axis d (the implicit coordinate): all stored coordinates move
    by -1 (coordinate sum -d).  Same geometry as permutohedral.h:539-541.
    """
    off = np.full((d + 1, d), -1, dtype=np.int64)
    for j in range(d):
        off[j, j] = d
    return off, off.sum(-1)  # (d+1, d), (d+1,)


def _chain_consts(d: int) -> np.ndarray:
    """(3, d+1) int32: the per-axis chain-word constants oh1, oh2 and mult of _chain_words (:648-663).

    For axis direction o, c(key) = s(o) h(key) - s(key) h(o) is constant
    along the chain {key + t o} by hash linearity (mod 2^32): oh = h(o),
    mult = s(o).
    """
    off, so = _axis_dir(d)
    a = _hash_vectors(d).astype(np.int64)
    wrap = lambda v: ((v & 0xFFFFFFFF).astype(np.uint32)).view(np.int32)
    return np.stack([wrap((off * a[0]).sum(-1)), wrap((off * a[1]).sum(-1)), so.astype(np.int32)])


class LatticePlan(NamedTuple):
    """Position-dependent, value-independent filter state, reusable across MVMs.

    Shapes: n points, d input dims, M lattice rows (n*(d+1), or a smaller
    capacity), r = order.
      seg_ids:   (n, d+1) int32   lattice row of each splat target
      weights:   (n, d+1) float32 barycentric splat/slice weights
      neighbors: (d+1, M, 2r) int32 blur gather indices (M == missing -> zero)
      n_lattice: () int32         number of occupied lattice points (> M: the
                                  capacity overflowed, and every apply is NaN)
    Row numbering is the engine's own (it differs between the kernel and the
    plain version, and from JAX's); n_lattice and the operator do not.
    """

    seg_ids: torch.Tensor
    weights: torch.Tensor
    neighbors: torch.Tensor
    n_lattice: torch.Tensor


class WidePlan(NamedTuple):
    """A join plan with its row lists (``rows``, built once), for a K9 that applies it more than once.

    The fields of :class:`LatticePlan`, then ``rows``; :func:`apply_plan_join`
    and :func:`apply_plan_cols` read them by name.
    """

    seg_ids: torch.Tensor
    weights: torch.Tensor
    neighbors: torch.Tensor
    n_lattice: torch.Tensor
    rows: JoinRows


class MixturePlan(NamedTuple):
    """The J component plans of a mixture kernel, stacked component-major (J M rows, M = n(d+1)).

      seg_ids:   (J, n, d+1) int32   stacked row j M + (component j's own row)
      weights:   (J, n, d+1) float32 barycentric weights at x * alpha_j
      neighbors: (d+1, J M, 2r) int32 each component's own row ids, M = missing
      live:      (J,) int32          each component's occupied row count
      rows:      JoinRows            the stacked table's row lists (kernels/mixture.py::mixture_rows),
                                     built once with the plan for every K12 apply of it
    Each component is an untrimmed plan as K2 built it: mixture plans ignore
    capacity (filter.py:174-176), and no row is renumbered.
    """

    seg_ids: torch.Tensor
    weights: torch.Tensor
    neighbors: torch.Tensor
    live: torch.Tensor
    rows: JoinRows


def _device_key(device) -> str:
    """``device`` with its index: a bare "cuda" is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return str(device)


@functools.lru_cache(maxsize=64)
def _constants_on(d: int, order: int, blur_variance: float, device: str) -> tuple:
    """(E, a, oh1, oh2, chain consts) on ``device``, built and copied once.  A copy from pageable host
    memory waits for the device's queue, so building them anew in every plan build stalled the host once
    per copy, in the middle of a training step.

    Read-only by contract: every plan build, K5 and the mixture backward
    get these same tensor objects, so an in-place edit by any caller would
    change every later plan.  A caller that must write takes a clone."""
    a = _hash_vectors(d)
    arrays = (build_rotation(d, blur_variance), a, *_offset_hashes(d, order, a), _chain_consts(d))
    return tuple(torch.from_numpy(t).to(device) for t in arrays)


def _lattice_constants(d: int, coeffs: tuple, blur_variance: float, device):
    """(E, a, oh1, oh2) on ``device``: elevation, hash multipliers, neighbour offset hashes.

    Cached per device (:func:`_constants_on`): the same tensors on every
    call, to be read and never written in place.
    """
    return _constants_on(d, (len(coeffs) - 1) // 2, float(blur_variance), _device_key(device))[:4]


def build_plan_chain(x: torch.Tensor, coeffs: tuple, blur_variance: float,
                     capacity: Optional[int] = None) -> ChainPlan:
    """Build the sort-chain plan for positions ``x`` (n, d) on ``x``'s device: K1 + K3'a.

    Port of lattice.py::build_plan_chain (:857).  ``capacity`` (None:
    n(d+1)) bounds the table as in :func:`build_plan_join`.  The taps must
    be symmetric (:872-874).
    """
    cs = np.asarray(coeffs, np.float64)
    if not np.allclose(cs, cs[::-1]):
        raise ValueError("chain plan requires symmetric filter taps")
    d = x.shape[1]
    E, a, _, _, consts = _constants_on(d, (len(coeffs) - 1) // 2, float(blur_variance), _device_key(x.device))
    h1, h2, weights, s = lattice_geometry(x.to(torch.float32).contiguous(), E, a, with_s=True)
    return chain_build(h1, h2, s, weights, consts, [float(c) for c in coeffs], capacity)


def apply_plan_chain(plan: ChainPlan, v: torch.Tensor, coeffs: tuple) -> torch.Tensor:
    """K(x, x) @ v for v (n, c) through a sort-chain plan: K3'b splat, d+1 K3'c axes, K3'd slice.

    Port of lattice.py::apply_plan_chain (:943) on one device; all NaN when
    the plan's capacity overflowed (:1093-1100).
    """
    dp1, order = plan.tapw.shape[:2]
    if len(coeffs) != 2 * order + 1:
        raise ValueError(f"{len(coeffs)} taps do not fit a plan of order {order}")
    return chain_apply(plan, v.to(torch.float32).contiguous(), [float(c) for c in coeffs], SLICE_NORM(dp1 - 1))


def build_plan(x: torch.Tensor, coeffs: tuple, blur_variance: float, capacity: Optional[int] = None) -> ChainPlan:
    """Default plan builder: the sort-chain plan (lattice.py:1298-1302)."""
    return build_plan_chain(x, coeffs, blur_variance, capacity)


def apply_plan(plan, v: torch.Tensor, coeffs: tuple) -> torch.Tensor:
    """Apply a ChainPlan or a LatticePlan, by its type (lattice.py:1305-1314)."""
    if isinstance(plan, ChainPlan):
        return apply_plan_chain(plan, v, coeffs)
    return apply_plan_join(plan, v, coeffs)


def build_plan_join(x: torch.Tensor, coeffs: tuple, blur_variance: float,
                    capacity: Optional[int] = None) -> LatticePlan:
    """Build the filter plan for positions ``x`` (n, d) on ``x``'s device: K1 + K2.

    ``capacity`` (None: n(d+1), the most a plan can occupy) bounds the
    table; pick it from :func:`count_lattice_points` with headroom.
    """
    n, d = x.shape
    E, a, oh1, oh2 = _lattice_constants(d, coeffs, blur_variance, x.device)
    h1, h2, weights = lattice_geometry(x.to(torch.float32).contiguous(), E, a)
    seg_ids, neighbors, n_lattice = lattice_dedup_neighbors(h1, h2, oh1, oh2, capacity)
    return LatticePlan(seg_ids.reshape(n, d + 1), weights, neighbors, n_lattice)


def mixture_positions(x: torch.Tensor, alphas) -> torch.Tensor:
    """The (J n, d) stacked component positions x * alpha_j, component-major."""
    x = x.to(torch.float32)
    return torch.cat([x * float(a) for a in alphas]).contiguous()


def build_plan_mixture(x: torch.Tensor, alphas, coeffs: tuple, blur_variance: float) -> MixturePlan:
    """The stacked plan of the J components at positions ``x * alpha_j``: one K1, then K2 per component.

    JAX builds one plan per component (filter.py:186-193); K1 is per point,
    so one launch covers the J n stacked positions, and each component's K2
    dedups its own n(d+1) hash pairs.  The stacking (seg offsets, weights,
    neighbours, live counts) and the row lists, built once from it, stay on
    the device.
    """
    n, d = x.shape
    J, N = len(alphas), n * (d + 1)
    E, a, oh1, oh2 = _lattice_constants(d, coeffs, blur_variance, x.device)
    h1, h2, weights = lattice_geometry(mixture_positions(x, alphas), E, a)
    segs, nbs, lives = [], [], []
    for j in range(J):
        seg, nb, live = lattice_dedup_neighbors(h1[j * N:(j + 1) * N], h2[j * N:(j + 1) * N], oh1, oh2)
        segs.append(seg + j * N)
        nbs.append(nb)
        lives.append(live)
    seg_ids, weights = torch.stack(segs).reshape(J, n, d + 1), weights.reshape(J, n, d + 1)
    neighbors, live = torch.cat(nbs, dim=1), torch.stack(lives)
    return MixturePlan(seg_ids, weights, neighbors, live, mixture_rows(seg_ids, weights, neighbors, live))


def apply_plan_mixture(plan: MixturePlan, v: torch.Tensor, coeffs: tuple, mix_weights, transpose: bool = False,
                       return_table: bool = False):
    """The mixture operator sum_j w_j K_j(x) @ v for v (n, c) through a stacked plan: K12.

    ``transpose`` applies the transpose (the axis blurs reversed);
    ``return_table`` returns ``(out, table)`` with the stacked blurred
    (J M, c) table before the slice, unweighted, which the backward reads.
    Every apply reads the plan's row lists.
    """
    d = plan.seg_ids.shape[2] - 1
    if len(coeffs) != plan.neighbors.shape[2] + 1:
        raise ValueError(f"{len(coeffs)} taps do not fit a plan of order {plan.neighbors.shape[2] // 2}")
    return lattice_mixture_apply(plan.seg_ids, plan.weights, plan.neighbors, plan.live,
                                 v.to(torch.float32).contiguous(), [float(c) for c in coeffs], SLICE_NORM(d),
                                 [float(w) for w in mix_weights], transpose, return_table, plan.rows)


def mixture_component(plan: MixturePlan, j: int) -> LatticePlan:
    """Component j of a stacked plan as a LatticePlan of its own (local rows; a copy of its neighbours)."""
    M = plan.neighbors.shape[1] // plan.seg_ids.shape[0]
    return LatticePlan(plan.seg_ids[j] - j * M, plan.weights[j].contiguous(),
                       plan.neighbors[:, j * M:(j + 1) * M].contiguous(), plan.live[j])


def build_plan_sharded_join(x_local: torch.Tensor, coeffs: tuple, blur_variance: float, axis) -> WidePlan:
    """The global join plan over every rank's points, with this rank's seg ids, weights and row lists.

    Port of simplex_gp_tpu/parallel/shard_filter.py::build_plan_sharded_join
    (:118-143).  ``axis`` is a DataAxis: K1 runs on this rank's points, the
    hash pairs are all-gathered in rank order, and K11a builds the global
    plan from them with rows numbered alike on every rank, the live ones
    first.  ``seg_ids`` (n_loc, d+1) and ``weights`` are this rank's points;
    ``neighbors`` (d+1, M, 2r) and ``n_lattice`` are the global plan's, the
    same bits on every rank (M = n_loc (d+1) P, untrimmed); ``rows`` are
    this rank's contributions over the n_lattice live rows
    (:func:`~simplex_gp_torch.kernels.lattice.sharded_rows`, one host read of
    n_lattice), built once for every K11b apply of the plan.  Every rank must
    pass the same number of points.
    """
    n_loc, d = x_local.shape
    dp1 = d + 1
    E, a, oh1, oh2 = _lattice_constants(d, coeffs, blur_variance, x_local.device)
    h1, h2, weights = lattice_geometry(x_local.to(torch.float32).contiguous(), E, a)
    seg_all, neighbors, n_lattice = lattice_dedup_ordered(axis.all_gather(h1), axis.all_gather(h2), oh1, oh2)
    start = axis.rank * n_loc * dp1
    seg_local = seg_all[start:start + n_loc * dp1].reshape(n_loc, dp1)
    return WidePlan(seg_local, weights, neighbors, n_lattice, sharded_rows(seg_local, weights, n_lattice))


def apply_plan_join(plan: LatticePlan, v: torch.Tensor, coeffs: tuple, transpose: bool = False,
                    return_table: bool = False, axis=None):
    """Apply the lattice kernel operator: out ~= K(x, x) @ v, for v (n, c): K3.

    ``transpose`` applies K^T (the axis blurs in reverse order), the
    operator's gradient in v; ``return_table`` returns ``(out, table)`` with
    the blurred (M, c) table before the slice.  With ``axis`` (a DataAxis),
    ``plan`` is a sharded plan (:func:`build_plan_sharded_join`, a
    :class:`WidePlan`), v holds this rank's rows, and the apply is K11b on
    the plan's row lists: the ranks' partial tables of the live rows are
    reduce-scattered by column blocks, blurred one block per rank and
    all-gathered back (:499-521); its table is (n_lattice, c).
    """
    d = plan.seg_ids.shape[1] - 1
    if len(coeffs) != plan.neighbors.shape[2] + 1:
        raise ValueError(f"{len(coeffs)} taps do not fit a plan of order {plan.neighbors.shape[2] // 2}")
    args = (plan.seg_ids, plan.weights, plan.neighbors, plan.n_lattice, v.to(torch.float32).contiguous(),
            [float(c) for c in coeffs], SLICE_NORM(d))
    if axis is not None:
        return lattice_apply_sharded(*args, axis, transpose, return_table,
                                     plan.rows if isinstance(plan, WidePlan) else None)
    return lattice_apply(*args, transpose, return_table)


# K9's column window on the card, a multiple of the caller's block: the fastest of 8, 16 and 32 columns
# at houseelectric on an H100 (kernel_times.py --wide-deriv; PERF.md section 6).  Columns do not
# interact, so the window does not change the result; the two (M, window) tables it keeps are the peak
# memory.
K9_WINDOW = 32


def k9_window(chunk: int) -> int:
    """K9's window for blocks of ``chunk`` columns: as many whole blocks as fit K9_WINDOW, at least one."""
    return chunk * max(1, K9_WINDOW // chunk)


def wide_plan(plan: LatticePlan) -> WidePlan:
    """``plan`` with its row lists, built now on its device."""
    return WidePlan(*plan, join_rows(*plan))


def build_wide_plan_join(x: torch.Tensor, coeffs: tuple, blur_variance: float,
                         capacity: Optional[int] = None) -> WidePlan:
    """``wide_plan(build_plan_join(x, ...))`` by K1 and one host call for the rest: K2 and the row lists
    on one workspace (:func:`~simplex_gp_torch.kernels.lattice.lattice_plan_rows`), nothing read on the
    host.  The same plan and rows, field for field."""
    n, d = x.shape
    E, a, oh1, oh2 = _lattice_constants(d, coeffs, blur_variance, x.device)
    h1, h2, weights = lattice_geometry(x.to(torch.float32).contiguous(), E, a)
    seg_ids, neighbors, n_lattice, rows = lattice_plan_rows(h1, h2, weights, oh1, oh2, capacity)
    return WidePlan(seg_ids, weights, neighbors, n_lattice, rows)


def apply_plan_rows(plan: WidePlan, v: torch.Tensor, coeffs: tuple, transpose: bool = False,
                    return_table: bool = False):
    """K3's operator on a join plan's row lists: K9 with one window of all v's c columns.

    The exact backward's applies (:func:`~simplex_gp_torch.ops.filter.filter_backward`): the
    same function as :func:`apply_plan_join`, ``transpose`` and ``return_table`` included,
    with K3'b's row-order splat and the live-row blur in place of K3's atomic splat, so two
    calls give the same bits.  The (M, c) tables are K3's.
    """
    d = plan.seg_ids.shape[1] - 1
    if len(coeffs) != plan.neighbors.shape[2] + 1:
        raise ValueError(f"{len(coeffs)} taps do not fit a plan of order {plan.neighbors.shape[2] // 2}")
    return lattice_apply_cols(plan.seg_ids, plan.weights, plan.neighbors, plan.n_lattice,
                              v.to(torch.float32).contiguous(), [float(c) for c in coeffs], SLICE_NORM(d),
                              max(1, v.shape[-1]), plan.rows, transpose, return_table)


def apply_plan_cols(plan, v: torch.Tensor, coeffs: tuple, chunk: int) -> torch.Tensor:
    """K @ v through a join plan for a wide v (n, c) in blocks of ``chunk`` columns: K9.

    The same operator as :func:`apply_plan_join`, with (M, w) tables in
    place of (M, c) ones (filter.py:65-117); the window w = k9_window(chunk)
    takes several of JAX's blocks at once (32 columns for its 8).  A
    :class:`WidePlan` brings its row lists; a :class:`LatticePlan`'s are
    built for this apply.
    """
    d = plan.seg_ids.shape[1] - 1
    if len(coeffs) != plan.neighbors.shape[2] + 1:
        raise ValueError(f"{len(coeffs)} taps do not fit a plan of order {plan.neighbors.shape[2] // 2}")
    return lattice_apply_cols(plan.seg_ids, plan.weights, plan.neighbors, plan.n_lattice,
                              v.to(torch.float32).contiguous(), [float(c) for c in coeffs], SLICE_NORM(d),
                              k9_window(chunk), plan.rows if isinstance(plan, WidePlan) else None)


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
