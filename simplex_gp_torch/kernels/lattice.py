"""Lattice kernels K1-K5, K7-K9 and K11a-b: wrappers over the CUDA kernels, beside their plain versions.

Each wrapper takes the plain PyTorch version for CPU tensors and launches its
kernel (``csrc/geometry.cu``, ``csrc/dedup.cu``, ``csrc/apply.cu``,
``csrc/grad.cu``, ``csrc/once.cu``, ``csrc/deriv.cu``) for CUDA tensors,
raising on a failed build or launch; there is no fallback.  Each counts its
launches in a ``launches`` attribute.  The plain versions are the PyTorch
twin of the JAX join engine (simplex_gp_tpu/ops/lattice.py) and run on
either device.

K9, K7, K11b and K4 run on row lists (:class:`JoinRows`, built by
:func:`join_rows`, :func:`lattice_plan_rows` with its plan, :func:`sharded_rows`
or inside K4, all by ``csrc/join_rows.cu``'s one row build): each row's
contributions in row order, summed by the sort chain's splat (K3'b,
``kernels/chain.py``) with no atomics, then a blur over the live rows only.
Their plain versions sum in the kernels' order, so the two agree bit for
bit.  The exact backward runs K9 too, one window of all its columns,
forward and transposed, keeping the table.  K3 (``lattice_apply``, an
atomic splat) is on no model path; it stays as a yardstick.

Integer hashes are int32 wrapping mod 2^32, as XLA's are; PyTorch has no
wrapping int32 product, so the plain versions compute in int64 and mask.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build
from .chain import _carve, _long_bounds, chain_splat_plain, run_lists

__all__ = [
    "lattice_simplex",
    "hash_pair",
    "geometry_plain",
    "lattice_geometry",
    "dedup_neighbors_plain",
    "lattice_dedup_neighbors",
    "dedup_ordered_plain",
    "lattice_dedup_ordered",
    "apply_plain",
    "lattice_apply",
    "JoinRows",
    "join_rows_plain",
    "join_rows",
    "join_rows_device",
    "rows_key_bits",
    "lattice_plan_rows",
    "apply_cols_plain",
    "lattice_apply_cols",
    "sharded_rows",
    "apply_sharded_plain",
    "lattice_apply_sharded",
    "lattice_filter_grad_plain",
    "lattice_filter_grad",
    "filter_once_plain",
    "lattice_filter_once",
    "count_plain",
    "lattice_count",
    "deriv_grad_plain",
    "lattice_deriv_grad",
]

_MASK32 = 0xFFFFFFFF


def _wrap32(h: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 with the same low 32 bits (two's complement)."""
    return (((h & _MASK32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def _elevate(x: torch.Tensor, E: torch.Tensor) -> torch.Tensor:
    """x @ E.T summed sequentially over the input dims, unfused (K1's order)."""
    acc = x[:, 0:1] * E[:, 0]
    for k in range(1, x.shape[1]):
        acc = acc + x[:, k : k + 1] * E[:, k]
    return acc


def _simplex_rank(elevated: torch.Tensor, d: int):
    """(greedy_div (n, d+1) int32, rank (n, d+1) int32) of elevated points.

    The nearest remainder-0 lattice point and the rank of each differential
    after the off-hyperplane repair (lattice.py:157-182).  Both are piecewise
    constant in the positions and carry no gradient.
    """
    dp1 = d + 1
    v = elevated * (1.0 / dp1)
    up = torch.ceil(v)
    down = torch.floor(v)
    pick_up = (up * dp1 - elevated) < (elevated - down * dp1)
    greedy_div = torch.where(pick_up, up, down).to(torch.int32)
    coord_sum = greedy_div.sum(dim=-1, dtype=torch.int32)

    diff = elevated - greedy_div.to(elevated.dtype) * dp1
    di = diff[:, :, None]
    dj = diff[:, None, :]
    idx = torch.arange(dp1, device=elevated.device)
    beats = (dj > di) | ((dj == di) & (idx[None, :] < idx[:, None]))
    rank = beats.sum(dim=-1, dtype=torch.int32)

    r2 = rank + coord_sum[:, None]
    too_hi = (r2 > d).to(torch.int32)
    too_lo = (r2 < 0).to(torch.int32)
    return greedy_div - too_hi + too_lo, r2 - dp1 * too_hi + dp1 * too_lo


def lattice_simplex(x: torch.Tensor, E: torch.Tensor):
    """Enclosing-simplex geometry: (keys (n, d+1, d) int32, weights (n, d+1) f32).

    Port of simplex_gp_tpu/ops/lattice.py::lattice_simplex (:141), with the
    canonical simplex table ``can[v][r] = v if r < d+1-v else v-(d+1)``
    (_canonical_simplex, :132) evaluated in place.  Differentiable in ``x``
    through the barycentric weights, as JAX's autodiff sees it.
    """
    n, d = x.shape
    dp1 = d + 1
    elevated = _elevate(x, E)
    greedy_div, rank = _simplex_rank(elevated, d)
    greedy = greedy_div * dp1

    t = (elevated - greedy.to(elevated.dtype)) * (1.0 / dp1)
    zeros = torch.zeros((n, d + 2), dtype=t.dtype, device=x.device)
    plus = zeros.scatter(1, (d - rank).long(), t)
    minus = zeros.scatter(1, (d + 1 - rank).long(), t)
    bary = plus - minus
    # bary[0] += 1 + bary[d+1], in JAX's order of the two adds (lattice.py:190).
    weights = torch.cat([bary[:, :1] + (1.0 + bary[:, d + 1 :]), bary[:, 1:dp1]], dim=1)

    rem = torch.arange(dp1, device=x.device, dtype=torch.int32)[None, :, None]
    can_sel = torch.where(rank[:, None, :d] < dp1 - rem, rem, rem - dp1)
    keys = greedy[:, None, :d] + can_sel  # (n, d+1, d)
    return keys, weights


def hash_pair(flat: torch.Tensor, a: torch.Tensor):
    """Linear hash pair h_j = sum_i a_ji k_i (mod 2^32) of int key rows (N, d)."""
    f = flat.long()
    a64 = a.long()
    return _wrap32((f * a64[0]).sum(-1)), _wrap32((f * a64[1]).sum(-1))


def geometry_plain(x: torch.Tensor, E: torch.Tensor, a: torch.Tensor, with_s: bool = False):
    """(h1, h2 (n(d+1),) int32, weights (n, d+1) f32): plain K1 (_point_hashes, :330).

    ``with_s`` appends s (n(d+1),) int32, the sum of each vertex key's d
    stored coordinates (_geometry_hs, :353-384).
    """
    n, d = x.shape
    keys, weights = lattice_simplex(x, E)
    flat = keys.reshape(n * (d + 1), d)
    h1, h2 = hash_pair(flat, a)
    return (h1, h2, weights, flat.sum(-1, dtype=torch.int32)) if with_s else (h1, h2, weights)


def lattice_geometry(x: torch.Tensor, E: torch.Tensor, a: torch.Tensor, with_s: bool = False):
    """K1: per-point hash pairs of the d+1 simplex vertices, and barycentric weights (and s: ``with_s``).

    On the card a team of lanes a point (``csrc/geometry.cu``).
    """
    if not x.is_cuda:
        return geometry_plain(x, E, a, with_s)
    out = _geometry_launch(x, E, a, with_s, per_thread=False)
    lattice_geometry.launches += 1
    return out


def _geometry_per_thread(x: torch.Tensor, E: torch.Tensor, a: torch.Tensor, with_s: bool = False):
    """K1's first kernel, a thread a point, the same bits as :func:`lattice_geometry`: the team kernel's
    yardstick on the card (chip_smoke.py, kernel_times.py, the card tests), on no model path."""
    return _geometry_launch(x, E, a, with_s, per_thread=True)


def _geometry_launch(x, E, a, with_s: bool, per_thread: bool):
    n, d = x.shape
    if d + 1 > 64:
        raise ValueError(f"lattice_geometry: d={d} exceeds the kernel's limit of 63")
    build.require("lattice_geometry", (x, torch.float32), (E, torch.float32), (a, torch.int32))
    lib = build.library()
    h1 = torch.empty(n * (d + 1), dtype=torch.int32, device=x.device)
    h2 = torch.empty_like(h1)
    s = torch.empty_like(h1) if with_s else None
    w = torch.empty((n, d + 1), dtype=torch.float32, device=x.device)
    rc = lib.sgp_lattice_geometry(x.data_ptr(), E.data_ptr(), a.data_ptr(), n, d, h1.data_ptr(),
                                  h2.data_ptr(), w.data_ptr(), None if s is None else s.data_ptr(), int(per_thread),
                                  build.stream())
    build.check(rc, "lattice_geometry")
    return (h1, h2, w, s) if with_s else (h1, h2, w)


lattice_geometry.launches = 0


def _pack(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """Order-preserving int64 key of (h1 signed, h2 unsigned)."""
    return h1.long() * 2**32 | (h2.long() & _MASK32)


def _rows(N: int, capacity) -> int:
    """Table rows M of a plan over N contributions: min(capacity, N), or N untrimmed."""
    if capacity is None:
        return N
    if capacity < 1:
        raise ValueError(f"capacity {capacity} is below 1")
    return min(int(capacity), N)


def _neighbor_rows(keys, row_keys, oh1, oh2):
    """(d+1, 2r, rows) positions in the sorted ``keys`` of each row's neighbour keys, and hit flags.

    The neighbour of a key (u1, u2) along axis j at tap t has the key
    (u1 + oh1[j, t], u2 + oh2[j, t]) mod 2^32, by hash linearity.
    """
    u1 = row_keys >> 32
    u2 = row_keys & _MASK32
    q1 = _wrap32(u1[None, None, :] + oh1.long()[:, :, None]).long()
    q2 = (u2[None, None, :] + oh2.long()[:, :, None]) & _MASK32
    q = q1 * 2**32 | q2  # (d+1, 2r, rows)
    pos = torch.searchsorted(keys, q)
    return pos, keys[pos.clamp(max=keys.shape[0] - 1)] == q


def dedup_neighbors_plain(h1, h2, oh1, oh2, capacity=None):
    """Plain K2 (_plan_tables, :387) by sort-unique and binary search.

    Returns seg_ids (N,) int32, neighbors (d+1, M, 2r) int32 with M for a
    missing neighbour (and for every row past the live count), and
    n_lattice as a 0-d int32 tensor.  Rows are numbered in sorted key order.
    M is min(capacity, N) (JAX's build_plan(capacity), lattice.py:733);
    when more than M points are occupied every seg id is 0, every neighbour
    M, and n_lattice the true occupancy, which the apply's guard reads.
    """
    N = h1.shape[0]
    M = _rows(N, capacity)
    dp1, r2 = oh1.shape
    keys, inverse = torch.unique(_pack(h1, h2), sorted=True, return_inverse=True)
    n_lat = keys.shape[0]
    n_lattice = torch.tensor(n_lat, dtype=torch.int32, device=h1.device)
    neighbors = torch.full((dp1, M, r2), M, dtype=torch.int32, device=h1.device)
    if n_lat > M:
        return torch.zeros(N, dtype=torch.int32, device=h1.device), neighbors, n_lattice
    pos, hit = _neighbor_rows(keys, keys, oh1, oh2)
    neighbors[:, :n_lat, :] = torch.where(hit, pos, M).to(torch.int32).permute(0, 2, 1)
    return inverse.to(torch.int32), neighbors, n_lattice


def _table_slots(keys: int) -> int:
    """Slots of an open-addressing table for ``keys`` keys: a power of two >= 2 keys."""
    slots = 1 << max(1, (2 * keys - 1).bit_length())
    if slots > 2**31:
        raise ValueError(f"{keys} keys exceed the hash table's index range")
    return slots


def lattice_dedup_neighbors(h1, h2, oh1, oh2, capacity=None):
    """K2: dedup the vertex hash pairs into rows; blur neighbours by hash linearity.

    With a ``capacity`` below N = len(h1), the bounded K2: a table of M =
    capacity rows, counted in ``bounded_launches`` (the untrimmed one in
    ``launches``).  When more than M points are occupied, the kernel's
    n_lattice is some count above M, not the true occupancy (the plain
    version's is), and the apply's guard turns the output into NaN.  On the
    card one host call (``csrc/dedup.cu``, ``sgp_dedup``: the table's fill,
    the insert, the seg ids and the neighbours) on one workspace; the
    outputs share one allocation.
    """
    if not h1.is_cuda:
        return dedup_neighbors_plain(h1, h2, oh1, oh2, capacity)
    build.require("lattice_dedup_neighbors", (h1, torch.int32), (h2, torch.int32),
                  (oh1, torch.int32), (oh2, torch.int32))
    N = h1.shape[0]
    M = _rows(N, capacity)
    dp1, r2 = oh1.shape
    slots = _table_slots(M)
    lib, st = build.library(), build.stream()
    out = _carve(h1.device, dict(seg=(torch.int32, N), count=(torch.int32, 1), nb=(torch.int32, dp1 * M * r2)))
    work = _workspace(lib.sgp_dedup_workspace, h1.device, N, M, slots)
    build.check(lib.sgp_dedup(h1.data_ptr(), h2.data_ptr(), N, oh1.data_ptr(), oh2.data_ptr(), dp1, r2, M, slots - 1,
                              out["seg"].data_ptr(), out["nb"].data_ptr(), out["count"].data_ptr(), work.data_ptr(),
                              work.numel(), st), "lattice_dedup_neighbors")
    _count_dedup(M < N)
    return out["seg"], out["nb"].view(dp1, M, r2), out["count"].view(())


def _count_dedup(bounded: bool) -> None:
    if bounded:
        lattice_dedup_neighbors.bounded_launches += 1
    else:
        lattice_dedup_neighbors.launches += 1


def _workspace(size_fn, device, *args) -> torch.Tensor:
    """A uint8 workspace of the bytes a C size query (``size_fn(*args, &bytes)``) asks for."""
    need = ctypes.c_longlong(0)
    build.check(size_fn(*args, ctypes.addressof(need)), "workspace size")
    return torch.empty(max(need.value, 1), dtype=torch.uint8, device=device)


lattice_dedup_neighbors.launches = 0
lattice_dedup_neighbors.bounded_launches = 0


def dedup_ordered_plain(h1, h2, oh1, oh2):
    """Plain K11a: K2 with rows numbered by their first contributing vertex.

    Row r is the r-th distinct key in the order of first appearance in
    (h1, h2); seg_ids (N,), neighbors (d+1, N, 2r) and n_lattice as
    :func:`dedup_neighbors_plain` (untrimmed).  Any two builds on the same
    hashes, on any rank and by the kernel, give the same bits.
    """
    N = h1.shape[0]
    dp1, r2 = oh1.shape
    dev = h1.device
    keys, inverse = torch.unique(_pack(h1, h2), sorted=True, return_inverse=True)
    n_lat = keys.shape[0]
    first = torch.full((n_lat,), N, dtype=torch.int64, device=dev).scatter_reduce_(
        0, inverse, torch.arange(N, device=dev), reduce="amin")
    order = torch.argsort(first)  # row -> sorted key
    row_of_key = torch.empty_like(order)
    row_of_key[order] = torch.arange(n_lat, device=dev)
    pos, hit = _neighbor_rows(keys, keys[order], oh1, oh2)
    neighbors = torch.full((dp1, N, r2), N, dtype=torch.int32, device=dev)
    nb = torch.where(hit, row_of_key[pos.clamp(max=n_lat - 1)], N)
    neighbors[:, :n_lat, :] = nb.to(torch.int32).permute(0, 2, 1)
    return (row_of_key[inverse].to(torch.int32), neighbors,
            torch.tensor(n_lat, dtype=torch.int32, device=dev))


def lattice_dedup_ordered(h1, h2, oh1, oh2):
    """K11a: K2 with rows numbered by their first contributing vertex, the same on every rank.

    K2 numbers rows in the order in which threads win their CAS, which
    differs between two builds; the sharded plan sums the ranks' tables row
    by row, so every rank must number a lattice point alike.  Returns
    (seg_ids (N,), neighbors (d+1, N, 2r), n_lattice 0-d), bit-equal to
    :func:`dedup_ordered_plain`.
    """
    if not h1.is_cuda:
        return dedup_ordered_plain(h1, h2, oh1, oh2)
    build.require("lattice_dedup_ordered", (h1, torch.int32), (h2, torch.int32),
                  (oh1, torch.int32), (oh2, torch.int32))
    N = h1.shape[0]
    dp1, r2 = oh1.shape
    slots = _table_slots(N)
    dev = h1.device
    lib = build.library()
    i32 = dict(dtype=torch.int32, device=dev)
    table = torch.empty(slots, dtype=torch.int64, device=dev)  # emptied by the insert
    slot_of, seg_ids, flag = torch.empty(N, **i32), torch.empty(N, **i32), torch.empty(N, **i32)
    row_of_slot = torch.empty(slots, **i32)
    first_of_slot = torch.empty(slots, **i32)
    count = torch.empty((), **i32)
    row_h1, row_h2 = torch.empty(N, **i32), torch.empty(N, **i32)
    neighbors = torch.empty((dp1, N, r2), **i32)
    st = build.stream()
    build.check(lib.sgp_dedup_insert(h1.data_ptr(), h2.data_ptr(), N, table.data_ptr(), slots - 1, N,
                                     slot_of.data_ptr(), row_of_slot.data_ptr(), count.data_ptr(),
                                     row_h1.data_ptr(), row_h2.data_ptr(), st),
                "lattice_dedup_ordered (insert)")
    build.check(lib.sgp_dedup_first(slot_of.data_ptr(), N, first_of_slot.data_ptr(), slots, flag.data_ptr(), st),
                "lattice_dedup_ordered (first)")
    scan = torch.cumsum(flag, 0, dtype=torch.int32)
    build.check(lib.sgp_dedup_remap(h1.data_ptr(), h2.data_ptr(), slot_of.data_ptr(), flag.data_ptr(),
                                    scan.data_ptr(), N, row_of_slot.data_ptr(), row_h1.data_ptr(),
                                    row_h2.data_ptr(), st), "lattice_dedup_ordered (remap)")
    build.check(lib.sgp_dedup_finish(slot_of.data_ptr(), row_of_slot.data_ptr(), N, table.data_ptr(),
                                     slots - 1, N, count.data_ptr(), row_h1.data_ptr(), row_h2.data_ptr(),
                                     oh1.data_ptr(), oh2.data_ptr(), seg_ids.data_ptr(), dp1, r2,
                                     neighbors.data_ptr(), st), "lattice_dedup_ordered (neighbors)")
    lattice_dedup_ordered.launches += 1
    return seg_ids, neighbors, count


lattice_dedup_ordered.launches = 0


def _blur_axes(dp1: int, transpose: bool):
    """The order of the d+1 axis blurs: B = B_d...B_0, and B^T = B_0...B_d.

    Each B_j is symmetric (symmetric taps; the neighbour at +t of row a is b
    exactly when the neighbour at -t of b is a, by hash linearity), so the
    transpose only reverses the order of the axes.
    """
    return range(dp1 - 1, -1, -1) if transpose else range(dp1)


def _blur_plain(table, neighbors, taps, transpose):
    """The d+1 axis blurs of an (M, c) table (B, or B^T with ``transpose``); a missing neighbour is zero."""
    order = neighbors.shape[2] // 2
    tap_list = [t for t in range(-order, order + 1) if t != 0]
    zero_row = torch.zeros((1, table.shape[1]), dtype=table.dtype, device=table.device)
    for j in _blur_axes(neighbors.shape[0], transpose):
        padded = torch.cat([table, zero_row])
        acc = taps[order] * table
        for ti, t in enumerate(tap_list):
            acc = acc + taps[t + order] * padded[neighbors[j, :, ti].long()]
        table = acc
    return table


def apply_plain(seg_ids, weights, neighbors, v, taps, slice_norm, transpose=False, return_table=False,
                n_lattice=None):
    """Plain K3 (apply_plan_join, :470): splat, d+1 axis blurs, slice.

    ``transpose`` applies ``slice_norm * S^T B^T S``; ``return_table`` also
    returns the blurred (M, c) table before the slice (B S v, or B^T S v).
    With ``n_lattice``, the output is all NaN when it exceeds the M table
    rows (the capacity guard, lattice.py:1093-1100).  Differentiable by
    torch autograd in ``v`` and ``weights``; a float64 v gives the operator
    in float64.
    """
    n, dp1 = seg_ids.shape
    M = neighbors.shape[1]
    c = v.shape[-1]
    seg = seg_ids.reshape(-1).long()
    contrib = (v[:, None, :] * weights[:, :, None]).reshape(n * dp1, c)
    table = _blur_plain(torch.zeros((M, c), dtype=contrib.dtype, device=v.device).index_add_(0, seg, contrib),
                        neighbors, taps, transpose)
    gathered = table[seg_ids.long()]  # (n, d+1, c)
    out = (gathered * weights[:, :, None]).sum(dim=1) * slice_norm
    if n_lattice is not None:
        out = torch.where(n_lattice <= M, out, float("nan"))
    return (out, table) if return_table else out


def lattice_apply(seg_ids, weights, neighbors, n_lattice, v, taps, slice_norm, transpose=False,
                  return_table=False):
    """K3: ``slice_norm * S^T B S v`` for v (n, c) over a built plan.

    ``taps`` is the sequence of 2r+1 filter taps; ``n_lattice`` the live row
    count (a 0-d int32 tensor, read on the device).  ``transpose`` runs the
    axis blurs in reverse order (S^T B^T S); ``return_table`` also returns
    the blurred (M, c) table, whose rows past n_lattice are undefined.  A
    plan trimmed to M < n(d+1) rows gives all NaN once n_lattice passes M
    (the guard, read on the device); an untrimmed plan runs unguarded.
    """
    if not v.is_cuda:
        return apply_plain(seg_ids, weights, neighbors, v, taps, slice_norm, transpose, return_table,
                           n_lattice)
    build.require("lattice_apply", (seg_ids, torch.int32), (weights, torch.float32),
                  (neighbors, torch.int32), (n_lattice, torch.int32), (v, torch.float32))
    n, dp1 = seg_ids.shape
    M = neighbors.shape[1]
    order = neighbors.shape[2] // 2
    c = v.shape[-1]
    if v.shape[0] != n or len(taps) != 2 * order + 1:
        raise ValueError(f"lattice_apply: v {tuple(v.shape)} / {len(taps)} taps do not fit a "
                         f"plan of {n} points and order {order}")
    dev = v.device
    lib = build.library()
    taps_host = (ctypes.c_float * len(taps))(*[float(t) for t in taps])
    a = torch.zeros((M, c), dtype=torch.float32, device=dev)
    b = torch.empty((M, c), dtype=torch.float32, device=dev)
    out = torch.empty((n, c), dtype=torch.float32, device=dev)
    guard = n_lattice.data_ptr() if M < n * dp1 else None
    st = build.stream()
    build.check(lib.sgp_lattice_splat(seg_ids.data_ptr(), weights.data_ptr(), v.data_ptr(), n,
                                      dp1, c, a.data_ptr(), guard, M, st), "lattice_apply (splat)")
    for j in _blur_axes(dp1, transpose):
        rc = lib.sgp_lattice_blur(a.data_ptr(), b.data_ptr(), neighbors[j].data_ptr(),
                                  ctypes.addressof(taps_host), M, c, order,
                                  n_lattice.data_ptr(), st)
        build.check(rc, "lattice_apply (blur)")
        a, b = b, a
    build.check(lib.sgp_lattice_slice(a.data_ptr(), seg_ids.data_ptr(), weights.data_ptr(), n,
                                      dp1, c, float(slice_norm), out.data_ptr(), guard, M, st),
                "lattice_apply (slice)")
    lattice_apply.launches += 1
    return (out, a) if return_table else out


lattice_apply.launches = 0


class JoinRows(NamedTuple):
    """A join plan's contributions in row order and the splat's work lists (K9's and K7's rows).

    N = n(d+1) contributions, M table rows; the fields, and their meaning, are
    :class:`~simplex_gp_torch.kernels.chain.ChainPlan`'s of the same names, so
    the sort chain's splat (K3'b) sums a join table's rows as it sums the
    chain's:

      splat_points:  (N,) int32     point of each contribution, rows ascending, each row's in contribution order
      splat_weights: (N,) f32       its barycentric weight
      cnt:           (M,) int32     end of each row's run (N past the live rows)
      long_rows, long_first, piece_row, piece_start, n_long, n_pieces, mid_rows, n_mid: the splat's lists
      n_lattice:     () int32       the rows the splat visits: the plan's live count (> M: the capacity
                                    overflowed)

    A mixture's stacked plan has row lists of the same fields
    (:func:`~simplex_gp_torch.kernels.mixture.mixture_rows`): over its J M
    rows, a row past its component's live count holding an empty run, each
    contribution's point taken mod n (stacked point j n + p is point p),
    and n_lattice J M.
    """

    splat_points: torch.Tensor
    splat_weights: torch.Tensor
    cnt: torch.Tensor
    long_rows: torch.Tensor
    long_first: torch.Tensor
    piece_row: torch.Tensor
    piece_start: torch.Tensor
    n_long: torch.Tensor
    n_pieces: torch.Tensor
    mid_rows: torch.Tensor
    n_mid: torch.Tensor
    n_lattice: torch.Tensor


def join_rows_plain(seg_ids, weights, neighbors, n_lattice, n_pts=None) -> JoinRows:
    """Plain row lists of a join plan: a stable sort of the seg ids, each row's run end, the splat's lists.

    ``n_pts`` (None: the plan's n): each contribution's point is reduced mod
    it, for a mixture's stacked seg ids (J n, d+1).
    """
    return _rows_plain(seg_ids, weights, neighbors.shape[1], n_lattice, n_pts)


def _rows_plain(seg_ids, weights, M: int, n_lattice, n_pts=None) -> JoinRows:
    """:func:`join_rows_plain` over M table rows."""
    dp1 = seg_ids.shape[-1]
    seg = seg_ids.reshape(-1)
    N = seg.shape[0]
    order = torch.sort(seg, stable=True)
    cnt = torch.searchsorted(order.values, torch.arange(M, dtype=seg.dtype, device=seg.device),
                             right=True).to(torch.int32)
    live = min(int(n_lattice), M)
    points = order.indices // dp1 if n_pts is None else order.indices // dp1 % n_pts
    return JoinRows(points.to(torch.int32), weights.reshape(-1)[order.indices].contiguous(), cnt,
                    *run_lists(cnt, live, N), n_lattice)


def rows_key_bits(Mt: int) -> int:
    """The low bits of the seg ids that the card's stable radix sort of a plan of Mt = J M rows looks at:
    bit_length(Mt - 1), at least 1.  Every seg id lies below Mt (past a capacity every one is 0), so no
    higher bit can differ (``csrc/join_rows.cu``)."""
    return max(1, (Mt - 1).bit_length())


def _rows_sizes(lib, N: int, Mt: int) -> tuple:
    """(ints of the lists buffer, workspace bytes) of the card's row build of N contributions over Mt rows."""
    ints, work = ctypes.c_longlong(0), ctypes.c_longlong(0)
    build.check(lib.sgp_rows_sizes(N, Mt, ctypes.addressof(ints), ctypes.addressof(work)), "join_rows (sizes)")
    return ints.value, work.value


def _rows_parts(N: int, Mt: int, lists_ints: int) -> dict:
    """The :func:`~simplex_gp_torch.kernels.chain._carve` parts of a JoinRows' tensors."""
    return dict(sp=(torch.int32, N), sw=(torch.float32, N), cnt=(torch.int32, Mt), lists=(torch.int32, lists_ints))


def _rows_of(out: dict, N: int, Mt: int, n_lattice) -> JoinRows:
    """The JoinRows of the carved buffers ``out`` that ``sgp_rows_build`` filled; the lists in their order in
    ``csrc/rows.cuh``'s RowsLists."""
    nl_max, np_max, nm_max = _long_bounds(N, Mt)
    long_rows, long_first, piece_row, piece_start, mid_rows, n_long, n_pieces, n_mid = out["lists"].split(
        (nl_max, nl_max + 1, np_max, np_max, nm_max, 1, 1, 1))
    return JoinRows(out["sp"], out["sw"], out["cnt"], long_rows, long_first, piece_row, piece_start, n_long.view(()),
                    n_pieces.view(()), mid_rows, n_mid.view(()), n_lattice)


def join_rows_device(seg_ids, weights, live, M: int, n_pts: int, n_lattice, sparse: bool = False) -> JoinRows:
    """The row lists of ``seg_ids`` (.., d+1) over ``live.shape[0]`` components of M rows on the card.

    One host call (``csrc/join_rows.cu``, ``sgp_rows_build``) on one
    workspace: each contribution's index and weight packed into one sort
    value, a stable cub radix sort of the seg ids over their
    low :func:`rows_key_bits` bits, the runs and their classes (``live``
    (J,) the components' live counts, each contribution's point reduced mod
    ``n_pts``; ``sparse``: a live row may hold no contribution, as a
    sharded plan's rank's), three cub scans and the lists; ``n_lattice``
    becomes the lists' count.  Nothing is read on the host; the rows share
    one allocation.  Counted in ``join_rows.launches``.
    """
    build.require("join_rows", (seg_ids, torch.int32), (weights, torch.float32), (live, torch.int32))
    dp1 = seg_ids.shape[-1]
    J = live.shape[0]
    N, Mt = seg_ids.numel(), live.shape[0] * M
    if weights.numel() != N:
        raise ValueError(f"join_rows: {weights.numel()} weights for {N} seg ids")
    lib = build.library()
    lists_ints, work_bytes = _rows_sizes(lib, N, Mt)
    out = _carve(seg_ids.device, _rows_parts(N, Mt, lists_ints))
    work = torch.empty(max(work_bytes, 1), dtype=torch.uint8, device=seg_ids.device)
    build.check(lib.sgp_rows_build(seg_ids.data_ptr(), weights.data_ptr(), live.data_ptr(), J, N, M, dp1, n_pts,
                                   int(sparse), out["sp"].data_ptr(), out["sw"].data_ptr(), out["cnt"].data_ptr(),
                                   out["lists"].data_ptr(), work.data_ptr(), work.numel(), build.stream()),
                "join_rows")
    join_rows.launches += 1
    return _rows_of(out, N, Mt, n_lattice)


def join_rows(seg_ids, weights, neighbors, n_lattice) -> JoinRows:
    """K9's and K7's row lists of a join plan (``seg_ids`` (n, d+1), ``weights``, ``neighbors``, ``n_lattice``).

    The same lists as :func:`join_rows_plain`, bit for bit
    (:func:`join_rows_device` with one component).  The live count stays on
    the device.  Counted once per build.
    """
    if not seg_ids.is_cuda:
        return join_rows_plain(seg_ids, weights, neighbors, n_lattice)
    build.require("join_rows", (n_lattice, torch.int32))
    return join_rows_device(seg_ids, weights, n_lattice.reshape(1), neighbors.shape[1], seg_ids.shape[0], n_lattice)


join_rows.launches = 0


def lattice_plan_rows(h1, h2, weights, oh1, oh2, capacity=None):
    """K2 and the plan's row lists from one host call: (seg_ids (n, d+1), neighbors, n_lattice, rows).

    The plan of :func:`lattice_dedup_neighbors` (M = min(capacity, N)
    rows) and its :func:`join_rows`, from K1's hash pairs and ``weights``
    (n, d+1).  On the card one call (``csrc/join_rows.cu``,
    ``sgp_plan_rows``) runs K2's fill, insert, seg and neighbour passes and
    then the row build on one workspace, with no host read; the plan and
    its rows share one allocation.  Counted in K2's counters and in
    ``join_rows.launches``.
    """
    if not h1.is_cuda:
        seg_ids, neighbors, n_lattice = dedup_neighbors_plain(h1, h2, oh1, oh2, capacity)
        seg_ids = seg_ids.reshape(weights.shape)
        return seg_ids, neighbors, n_lattice, join_rows_plain(seg_ids, weights, neighbors, n_lattice)
    build.require("lattice_plan_rows", (h1, torch.int32), (h2, torch.int32), (weights, torch.float32),
                  (oh1, torch.int32), (oh2, torch.int32))
    N = h1.shape[0]
    M = _rows(N, capacity)
    dp1, r2 = oh1.shape
    if weights.shape != (N // dp1, dp1) or h2.shape != h1.shape:
        raise ValueError(f"lattice_plan_rows: weights {tuple(weights.shape)} do not fit {N} hash pairs of "
                         f"{dp1} vertices a point")
    slots = _table_slots(M)
    dev = h1.device
    lib = build.library()
    lists_ints, _ = _rows_sizes(lib, N, M)
    out = _carve(dev, dict(seg=(torch.int32, N), count=(torch.int32, 1), nb=(torch.int32, dp1 * M * r2),
                           **_rows_parts(N, M, lists_ints)))
    work = _workspace(lib.sgp_plan_rows_workspace, dev, N, M, slots)
    build.check(lib.sgp_plan_rows(h1.data_ptr(), h2.data_ptr(), weights.data_ptr(), N, oh1.data_ptr(),
                                  oh2.data_ptr(), dp1, r2, M, slots - 1, out["seg"].data_ptr(), out["nb"].data_ptr(),
                                  out["count"].data_ptr(), out["sp"].data_ptr(), out["sw"].data_ptr(),
                                  out["cnt"].data_ptr(), out["lists"].data_ptr(), work.data_ptr(), work.numel(),
                                  build.stream()), "lattice_plan_rows")
    _count_dedup(M < N)
    join_rows.launches += 1
    n_lattice = out["count"].view(())
    return (out["seg"].view(N // dp1, dp1), out["nb"].view(dp1, M, r2), n_lattice, _rows_of(out, N, M, n_lattice))


def _slice_sums(table, seg_ids, weights):
    """(n, c): each point's d+1 rows, weighted and summed in vertex order, as the kernels' slices sum them."""
    out = table.new_zeros((seg_ids.shape[0], table.shape[1]))
    for v in range(seg_ids.shape[1]):
        out = out + table[seg_ids[:, v].long()] * weights[:, v:v + 1]
    return out


def _require_one_window(what: str, c: int, chunk: int, return_table: bool) -> None:
    if return_table and c > chunk:
        raise ValueError(f"{what}: return_table needs one window: {c} columns against a window of {chunk}")


def apply_cols_plain(seg_ids, weights, neighbors, n_lattice, v, taps, slice_norm, chunk, rows=None, transpose=False,
                     return_table=False):
    """Plain K9 (lattice_filter_wide_chunked, filter.py:65-84): the apply of each ``chunk``-column window.

    In the kernel's order: the row-order splat of the window
    (:func:`~simplex_gp_torch.kernels.chain.chain_splat_plain` on the row
    lists ``rows``, built when None), the d+1 blurs (in reverse order with
    ``transpose``), the slice summed in vertex order; all NaN when n_lattice
    passes the M table rows (K3's guard).  Columns do not interact, so the
    result does not depend on ``chunk``.  (JAX pads v to a multiple of the
    chunk and applies each block; the padding columns are dropped, so the
    output is the same.)  ``return_table`` (c <= chunk: one window) also
    returns the blurred (M, c) table.
    """
    _require_one_window("apply_cols_plain", v.shape[1], chunk, return_table)
    rows = join_rows_plain(seg_ids, weights, neighbors, n_lattice) if rows is None else rows
    c = v.shape[1]
    out = v.new_empty((v.shape[0], c))
    for c0 in range(0, c, chunk):
        table = _blur_plain(chain_splat_plain(rows, v[:, c0:c0 + chunk]), neighbors, taps, transpose)
        out[:, c0:c0 + chunk] = _slice_sums(table, seg_ids, weights) * slice_norm
    out = torch.where(n_lattice <= neighbors.shape[1], out, float("nan"))
    return (out, table) if return_table else out


def _rows_args(rows: JoinRows) -> tuple:
    """The 16 leading arguments of K9's and K7's entry points: the row lists (``sgp_runs``, csrc/rows.cuh)."""
    return (rows.splat_points.data_ptr(), rows.splat_weights.data_ptr(), rows.cnt.data_ptr(),
            rows.long_rows.data_ptr(), rows.long_first.data_ptr(), rows.n_long.data_ptr(), rows.piece_row.data_ptr(),
            rows.piece_start.data_ptr(), rows.n_pieces.data_ptr(), rows.mid_rows.data_ptr(), rows.n_mid.data_ptr(),
            rows.long_rows.shape[0], rows.mid_rows.shape[0], rows.piece_row.shape[0], rows.splat_points.shape[0],
            rows.n_lattice.data_ptr())


def _require_rows(what: str, rows: JoinRows, N: int, M: int) -> None:
    build.require(what, *((t, torch.float32 if t is rows.splat_weights else torch.int32) for t in rows))
    if rows.splat_points.shape[0] != N or rows.cnt.shape[0] != M:
        raise ValueError(f"{what}: row lists of {rows.splat_points.shape[0]} contributions and {rows.cnt.shape[0]} "
                         f"rows do not fit a plan of {N} contributions and {M} rows")


def lattice_apply_cols(seg_ids, weights, neighbors, n_lattice, v, taps, slice_norm, chunk, rows=None,
                       transpose=False, return_table=False):
    """K9: K3's ``slice_norm * S^T B S v`` of a wide v (n, c), ``chunk`` columns at a time.

    ``rows`` are the plan's :class:`JoinRows` (built here when None; a
    caller that applies one plan more than once builds them once).  One
    pair of (M, chunk) tables serves every column window, and none is
    zeroed: per window, the row-order splat writes every live row, the d+1
    blurs stride over the live rows only and the slice writes the window of
    the output in place (row stride c).  No atomics, so two runs give the
    same bits, :func:`apply_cols_plain`'s.  The guard is K3's.
    ``transpose`` blurs the axes in reverse order (S^T B^T S, as K3's);
    ``return_table`` (c <= chunk: one window) also returns the blurred
    (M, c) table, K5's input, whose rows past the live count are undefined
    (finite: past the capacity the blurs do not run and the table is the
    splat's or zero).
    """
    if not v.is_cuda:
        return apply_cols_plain(seg_ids, weights, neighbors, n_lattice, v, taps, slice_norm, chunk, rows, transpose,
                                return_table)
    build.require("lattice_apply_cols", (seg_ids, torch.int32), (weights, torch.float32),
                  (neighbors, torch.int32), (n_lattice, torch.int32), (v, torch.float32))
    n, dp1 = seg_ids.shape
    M = neighbors.shape[1]
    order = neighbors.shape[2] // 2
    c = v.shape[-1]
    if v.shape[0] != n or len(taps) != 2 * order + 1 or chunk < 1:
        raise ValueError(f"lattice_apply_cols: v {tuple(v.shape)} / {len(taps)} taps / chunk {chunk} do "
                         f"not fit a plan of {n} points and order {order}")
    _require_one_window("lattice_apply_cols", c, chunk, return_table)
    rows = join_rows(seg_ids, weights, neighbors, n_lattice) if rows is None else rows
    _require_rows("lattice_apply_cols", rows, n * dp1, M)
    dev = v.device
    taps_host = (ctypes.c_float * len(taps))(*[float(t) for t in taps])
    w = min(chunk, c)
    ta = torch.empty((M, w), dtype=torch.float32, device=dev)
    tb = (torch.zeros if return_table else torch.empty)((M, w), dtype=torch.float32, device=dev)
    part = torch.empty((rows.piece_row.shape[0], w), dtype=torch.float32, device=dev)
    out = torch.empty((n, c), dtype=torch.float32, device=dev)
    guard = n_lattice.data_ptr() if M < n * dp1 else None
    rc = build.library().sgp_lattice_apply_cols(
        *_rows_args(rows), seg_ids.data_ptr(), weights.data_ptr(), neighbors.data_ptr(), v.data_ptr(), n, dp1, c,
        chunk, M, ctypes.addressof(taps_host), order, float(slice_norm), guard, ta.data_ptr(), tb.data_ptr(),
        part.data_ptr(), out.data_ptr(), int(transpose), build.stream())
    build.check(rc, "lattice_apply_cols")
    lattice_apply_cols.launches += 1
    if return_table:
        return out, (ta if dp1 % 2 == 0 else tb)
    return out


lattice_apply_cols.launches = 0


def _block_cols(c: int, size: int) -> int:
    """Columns of each rank's block: c rounded up to a multiple of the axis size, over it (:502-507)."""
    return -(-c // size)


def sharded_rows(seg_ids, weights, n_lattice) -> JoinRows:
    """K11b's row lists: this rank's contributions (``seg_ids`` (n_loc, d+1), ``weights``) over the
    ``n_lattice`` live rows of a sharded plan (K11a numbers them first, so they are rows 0 .. n_lattice-1).

    One host read of ``n_lattice`` (every rank holds the same value) sizes
    the lists; every row is live, so a row this rank does not reach holds
    an empty run.  On the card :func:`join_rows_device` with one component
    (counted in ``join_rows.launches``).
    """
    nl = int(n_lattice)
    if not seg_ids.is_cuda:
        return _rows_plain(seg_ids, weights, nl, n_lattice)
    build.require("sharded_rows", (n_lattice, torch.int32))
    return join_rows_device(seg_ids, weights, n_lattice.reshape(1), nl, seg_ids.shape[0], n_lattice, sparse=True)


def _live_neighbors(neighbors, nl: int):
    """The (d+1, nl, 2r) neighbour ids of a plan's nl live rows, nl meaning missing (the plain blur's pad row)."""
    nb = neighbors[:, :nl]
    return torch.where(nb == neighbors.shape[1], nl, nb)


def apply_sharded_plain(seg_ids, weights, neighbors, n_lattice, v, taps, slice_norm, axis, transpose=False,
                        return_table=False, rows=None):
    """Plain K11b (apply_plan_join's sharded branch, :499-521), collectives included.

    In the kernels' order, over the n_lattice live rows of the sharded plan
    (``rows``, :func:`sharded_rows`, built when None): the row-order splat
    of each column block of v (padded with zero columns to c_pad = P cb)
    into a (P, n_lattice, cb) block buffer; the reduce-scatter over the
    blocks; the d+1 blurs of this rank's (n_lattice, cb) block; the
    all-gather of the blocks; the slice of this rank's points, summed in
    vertex order.  ``return_table`` also returns the blurred (n_lattice, c)
    table, every rank's blocks side by side.
    """
    c = v.shape[-1]
    P, cb = axis.size, _block_cols(c, axis.size)
    rows = _rows_plain(seg_ids, weights, int(n_lattice), n_lattice) if rows is None else rows
    nl = rows.cnt.shape[0]
    padded = torch.nn.functional.pad(v, (0, P * cb - c))
    blocks = torch.stack([chain_splat_plain(rows, padded[:, b * cb:(b + 1) * cb].contiguous()) for b in range(P)])
    mine = _blur_plain(axis.psum_scatter(blocks), _live_neighbors(neighbors, nl), taps, transpose)
    full = axis.all_gather_blocks(mine).permute(1, 0, 2).reshape(nl, P * cb)[:, :c]
    out = _slice_sums(full, seg_ids, weights) * slice_norm
    return (out, full.contiguous()) if return_table else out


def lattice_apply_sharded(seg_ids, weights, neighbors, n_lattice, v, taps, slice_norm, axis,
                          transpose=False, return_table=False, rows=None):
    """K11b: ``slice_norm * S^T B S v`` over a sharded plan, for this rank's rows v (n_loc, c).

    ``seg_ids`` (n_loc, d+1) and ``weights`` are this rank's points of a
    global plan whose ``neighbors`` (d+1, M, 2r) and ``n_lattice`` every rank
    holds alike (K11a, rows numbered by first vertex, so the live rows are
    the first n_lattice); ``rows`` are this rank's row lists
    (:func:`sharded_rows`, built here when None: a plan applied more than
    once brings them); ``axis`` is the
    :class:`~simplex_gp_torch.parallel.comm.DataAxis`.  The kernels splat
    each column block in row order into a (P, n_lattice, cb) block buffer,
    the axis reduce-scatters it, the d+1 live-row blurs run in one launch on
    this rank's (n_lattice, cb) block (``transpose``: the axes reversed), the axis
    all-gathers the blocks, and the kernel slices this rank's points from
    them.  No atomics: two calls give the same bits,
    :func:`apply_sharded_plain`'s.  ``return_table`` also returns the
    blurred (n_lattice, c) table in K5's row-major layout: the gathered
    blocks are permuted into it, one copy, so that K5 stays the
    single-device kernel.  A sharded plan is untrimmed (M = n_loc (d+1) P),
    so there is no guard.
    """
    if not v.is_cuda:
        return apply_sharded_plain(seg_ids, weights, neighbors, n_lattice, v, taps, slice_norm, axis, transpose,
                                   return_table, rows)
    build.require("lattice_apply_sharded", (seg_ids, torch.int32), (weights, torch.float32),
                  (neighbors, torch.int32), (n_lattice, torch.int32), (v, torch.float32))
    n, dp1 = seg_ids.shape
    M = neighbors.shape[1]
    order = neighbors.shape[2] // 2
    c = v.shape[-1]
    if v.shape[0] != n or len(taps) != 2 * order + 1:
        raise ValueError(f"lattice_apply_sharded: v {tuple(v.shape)} / {len(taps)} taps do not fit a "
                         f"plan of {n} points and order {order}")
    if M != n * dp1 * axis.size:
        raise ValueError(f"lattice_apply_sharded: a plan of {M} rows for {axis.size} ranks of {n} points "
                         f"(a sharded plan is untrimmed)")
    rows = sharded_rows(seg_ids, weights, n_lattice) if rows is None else rows
    nl = rows.cnt.shape[0]
    _require_rows("lattice_apply_sharded", rows, n * dp1, nl)
    lib, st, dev = build.library(), build.stream(), v.device
    taps_host = (ctypes.c_float * len(taps))(*[float(t) for t in taps])
    P, cb = axis.size, _block_cols(c, axis.size)
    blocks = torch.empty((P, nl, cb), dtype=torch.float32, device=dev)
    part = torch.empty((rows.piece_row.shape[0], cb), dtype=torch.float32, device=dev)
    build.check(lib.sgp_lattice_splat_blocks(*_rows_args(rows), v.data_ptr(), c, cb, P, nl, blocks.data_ptr(),
                                             part.data_ptr(), st), "lattice_apply_sharded (splat)")
    a = axis.psum_scatter(blocks)
    b = torch.empty_like(a)
    barrier = torch.empty(1, dtype=torch.int32, device=dev)
    build.check(lib.sgp_lattice_blur_live(a.data_ptr(), b.data_ptr(), neighbors.data_ptr(),
                                          ctypes.addressof(taps_host), M, nl, cb, order, dp1, int(transpose),
                                          barrier.data_ptr(), st), "lattice_apply_sharded (blur)")
    gathered = axis.all_gather_blocks(a if dp1 % 2 == 0 else b)
    out = torch.empty((n, c), dtype=torch.float32, device=dev)
    build.check(lib.sgp_lattice_slice_blocks(gathered.data_ptr(), seg_ids.data_ptr(), weights.data_ptr(), n,
                                             dp1, c, cb, nl, float(slice_norm), out.data_ptr(), st),
                "lattice_apply_sharded (slice)")
    lattice_apply_sharded.launches += 1
    if return_table:
        return out, gathered.permute(1, 0, 2).reshape(nl, P * cb)[:, :c].contiguous()
    return out


lattice_apply_sharded.launches = 0


def _grad_team(c: int) -> int:
    """The lanes K5 gives a point for c columns (csrc/grad.cu's rule): 8 points to a warp at c <= 16, else 4."""
    return 4 if c <= 16 else 8


def lattice_filter_grad_plain(ref, E, seg_ids, v, g, table_f, table_b, slice_norm):
    """Plain K5: the gradient of <g, slice_norm S^T B S v> in the positions ref (n, d).

    ``table_f`` = B S v is the forward's blurred table and ``table_b`` =
    B^T S g the transposed apply's.  The weight gradient is
    gw[i,k] = slice_norm (g_i . table_f[seg_ik] + v_i . table_b[seg_ik]); it
    is chained back through the barycentric weights -- w[k] = t_(d-k) -
    t_(d+1-k) for k >= 1, w[0] = 1 + t_d - t_0, with t_r the scaled
    differential of rank r -- and the elevation x @ E^T.  Ranks, rounding
    and keys carry no gradient, as in JAX's autodiff.  Sums in the kernel's
    order, so the two agree bit for bit: a dot's columns by a team of T
    lanes (lane l adds columns l, l + T, ... in turn, then the xor
    butterfly), each output coordinate over j in order.
    """
    n, d = ref.shape
    dp1, c = d + 1, v.shape[1]
    T = _grad_team(c)
    L = -(-c // T)
    seg = seg_ids.long()
    prod = g[:, None, :] * table_f[seg] + v[:, None, :] * table_b[seg]  # (n, d+1, c)
    lanes = torch.nn.functional.pad(prod, (0, L * T - c)).reshape(n, dp1, L, T)
    acc = prod.new_zeros((n, dp1, T))
    for i in range(L):
        acc = acc + lanes[:, :, i]
    lane, off = torch.arange(T, device=ref.device), T // 2
    while off:
        acc = acc + acc[..., lane ^ off]
        off //= 2
    gw = acc[..., 0] * slice_norm
    _, rank = _simplex_rank(_elevate(ref, E), d)
    r = torch.arange(dp1, device=ref.device)
    grad_t_by_rank = gw[:, d - r] - gw[:, (d + 1 - r) % dp1]  # (n, d+1), by rank
    grad_elev = grad_t_by_rank.gather(1, rank.long()) * (1.0 / dp1)
    out = ref.new_zeros((n, d))
    for j in range(dp1):
        out = out + grad_elev[:, j:j + 1] * E[j]
    return out


def lattice_filter_grad(ref, E, seg_ids, v, g, table_f, table_b, slice_norm):
    """K5: the filter's position gradient (see :func:`lattice_filter_grad_plain`), (n, d)."""
    if not ref.is_cuda:
        return lattice_filter_grad_plain(ref, E, seg_ids, v, g, table_f, table_b, slice_norm)
    build.require("lattice_filter_grad", (ref, torch.float32), (E, torch.float32),
                  (seg_ids, torch.int32), (v, torch.float32), (g, torch.float32),
                  (table_f, torch.float32), (table_b, torch.float32))
    n, d = ref.shape
    c = v.shape[-1]
    if d + 1 > 64:
        raise ValueError(f"lattice_filter_grad: d={d} exceeds the kernel's limit of 63")
    if (seg_ids.shape != (n, d + 1) or g.shape != v.shape or v.shape[0] != n
            or table_f.shape != table_b.shape or table_f.shape[1] != c):
        raise ValueError(f"lattice_filter_grad: shapes do not fit: ref {tuple(ref.shape)}, seg "
                         f"{tuple(seg_ids.shape)}, v {tuple(v.shape)}, g {tuple(g.shape)}, tables "
                         f"{tuple(table_f.shape)} / {tuple(table_b.shape)}")
    lib = build.library()
    grad_ref = torch.empty((n, d), dtype=torch.float32, device=ref.device)
    rc = lib.sgp_lattice_filter_grad(ref.data_ptr(), E.data_ptr(), seg_ids.data_ptr(), v.data_ptr(),
                                     g.data_ptr(), table_f.data_ptr(), table_b.data_ptr(), n, d, c,
                                     float(slice_norm), grad_ref.data_ptr(), build.stream())
    build.check(rc, "lattice_filter_grad")
    lattice_filter_grad.launches += 1
    return grad_ref


lattice_filter_grad.launches = 0


def _renumber(seg, neighbors, n_lattice, generator):
    """The plan with its live rows renumbered by a random permutation drawn from ``generator``."""
    N, nl = neighbors.shape[1], int(n_lattice)
    perm = torch.randperm(nl, generator=generator).to(seg.device)
    to_new = torch.cat([perm, torch.arange(nl, N + 1, device=seg.device)])  # dead rows and "missing" stay
    moved = torch.full_like(neighbors, N)
    moved[:, perm] = to_new[neighbors[:, :nl].long()].to(torch.int32)
    return to_new[seg.long()].to(torch.int32), moved


def filter_once_plain(x, E, a, oh1, oh2, v, taps, slice_norm, capacity, numbering=None):
    """Plain K4 (filter_fused, :1166): K1 + K2 plain, then the apply in the kernel's order.

    Returns (out (n, c), n_lattice 0-d int32); ``out`` is all NaN when more
    than ``capacity`` lattice points are occupied (lattice.py:1295).  The
    apply sums as the kernel does: the row-order splat (each row's
    contributions in contribution order, :func:`chain_splat_plain`), the
    d+1 blurs, the slice in vertex order; none of it depends on how the
    rows are numbered.  ``numbering`` (a CPU ``torch.Generator``, or None for
    sorted key order) renumbers the rows at random first, as the kernel's
    counter numbers them in the order its threads win their inserts.
    """
    n, d = x.shape
    h1, h2, w = geometry_plain(x, E, a)
    seg, nb, n_lattice = dedup_neighbors_plain(h1, h2, oh1, oh2)
    if numbering is not None:
        seg, nb = _renumber(seg, nb, n_lattice, numbering)
    seg = seg.reshape(n, d + 1)
    rows = join_rows_plain(seg, w, nb, n_lattice)
    out = _slice_sums(_blur_plain(chain_splat_plain(rows, v), nb, taps, False), seg, w) * slice_norm
    return torch.where(n_lattice <= capacity, out, float("nan")), n_lattice


def lattice_filter_once(x, E, a, oh1, oh2, v, taps, slice_norm, capacity):
    """K4: the one-shot filter ``slice_norm * S^T B S v`` of v (n, c) at positions x (n, d).

    ``E``, ``a``, ``oh1``/``oh2`` are the elevation, the hash multipliers and
    the (d+1, 2r) neighbour offset hashes; ``capacity`` (1..n(d+1)) bounds
    the lattice table.  Returns (out, n_lattice as a 0-d int32 tensor).
    When more than ``capacity`` points are occupied, ``out`` is all NaN and
    the kernel's n_lattice is some count above the capacity (the plain
    version's is the true occupancy).

    On the card (csrc/once.cu), two host calls around one host read of the
    count: K1's team geometry and the insert into a bounded hash table (a
    plain load before any CAS); past the capacity, NaN and nothing more;
    else, on one workspace, the seg ids and the live rows' neighbour ids
    (K2's passes), the row lists (a stable radix sort of the seg ids, K9's
    runs, the sort chain's lists), the row-order splat, the d+1 blurs in
    one launch and the slice.  No atomics touch a value, and the rows'
    numbering does not reach the output, so two calls give the same bits,
    :func:`filter_once_plain`'s.
    """
    if not x.is_cuda:
        return filter_once_plain(x, E, a, oh1, oh2, v, taps, slice_norm, capacity)
    build.require("lattice_filter_once", (x, torch.float32), (E, torch.float32), (a, torch.int32),
                  (oh1, torch.int32), (oh2, torch.int32), (v, torch.float32))
    n, d = x.shape
    dp1 = d + 1
    N = n * dp1
    c = v.shape[-1]
    r2 = oh1.shape[1]
    if dp1 > 64:
        raise ValueError(f"lattice_filter_once: d={d} exceeds the kernel's limit of 63")
    if v.shape[0] != n or len(taps) != r2 + 1 or oh1.shape != (dp1, r2) or oh2.shape != oh1.shape:
        raise ValueError(f"lattice_filter_once: v {tuple(v.shape)}, {len(taps)} taps, offsets "
                         f"{tuple(oh1.shape)} do not fit positions {tuple(x.shape)}")
    if not 1 <= capacity <= N:
        raise ValueError(f"lattice_filter_once: capacity {capacity} outside 1..{N}")
    slots = _table_slots(capacity)
    dev = x.device
    lib, st = build.library(), build.stream()
    table = torch.empty(slots, dtype=torch.int64, device=dev)
    pre = torch.empty(5 * N + slots + 2 * capacity, dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    build.check(lib.sgp_once_insert(x.data_ptr(), E.data_ptr(), a.data_ptr(), n, d, capacity, slots - 1,
                                    table.data_ptr(), pre.data_ptr(), count.data_ptr(), st),
                "lattice_filter_once (insert)")
    lattice_filter_once.launches += 1
    nl = int(count)  # the one host read: it sizes the live rows' buffers
    if nl > capacity:
        return torch.full((n, c), float("nan"), device=dev), count
    need = ctypes.c_longlong(0)
    build.check(lib.sgp_once_workspace(N, nl, c, dp1, r2, ctypes.addressof(need)), "lattice_filter_once (workspace)")
    work = torch.empty(need.value, dtype=torch.uint8, device=dev)
    out = torch.empty((n, c), dtype=torch.float32, device=dev)
    taps_host = (ctypes.c_float * len(taps))(*[float(t) for t in taps])
    build.check(lib.sgp_once_apply(pre.data_ptr(), table.data_ptr(), slots - 1, capacity, count.data_ptr(), n, dp1,
                                   nl, oh1.data_ptr(), oh2.data_ptr(), r2, v.data_ptr(), c, ctypes.addressof(taps_host),
                                   float(slice_norm), work.data_ptr(), need.value, out.data_ptr(), st),
                "lattice_filter_once (apply)")
    return out, count


lattice_filter_once.launches = 0


def count_plain(x, E, a):
    """Plain K8 (count_lattice_points, :839): distinct vertex hash pairs, 0-d int32."""
    h1, h2, _ = geometry_plain(x, E, a)
    return torch.tensor(torch.unique(_pack(h1, h2)).numel(), dtype=torch.int32, device=x.device)


def lattice_count(x, E, a):
    """K8: the number of occupied lattice points of positions x (n, d), as a 0-d int32 tensor."""
    if not x.is_cuda:
        return count_plain(x, E, a)
    build.require("lattice_count", (x, torch.float32), (E, torch.float32), (a, torch.int32))
    n, d = x.shape
    if d + 1 > 64:
        raise ValueError(f"lattice_count: d={d} exceeds the kernel's limit of 63")
    slots = _table_slots(n * (d + 1))
    lib = build.library()
    table = torch.full((slots,), -2, dtype=torch.int64, device=x.device)  # SGP_EMPTY
    count = torch.zeros((), dtype=torch.int32, device=x.device)
    rc = lib.sgp_lattice_count(x.data_ptr(), E.data_ptr(), a.data_ptr(), n, d, slots - 1,
                               table.data_ptr(), count.data_ptr(), build.stream())
    build.check(rc, "lattice_count")
    lattice_count.launches += 1
    return count


lattice_count.launches = 0


def deriv_grad_plain(seg_ids, weights, neighbors, ref, src, g, taps, slice_norm, scale):
    """Plain K7 (filter.py::_bwd, :269-290): the derivative-tap position gradient (n, d).

    Filters the stack [g, g (x) ref, src, src (x) ref] on the derivative plan
    (``seg_ids``, ``weights``, ``neighbors``; ``taps`` the derivative taps)
    and returns ``scale * sum_l (sf wg - src wgf + gf ws - g wsf)``, with
    ``scale`` = 2 k'(0).  In the kernel's order: the row-order splat on the
    plan's row lists (the plan is untrimmed, so its live count is its
    largest row + 1), the d+1 blurs, the slice summed in vertex order, the
    four terms and the sum over l in turn.
    """
    n, L = src.shape
    d = ref.shape[1]
    rows = join_rows_plain(seg_ids, weights, neighbors, seg_ids.max().to(torch.int32) + 1)
    gf = g[:, :, None] * ref[:, None, :]
    sf = src[:, :, None] * ref[:, None, :]
    stacked = torch.cat([g, gf.reshape(n, L * d), src, sf.reshape(n, L * d)], dim=-1)
    table = _blur_plain(chain_splat_plain(rows, stacked), neighbors, taps, False)
    sums = _slice_sums(table, seg_ids, weights)
    wg = sums[:, :L] * slice_norm
    wgf = sums[:, L:L + L * d].reshape(n, L, d) * slice_norm
    ws = sums[:, L + L * d:2 * L + L * d] * slice_norm
    wsf = sums[:, 2 * L + L * d:].reshape(n, L, d) * slice_norm
    terms = sf * wg[:, :, None] - src[:, :, None] * wgf + gf * ws[:, :, None] - g[:, :, None] * wsf
    acc = terms.new_zeros((n, d))
    for l in range(L):
        acc = acc + terms[:, l]
    return acc * scale


def lattice_deriv_grad(seg_ids, weights, neighbors, n_lattice, ref, src, g, taps, slice_norm, scale):
    """K7: the derivative-tap position gradient (see :func:`deriv_grad_plain`), (n, d).

    ``seg_ids`` (n, d+1), ``weights``, ``neighbors`` and ``n_lattice`` are
    the derivative plan (its row lists, :class:`JoinRows`, are built here:
    the plan serves one call); ``src`` and ``g`` are (n, L), ``ref`` (n, d).
    One host call: the row-order splat forms the 2L(1+d) stacked columns on
    the fly into the live rows of an (M, C) table (no zeroing), the d+1
    blurs stride over the live rows, and the slice combines the four blocks.
    No atomics: two runs give the same bits, :func:`deriv_grad_plain`'s.
    """
    if not ref.is_cuda:
        return deriv_grad_plain(seg_ids, weights, neighbors, ref, src, g, taps, slice_norm, scale)
    build.require("lattice_deriv_grad", (seg_ids, torch.int32), (weights, torch.float32),
                  (neighbors, torch.int32), (n_lattice, torch.int32), (ref, torch.float32),
                  (src, torch.float32), (g, torch.float32))
    n, d = ref.shape
    L = src.shape[-1]
    M = neighbors.shape[1]
    order = neighbors.shape[2] // 2
    C = 2 * L * (1 + d)
    if (seg_ids.shape != (n, d + 1) or src.shape != (n, L) or g.shape != src.shape
            or len(taps) != 2 * order + 1):
        raise ValueError(f"lattice_deriv_grad: shapes do not fit: ref {tuple(ref.shape)}, seg "
                         f"{tuple(seg_ids.shape)}, src {tuple(src.shape)}, g {tuple(g.shape)}, "
                         f"{len(taps)} taps for order {order}")
    rows = join_rows(seg_ids, weights, neighbors, n_lattice)
    dev = ref.device
    taps_host = (ctypes.c_float * len(taps))(*[float(t) for t in taps])
    a = torch.empty((M, C), dtype=torch.float32, device=dev)
    b = torch.empty((M, C), dtype=torch.float32, device=dev)
    part = torch.empty((rows.piece_row.shape[0], C), dtype=torch.float32, device=dev)
    grad_ref = torch.empty((n, d), dtype=torch.float32, device=dev)
    rc = build.library().sgp_deriv_grad(
        *_rows_args(rows), seg_ids.data_ptr(), weights.data_ptr(), neighbors.data_ptr(), ref.data_ptr(),
        src.data_ptr(), g.data_ptr(), n, d, L, M, ctypes.addressof(taps_host), order, float(slice_norm), float(scale),
        a.data_ptr(), b.data_ptr(), part.data_ptr(), grad_ref.data_ptr(), build.stream())
    build.check(rc, "lattice_deriv_grad")
    lattice_deriv_grad.launches += 1
    return grad_ref


lattice_deriv_grad.launches = 0
