"""Lattice kernels K1-K5, K7 and K8: wrappers over the CUDA kernels, beside their plain versions.

Each wrapper takes the plain PyTorch version for CPU tensors and launches its
kernel (``csrc/geometry.cu``, ``csrc/dedup.cu``, ``csrc/apply.cu``,
``csrc/grad.cu``, ``csrc/once.cu``, ``csrc/deriv.cu``) for CUDA tensors,
raising on a failed build or launch; there is no fallback.  Each counts its
launches in a ``launches`` attribute.  The plain versions are the PyTorch
twin of the JAX join engine (simplex_gp_tpu/ops/lattice.py) and run on
either device.

Integer hashes are int32 wrapping mod 2^32, as XLA's are; PyTorch has no
wrapping int32 product, so the plain versions compute in int64 and mask.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = [
    "lattice_simplex",
    "hash_pair",
    "geometry_plain",
    "lattice_geometry",
    "dedup_neighbors_plain",
    "lattice_dedup_neighbors",
    "apply_plain",
    "lattice_apply",
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


def geometry_plain(x: torch.Tensor, E: torch.Tensor, a: torch.Tensor):
    """(h1, h2 (n(d+1),) int32, weights (n, d+1) f32): plain K1 (_point_hashes, :330)."""
    n, d = x.shape
    keys, weights = lattice_simplex(x, E)
    h1, h2 = hash_pair(keys.reshape(n * (d + 1), d), a)
    return h1, h2, weights


def lattice_geometry(x: torch.Tensor, E: torch.Tensor, a: torch.Tensor):
    """K1: per-point hash pairs of the d+1 simplex vertices, and barycentric weights."""
    if not x.is_cuda:
        return geometry_plain(x, E, a)
    n, d = x.shape
    if d + 1 > 64:
        raise ValueError(f"lattice_geometry: d={d} exceeds the kernel's limit of 63")
    build.require("lattice_geometry", (x, torch.float32), (E, torch.float32), (a, torch.int32))
    lib = build.library()
    h1 = torch.empty(n * (d + 1), dtype=torch.int32, device=x.device)
    h2 = torch.empty_like(h1)
    w = torch.empty((n, d + 1), dtype=torch.float32, device=x.device)
    rc = lib.sgp_lattice_geometry(x.data_ptr(), E.data_ptr(), a.data_ptr(), n, d,
                                  h1.data_ptr(), h2.data_ptr(), w.data_ptr(), build.stream())
    build.check(rc, "lattice_geometry")
    lattice_geometry.launches += 1
    return h1, h2, w


lattice_geometry.launches = 0


def _pack(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """Order-preserving int64 key of (h1 signed, h2 unsigned)."""
    return h1.long() * 2**32 | (h2.long() & _MASK32)


def dedup_neighbors_plain(h1, h2, oh1, oh2):
    """Plain K2 (_plan_tables, :387) by sort-unique and binary search.

    Returns seg_ids (N,) int32, neighbors (d+1, N, 2r) int32 with N for a
    missing neighbour (and for every row past the live count), and
    n_lattice as a 0-d int32 tensor.  Rows are numbered in sorted key order.
    """
    N = h1.shape[0]
    dp1, r2 = oh1.shape
    keys, inverse = torch.unique(_pack(h1, h2), sorted=True, return_inverse=True)
    n_lat = keys.shape[0]
    u1 = keys >> 32
    u2 = keys & _MASK32
    q1 = _wrap32(u1[None, None, :] + oh1.long()[:, :, None]).long()
    q2 = (u2[None, None, :] + oh2.long()[:, :, None]) & _MASK32
    q = q1 * 2**32 | q2  # (d+1, 2r, n_lat)
    pos = torch.searchsorted(keys, q)
    hit = keys[pos.clamp(max=n_lat - 1)] == q
    found = torch.where(hit, pos, N).to(torch.int32)
    neighbors = torch.full((dp1, N, r2), N, dtype=torch.int32, device=h1.device)
    neighbors[:, :n_lat, :] = found.permute(0, 2, 1)
    n_lattice = torch.tensor(n_lat, dtype=torch.int32, device=h1.device)
    return inverse.to(torch.int32), neighbors, n_lattice


def _table_slots(keys: int) -> int:
    """Slots of an open-addressing table for ``keys`` keys: a power of two >= 2 keys."""
    slots = 1 << max(1, (2 * keys - 1).bit_length())
    if slots > 2**31:
        raise ValueError(f"{keys} keys exceed the hash table's index range")
    return slots


def lattice_dedup_neighbors(h1, h2, oh1, oh2):
    """K2: dedup the vertex hash pairs into rows; blur neighbours by hash linearity."""
    if not h1.is_cuda:
        return dedup_neighbors_plain(h1, h2, oh1, oh2)
    build.require("lattice_dedup_neighbors", (h1, torch.int32), (h2, torch.int32),
                  (oh1, torch.int32), (oh2, torch.int32))
    N = h1.shape[0]
    dp1, r2 = oh1.shape
    cap = _table_slots(N)
    dev = h1.device
    lib = build.library()
    table = torch.full((cap,), -2, dtype=torch.int64, device=dev)  # SGP_EMPTY
    slot_of = torch.empty(N, dtype=torch.int32, device=dev)
    row_of_slot = torch.empty(cap, dtype=torch.int32, device=dev)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    row_h1 = torch.empty(N, dtype=torch.int32, device=dev)
    row_h2 = torch.empty(N, dtype=torch.int32, device=dev)
    seg_ids = torch.empty(N, dtype=torch.int32, device=dev)
    neighbors = torch.empty((dp1, N, r2), dtype=torch.int32, device=dev)
    st = build.stream()
    rc = lib.sgp_dedup_insert(h1.data_ptr(), h2.data_ptr(), N, table.data_ptr(), cap - 1,
                              slot_of.data_ptr(), row_of_slot.data_ptr(), count.data_ptr(),
                              row_h1.data_ptr(), row_h2.data_ptr(), st)
    build.check(rc, "lattice_dedup_neighbors (insert)")
    rc = lib.sgp_dedup_finish(slot_of.data_ptr(), row_of_slot.data_ptr(), N, table.data_ptr(),
                              cap - 1, count.data_ptr(), row_h1.data_ptr(), row_h2.data_ptr(),
                              oh1.data_ptr(), oh2.data_ptr(), seg_ids.data_ptr(), dp1, r2,
                              neighbors.data_ptr(), st)
    build.check(rc, "lattice_dedup_neighbors (neighbors)")
    lattice_dedup_neighbors.launches += 1
    return seg_ids, neighbors, count


lattice_dedup_neighbors.launches = 0


def _blur_axes(dp1: int, transpose: bool):
    """The order of the d+1 axis blurs: B = B_d...B_0, and B^T = B_0...B_d.

    Each B_j is symmetric (symmetric taps; the neighbour at +t of row a is b
    exactly when the neighbour at -t of b is a, by hash linearity), so the
    transpose only reverses the order of the axes.
    """
    return range(dp1 - 1, -1, -1) if transpose else range(dp1)


def apply_plain(seg_ids, weights, neighbors, v, taps, slice_norm, transpose=False, return_table=False):
    """Plain K3 (apply_plan_join, :470): splat, d+1 axis blurs, slice.

    ``transpose`` applies ``slice_norm * S^T B^T S``; ``return_table`` also
    returns the blurred (M, c) table before the slice (B S v, or B^T S v).
    Differentiable by torch autograd in ``v`` and ``weights``.
    """
    n, dp1 = seg_ids.shape
    M = neighbors.shape[1]
    order = neighbors.shape[2] // 2
    c = v.shape[-1]
    seg = seg_ids.reshape(-1).long()
    contrib = (v[:, None, :] * weights[:, :, None]).reshape(n * dp1, c)
    table = torch.zeros((M, c), dtype=torch.float32, device=v.device).index_add_(0, seg, contrib)
    tap_list = [t for t in range(-order, order + 1) if t != 0]
    for j in _blur_axes(dp1, transpose):
        padded = torch.cat([table, torch.zeros((1, c), dtype=table.dtype, device=v.device)])
        acc = taps[order] * table
        for ti, t in enumerate(tap_list):
            acc = acc + taps[t + order] * padded[neighbors[j, :, ti].long()]
        table = acc
    gathered = table[seg_ids.long()]  # (n, d+1, c)
    out = (gathered * weights[:, :, None]).sum(dim=1) * slice_norm
    return (out, table) if return_table else out


def lattice_apply(seg_ids, weights, neighbors, n_lattice, v, taps, slice_norm, transpose=False,
                  return_table=False):
    """K3: ``slice_norm * S^T B S v`` for v (n, c) over a built plan.

    ``taps`` is the sequence of 2r+1 filter taps; ``n_lattice`` the live row
    count (a 0-d int32 tensor, read on the device).  ``transpose`` runs the
    axis blurs in reverse order (S^T B^T S); ``return_table`` also returns
    the blurred (M, c) table, whose rows past n_lattice are undefined.
    """
    if not v.is_cuda:
        return apply_plain(seg_ids, weights, neighbors, v, taps, slice_norm, transpose, return_table)
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
    st = build.stream()
    build.check(lib.sgp_lattice_splat(seg_ids.data_ptr(), weights.data_ptr(), v.data_ptr(), n,
                                      dp1, c, a.data_ptr(), st), "lattice_apply (splat)")
    for j in _blur_axes(dp1, transpose):
        rc = lib.sgp_lattice_blur(a.data_ptr(), b.data_ptr(), neighbors[j].data_ptr(),
                                  ctypes.addressof(taps_host), M, c, order,
                                  n_lattice.data_ptr(), st)
        build.check(rc, "lattice_apply (blur)")
        a, b = b, a
    build.check(lib.sgp_lattice_slice(a.data_ptr(), seg_ids.data_ptr(), weights.data_ptr(), n,
                                      dp1, c, float(slice_norm), out.data_ptr(), st),
                "lattice_apply (slice)")
    lattice_apply.launches += 1
    return (out, a) if return_table else out


lattice_apply.launches = 0


def lattice_filter_grad_plain(ref, E, seg_ids, v, g, table_f, table_b, slice_norm):
    """Plain K5: the gradient of <g, slice_norm S^T B S v> in the positions ref (n, d).

    ``table_f`` = B S v is the forward's blurred table and ``table_b`` =
    B^T S g the transposed apply's.  The weight gradient is
    gw[i,k] = slice_norm (g_i . table_f[seg_ik] + v_i . table_b[seg_ik]); it
    is chained back through the barycentric weights -- w[k] = t_(d-k) -
    t_(d+1-k) for k >= 1, w[0] = 1 + t_d - t_0, with t_r the scaled
    differential of rank r -- and the elevation x @ E^T.  Ranks, rounding
    and keys carry no gradient, as in JAX's autodiff.
    """
    n, d = ref.shape
    dp1 = d + 1
    seg = seg_ids.long()
    gw = slice_norm * ((g[:, None, :] * table_f[seg]).sum(-1) + (v[:, None, :] * table_b[seg]).sum(-1))
    _, rank = _simplex_rank(_elevate(ref, E), d)
    r = torch.arange(dp1, device=ref.device)
    grad_t_by_rank = gw[:, d - r] - gw[:, (d + 1 - r) % dp1]  # (n, d+1), by rank
    grad_elev = grad_t_by_rank.gather(1, rank.long()) * (1.0 / dp1)
    return grad_elev @ E


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


def filter_once_plain(x, E, a, oh1, oh2, v, taps, slice_norm, capacity):
    """Plain K4 (filter_fused, :1166): K1 + K2 + K3 plain, with JAX's capacity guard.

    Returns (out (n, c), n_lattice 0-d int32); ``out`` is all NaN when more
    than ``capacity`` lattice points are occupied (lattice.py:1295).
    """
    n, d = x.shape
    h1, h2, w = geometry_plain(x, E, a)
    seg, nb, n_lattice = dedup_neighbors_plain(h1, h2, oh1, oh2)
    out = apply_plain(seg.reshape(n, d + 1), w, nb, v, taps, slice_norm)
    return torch.where(n_lattice <= capacity, out, float("nan")), n_lattice


def lattice_filter_once(x, E, a, oh1, oh2, v, taps, slice_norm, capacity):
    """K4: the one-shot filter ``slice_norm * S^T B S v`` of v (n, c) at positions x (n, d).

    ``E``, ``a``, ``oh1``/``oh2`` are the elevation, the hash multipliers and
    the (d+1, 2r) neighbour offset hashes; ``capacity`` (1..n(d+1)) bounds
    the lattice table.  Returns (out, n_lattice as a 0-d int32 tensor).
    When more than ``capacity`` points are occupied, ``out`` is all NaN and
    the kernel's n_lattice is some count above the capacity (the plain
    version's is the true occupancy).
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
    lib = build.library()
    taps_host = (ctypes.c_float * len(taps))(*[float(t) for t in taps])
    i32 = dict(dtype=torch.int32, device=dev)
    table = torch.full((slots,), -2, dtype=torch.int64, device=dev)  # SGP_EMPTY
    row_of_slot = torch.empty(slots, **i32)
    row_h1, row_h2 = torch.empty(capacity, **i32), torch.empty(capacity, **i32)
    slot_of, seg = torch.empty(N, **i32), torch.empty(N, **i32)
    w = torch.empty(N, dtype=torch.float32, device=dev)
    count = torch.zeros((), **i32)
    ta = torch.zeros((capacity, c), dtype=torch.float32, device=dev)
    tb = torch.empty((capacity, c), dtype=torch.float32, device=dev)
    out = torch.empty((n, c), dtype=torch.float32, device=dev)
    rc = lib.sgp_filter_once(x.data_ptr(), E.data_ptr(), a.data_ptr(), n, d, oh1.data_ptr(),
                             oh2.data_ptr(), ctypes.addressof(taps_host), r2 // 2, v.data_ptr(), c,
                             float(slice_norm), capacity, slots - 1, table.data_ptr(),
                             row_of_slot.data_ptr(), row_h1.data_ptr(), row_h2.data_ptr(),
                             slot_of.data_ptr(), seg.data_ptr(), w.data_ptr(), count.data_ptr(),
                             ta.data_ptr(), tb.data_ptr(), out.data_ptr(), build.stream())
    build.check(rc, "lattice_filter_once")
    lattice_filter_once.launches += 1
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
    ``scale`` = 2 k'(0).
    """
    n, L = src.shape
    d = ref.shape[1]
    gf = g[:, :, None] * ref[:, None, :]
    sf = src[:, :, None] * ref[:, None, :]
    stacked = torch.cat([g, gf.reshape(n, L * d), src, sf.reshape(n, L * d)], dim=-1)
    filtered = apply_plain(seg_ids, weights, neighbors, stacked, taps, slice_norm)
    wg = filtered[:, :L]
    wgf = filtered[:, L:L + L * d].reshape(n, L, d)
    ws = filtered[:, L + L * d:2 * L + L * d]
    wsf = filtered[:, 2 * L + L * d:].reshape(n, L, d)
    return scale * (sf * wg[:, :, None] - src[:, :, None] * wgf + gf * ws[:, :, None]
                    - g[:, :, None] * wsf).sum(dim=1)


def lattice_deriv_grad(seg_ids, weights, neighbors, n_lattice, ref, src, g, taps, slice_norm, scale):
    """K7: the derivative-tap position gradient (see :func:`deriv_grad_plain`), (n, d).

    ``seg_ids`` (n, d+1), ``weights``, ``neighbors`` and ``n_lattice`` are
    the derivative plan; ``src`` and ``g`` are (n, L), ``ref`` (n, d).
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
    dev = ref.device
    lib = build.library()
    taps_host = (ctypes.c_float * len(taps))(*[float(t) for t in taps])
    a = torch.zeros((M, C), dtype=torch.float32, device=dev)
    b = torch.empty((M, C), dtype=torch.float32, device=dev)
    grad_ref = torch.empty((n, d), dtype=torch.float32, device=dev)
    st = build.stream()
    build.check(lib.sgp_deriv_splat(seg_ids.data_ptr(), weights.data_ptr(), ref.data_ptr(),
                                    src.data_ptr(), g.data_ptr(), n, d, L, a.data_ptr(), st),
                "lattice_deriv_grad (splat)")
    for j in range(d + 1):
        rc = lib.sgp_lattice_blur(a.data_ptr(), b.data_ptr(), neighbors[j].data_ptr(),
                                  ctypes.addressof(taps_host), M, C, order, n_lattice.data_ptr(), st)
        build.check(rc, "lattice_deriv_grad (blur)")
        a, b = b, a
    build.check(lib.sgp_deriv_slice(a.data_ptr(), seg_ids.data_ptr(), weights.data_ptr(), ref.data_ptr(),
                                    src.data_ptr(), g.data_ptr(), n, d, L, float(slice_norm),
                                    float(scale), grad_ref.data_ptr(), st),
                "lattice_deriv_grad (slice)")
    lattice_deriv_grad.launches += 1
    return grad_ref


lattice_deriv_grad.launches = 0
