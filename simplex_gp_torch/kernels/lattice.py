"""Lattice kernels K1-K3: wrappers over the CUDA kernels, beside their plain versions.

Each wrapper takes the plain PyTorch version for CPU tensors and launches its
kernel (``csrc/geometry.cu``, ``csrc/dedup.cu``, ``csrc/apply.cu``) for CUDA
tensors, raising on a failed build or launch; there is no fallback.  Each
counts its launches in a ``launches`` attribute.  The plain versions are the
PyTorch twin of the JAX join engine (simplex_gp_tpu/ops/lattice.py) and run
on either device.

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


def lattice_simplex(x: torch.Tensor, E: torch.Tensor):
    """Enclosing-simplex geometry: (keys (n, d+1, d) int32, weights (n, d+1) f32).

    Port of simplex_gp_tpu/ops/lattice.py::lattice_simplex (:141), with the
    canonical simplex table ``can[v][r] = v if r < d+1-v else v-(d+1)``
    (_canonical_simplex, :132) evaluated in place.
    """
    n, d = x.shape
    dp1 = d + 1
    elevated = _elevate(x, E)

    scale = 1.0 / dp1
    v = elevated * scale
    up = torch.ceil(v)
    down = torch.floor(v)
    pick_up = (up * dp1 - elevated) < (elevated - down * dp1)
    greedy_div = torch.where(pick_up, up, down).to(torch.int32)
    coord_sum = greedy_div.sum(dim=-1, dtype=torch.int32)

    diff = elevated - greedy_div.to(elevated.dtype) * dp1
    di = diff[:, :, None]
    dj = diff[:, None, :]
    idx = torch.arange(dp1, device=x.device)
    beats = (dj > di) | ((dj == di) & (idx[None, :] < idx[:, None]))
    rank = beats.sum(dim=-1, dtype=torch.int32)

    r2 = rank + coord_sum[:, None]
    too_hi = (r2 > d).to(torch.int32)
    too_lo = (r2 < 0).to(torch.int32)
    greedy_div = greedy_div - too_hi + too_lo
    rank = r2 - dp1 * too_hi + dp1 * too_lo
    greedy = greedy_div * dp1

    t = (elevated - greedy.to(elevated.dtype)) * scale
    zeros = torch.zeros((n, d + 2), dtype=t.dtype, device=x.device)
    plus = zeros.scatter(1, (d - rank).long(), t)
    minus = zeros.scatter(1, (d + 1 - rank).long(), t)
    bary = plus - minus
    bary[:, 0] += 1.0 + bary[:, d + 1]
    weights = bary[:, :dp1]

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


def lattice_dedup_neighbors(h1, h2, oh1, oh2):
    """K2: dedup the vertex hash pairs into rows; blur neighbours by hash linearity."""
    if not h1.is_cuda:
        return dedup_neighbors_plain(h1, h2, oh1, oh2)
    build.require("lattice_dedup_neighbors", (h1, torch.int32), (h2, torch.int32),
                  (oh1, torch.int32), (oh2, torch.int32))
    N = h1.shape[0]
    dp1, r2 = oh1.shape
    cap = 1 << max(1, (2 * N - 1).bit_length())  # power of two >= 2N
    if cap > 2**31:
        raise ValueError(f"lattice_dedup_neighbors: {N} keys exceed the table's index range")
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


def apply_plain(seg_ids, weights, neighbors, v, taps, slice_norm):
    """Plain K3 (apply_plan_join, :470): splat, d+1 axis blurs, slice."""
    n, dp1 = seg_ids.shape
    M = neighbors.shape[1]
    order = neighbors.shape[2] // 2
    c = v.shape[-1]
    seg = seg_ids.reshape(-1).long()
    contrib = (v[:, None, :] * weights[:, :, None]).reshape(n * dp1, c)
    table = torch.zeros((M, c), dtype=torch.float32, device=v.device).index_add_(0, seg, contrib)
    tap_list = [t for t in range(-order, order + 1) if t != 0]
    for j in range(dp1):
        padded = torch.cat([table, torch.zeros((1, c), dtype=table.dtype, device=v.device)])
        acc = taps[order] * table
        for ti, t in enumerate(tap_list):
            acc = acc + taps[t + order] * padded[neighbors[j, :, ti].long()]
        table = acc
    gathered = table[seg_ids.long()]  # (n, d+1, c)
    return (gathered * weights[:, :, None]).sum(dim=1) * slice_norm


def lattice_apply(seg_ids, weights, neighbors, n_lattice, v, taps, slice_norm):
    """K3: ``slice_norm * S^T B S v`` for v (n, c) over a built plan.

    ``taps`` is the sequence of 2r+1 filter taps; ``n_lattice`` the live row
    count (a 0-d int32 tensor, read on the device).
    """
    if not v.is_cuda:
        return apply_plain(seg_ids, weights, neighbors, v, taps, slice_norm)
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
    for j in range(dp1):
        rc = lib.sgp_lattice_blur(a.data_ptr(), b.data_ptr(), neighbors[j].data_ptr(),
                                  ctypes.addressof(taps_host), M, c, order,
                                  n_lattice.data_ptr(), st)
        build.check(rc, "lattice_apply (blur)")
        a, b = b, a
    build.check(lib.sgp_lattice_slice(a.data_ptr(), seg_ids.data_ptr(), weights.data_ptr(), n,
                                      dp1, c, float(slice_norm), out.data_ptr(), st),
                "lattice_apply (slice)")
    lattice_apply.launches += 1
    return out


lattice_apply.launches = 0
