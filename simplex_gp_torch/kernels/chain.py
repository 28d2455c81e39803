"""K3', the sort-chain plan: wrappers over ``csrc/chain.cu``, beside their plain versions.

K3'a ``chain_build`` builds the plan from K1's hashes, coordinate sums and
weights; K3'b ``chain_splat``, K3'c and K3'd ``chain_slice`` apply it.
K3'c is ``chain_axes``, all d+1 lattice axes in one launch with a grid
barrier between them, or ``chain_axis``, one axis a launch (the tests' and
the A/B's); ``chain_axes_transpose`` runs them transposed, in reverse axis
order over the inverse transitions (``chain_maps``), for the exact
backward.  :func:`chain_apply` launches the splat, the fused axes and the
slice from one host call, as the CG runs them, or with ``transpose`` the
transposed apply S^T B^T S.  :func:`chain_apply_sharded` is the sharded
apply of the data-parallel engine, over a rank's part of a sharded plan
(``chain_build(..., first=...)``): the splat by column blocks, the fused
axes on this rank's block between the two collectives, the blocks rejoined
(``chain_unblock``) and the slice.  Each wrapper takes its
plain PyTorch version for CPU tensors and launches its kernels for CUDA
tensors, raising on a failed build or launch; there is no fallback.  Each
kernel counts its launches in the ``launches`` attribute of its wrapper
(``chain_apply`` adds to those of the three it launches).  The plain versions are the PyTorch
twin of JAX's ``_chain_core`` / ``apply_plan_chain``
(simplex_gp_tpu/ops/lattice.py:693, :943) as the kernels compute it, and
run on either device.  The plain and the kernel build give the same plan,
bit for bit: the kernel dedups the contributions by hash and sorts only the
distinct points, then places each row's contributions in index order, the
order of the plain build's two stable sorts of all of them
(:func:`chain_build_staged` runs those stages in plain PyTorch).

Sort keys are int64: the high word the chain word c1, the low word the
packed word (top 11 bits of c2 over the biased coordinate sum in 21 bits)
with its sign bit flipped, so int64 order is the signed lexicographic order
of (c1, packed) that ``lax.sort`` gives.  A row past the live count has the
key INT64_MAX in every axis, so in every axis order the live rows come
first (see ``csrc/chain.cu``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import trace
from . import build

__all__ = [
    "ChainPlan",
    "PIECE",
    "SHORT",
    "chain_build_plain",
    "chain_build_staged",
    "chain_build",
    "chain_build_stage_times",
    "chain_apply_plain",
    "chain_apply",
    "chain_splat_plain",
    "chain_splat",
    "chain_axis_plain",
    "chain_axis",
    "chain_axes_plain",
    "chain_axes",
    "chain_maps_plain",
    "chain_maps",
    "chain_axes_transpose_plain",
    "chain_axes_transpose",
    "chain_slice_plain",
    "chain_slice",
    "chain_unblock_plain",
    "chain_unblock",
    "chain_apply_sharded_plain",
    "chain_apply_sharded",
    "run_lists",
    "run_lists_device",
    "slice_split",
]

_MASK32 = 0xFFFFFFFF
_S_BIAS = 1 << 20
_S_MASK = (1 << 21) - 1
_TOP_MASK = -(1 << 21)
_DEAD = 2**63 - 1
# A run of more contributions than this is summed in pieces of this many (CHAIN_PIECE in csrc/chain.cu).
PIECE = 1024
# A run of at most this many contributions is summed by one thread per column, a longer one by a warp
# (CHAIN_SHORT); the rows in between, the mid rows, are listed in the plan.
SHORT = 32
# K3'd's blocks (slice_split): at most this many threads (CHAIN_SLICE_THREADS) and points, the slabs of
# slice_idx and weights in at most this many bytes of shared memory (CHAIN_SLICE_SMEM), and a block takes
# fewer points where that spreads n over up to this many blocks an SM.
SLICE_THREADS = 256
SLICE_POINTS = 96
SLICE_SLAB_BYTES = 47 * 1024
SLICE_BLOCKS_PER_SM = 2


class ChainPlan(NamedTuple):
    """Sort-chain filter plan; N = n(d+1) contributions, Mc table rows, r = order.

      splat_points:  (N,) int32      point of each contribution, in table (axis-0) order
      splat_weights: (N,) f32        its barycentric weight
      cnt:           (Mc,) int32     end of each row's run of contributions (JAX's cnt); a sharded
                                     plan's covers its n_lattice live rows only, (n_lattice,)
      long_rows:     (NL,) int32     the rows of runs longer than PIECE, ascending
      long_first:    (NL+1,) int32   long row i's pieces are long_first[i] .. long_first[i+1]
      piece_row:     (NP,) int32     the row of each piece of PIECE contributions
      piece_start:   (NP,) int32     its first contribution
      n_long:        () int32        how many of long_rows are set
      n_pieces:      () int32        how many of piece_row are set
      mid_rows:      (NM,) int32     the rows of runs of SHORT+1 .. PIECE contributions, ascending
      n_mid:         () int32        how many of mid_rows are set
      gather:        (d, Mc) int32   position q of axis j+1 reads position gather[j, q] of axis j
      tapw:          (d+1, r, Mc) f32  the tap linking positions p and p+k of axis j
      slice_idx:     (n, d+1) int32  final (axis-d) position of each vertex's row
      weights:       (n, d+1) f32    barycentric weights
      n_lattice:     () int32        occupied lattice points (> Mc: the capacity overflowed)

    Mc is gather's and tapw's last dimension.  A rank's part of a sharded
    plan (:func:`chain_build` with ``first``) holds the whole build's gather,
    tapw and n_lattice, and for the splat and slice this rank's
    contributions only: splat_points numbered by local point, cnt counting
    them, slice_idx and weights of the local points.
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
    gather: torch.Tensor
    tapw: torch.Tensor
    slice_idx: torch.Tensor
    weights: torch.Tensor
    n_lattice: torch.Tensor


def _wrap32(h: torch.Tensor) -> torch.Tensor:
    """int64 -> the int64 holding the int32 with the same low 32 bits."""
    return ((h & _MASK32) ^ 0x80000000) - 0x80000000


def _key(c1: torch.Tensor, c2: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """int64 sort key of chain words (c1, c2) and coordinate sum s (int64 tensors of int32 values)."""
    packed = (_wrap32(c2) & _TOP_MASK) | torch.clamp(s + _S_BIAS, 0, _S_MASK)
    return _wrap32(c1) * 2**32 | ((packed + 2**31) & _MASK32)


def _rows(N: int, capacity) -> int:
    if capacity is None:
        return N
    if capacity < 1:
        raise ValueError(f"capacity {capacity} is below 1")
    return min(int(capacity), N)


def _long_bounds(N: int, Mc: int) -> tuple:
    """Bounds on the long rows, their pieces and the mid rows: the runs are disjoint, a long one longer
    than PIECE, a mid one longer than SHORT."""
    nl = min(Mc, N // (PIECE + 1))
    return nl, N // PIECE + nl, min(Mc, N // (SHORT + 1))


def _tap_weights(keys: torch.Tensor, live: int, d: int, taps) -> torch.Tensor:
    """(d+1, r, Mc) taps from each axis's keys in its own order (_axis_tap_weights, :666-690)."""
    dp1, Mc = keys.shape
    order = (len(taps) - 1) // 2
    hi, lo = keys >> 21, keys & _S_MASK
    pos = torch.arange(Mc, device=keys.device)
    step = torch.tensor([1] * d + [d], device=keys.device)[:, None]
    tapw = torch.zeros((dp1, order, Mc), dtype=torch.float32, device=keys.device)
    for k in range(1, order + 1):
        if k >= Mc:
            break
        same = (hi[:, k:] == hi[:, :-k]) & (pos[None, :-k] + k < live)
        ds = lo[:, k:] - lo[:, :-k]
        w = torch.zeros(same.shape, dtype=torch.float32, device=keys.device)
        for t in range(k, order + 1):
            w = torch.where(same & (ds == t * step), float(taps[order + t]), w)
        tapw[:, k - 1, :-k] = w
    return tapw


def run_lists(cnt: torch.Tensor, live: int, N: int) -> tuple:
    """The plan's splat work lists from its run ends ``cnt`` (Mc,), of which the first ``live`` rows hold
    runs: (long_rows, long_first, piece_row, piece_start, n_long, n_pieces, mid_rows, n_mid), each
    list zero-padded to its bound (see :class:`ChainPlan`)."""
    dev, Mc = cnt.device, cnt.shape[0]
    start = torch.cat([cnt.new_zeros(1), cnt[:-1]])
    length = cnt - start
    is_live = torch.arange(Mc, device=dev) < live
    long_idx = torch.nonzero(is_live & (length > PIECE)).flatten()
    mid_idx = torch.nonzero(is_live & (length > SHORT) & (length <= PIECE)).flatten()
    pieces = (length[long_idx] + PIECE - 1) // PIECE
    nl_max, np_max, nm_max = _long_bounds(N, Mc)
    nl, n_pc, nm = long_idx.shape[0], int(pieces.sum()), mid_idx.shape[0]
    i32 = dict(dtype=torch.int32, device=dev)
    long_rows = torch.zeros(nl_max, **i32)
    long_rows[:nl] = long_idx.to(torch.int32)
    long_first = torch.zeros(nl_max + 1, **i32)
    long_first[1:nl + 1] = torch.cumsum(pieces, 0, dtype=torch.int32)
    piece_row, piece_start = torch.zeros(np_max, **i32), torch.zeros(np_max, **i32)
    piece_row[:n_pc] = torch.repeat_interleave(long_idx, pieces.long()).to(torch.int32)
    within = torch.arange(n_pc, device=dev) - torch.repeat_interleave(long_first[:nl].long(), pieces.long())
    piece_start[:n_pc] = (start[piece_row[:n_pc].long()] + PIECE * within).to(torch.int32)
    mid_rows = torch.zeros(nm_max, **i32)
    mid_rows[:nm] = mid_idx.to(torch.int32)
    return (long_rows, long_first, piece_row, piece_start, torch.tensor(nl, **i32), torch.tensor(n_pc, **i32),
            mid_rows, torch.tensor(nm, **i32))


def chain_build_plain(h1, h2, s, weights, consts, taps, capacity=None, first=None) -> ChainPlan:
    """Plain K3'a (_chain_core, :693-836, and build_plan_chain's slice index, :894).

    ``h1``, ``h2``, ``s`` (N,) int32 are K1's vertex hashes and coordinate
    sums, point-major; ``weights`` (n, d+1); ``consts`` (3, d+1) int32 the
    per-axis oh1, oh2 and mult; ``taps`` the 2r+1 filter taps.  The table
    has Mc = min(capacity, N) rows; past that the build drops points
    without an out-of-bounds write, and n_lattice, the true occupancy, trips
    the slice's guard.

    With ``first``, one rank's part of the sharded plan
    (shard_filter.py::build_plan_sharded, :50-115): h1, h2 and s are every
    rank's contributions, ``weights`` (n_loc, d+1) this rank's, which are
    contributions first .. first + n_loc (d+1) - 1.  The rows, gather, tapw
    and n_lattice are the whole build's; the splat lists hold this rank's
    contributions, in the rows' order and within a row in index order
    (JAX's dest_loc and cnt_loc, :91-101), cnt the live rows' only, and
    slice_idx this rank's points.
    """
    dev = h1.device
    N = h1.shape[0]
    n, dp1 = weights.shape
    d = dp1 - 1
    Nw, lo = n * dp1, 0 if first is None else first
    Mc = _rows(N, capacity)
    oh1, oh2, mult = (row.long() for row in consts)
    h1, h2, s = h1.long(), h2.long(), s.long()
    key = _key(h1 - s * oh1[0], h2 - s * oh2[0], s)  # axis 0: mult 1
    p1 = torch.sort(h2.to(torch.int32), stable=True).indices
    perm = p1[torch.sort(key[p1], stable=True).indices]
    ks, h2s = key[perm], h2[perm]
    flag = torch.ones(N, dtype=torch.int32, device=dev)
    flag[1:] = ((ks[1:] != ks[:-1]) | (h2s[1:] != h2s[:-1])).to(torch.int32)
    seg = torch.cumsum(flag, 0, dtype=torch.int32)
    n_lattice = seg[-1].clone()
    nl = int(n_lattice)
    live = min(nl, Mc)
    u_pos = torch.nonzero(flag).flatten()[:live]
    rank = torch.empty(N, dtype=torch.int64, device=dev)  # each contribution's point in (key, h2) order
    rank[perm] = seg.long() - 1
    # This rank's contributions in row order: the window's entries of perm, which keep their index order.
    mine = (perm >= lo) & (perm < lo + Nw)
    local, local_rank = perm[mine] - lo, (seg.long() - 1)[mine]
    cnt = torch.full((Mc,), Nw, dtype=torch.int32, device=dev)
    cnt[:live - 1] = torch.searchsorted(local_rank, torch.arange(live - 1, device=dev), right=True).to(torch.int32)
    row_of = rank[lo:lo + Nw].clamp(max=Mc - 1)

    uk = ks[u_pos]
    c1 = uk >> 32
    us = ((uk & _MASK32) & _S_MASK) - _S_BIAS
    uh1 = _wrap32(c1 + us * oh1[0])
    uh2 = h2s[u_pos]
    keys = torch.full((dp1, Mc), _DEAD, dtype=torch.int64, device=dev)
    keys[:, :live] = _key(mult[:, None] * uh1 - us * oh1[:, None], mult[:, None] * uh2 - us * oh2[:, None], us)
    sorted_keys, order_j = torch.sort(keys[1:], dim=1, stable=True)
    tapw = _tap_weights(torch.cat([keys[:1], sorted_keys]), live, d, taps)
    pos = torch.empty_like(order_j)
    pos.scatter_(1, order_j, torch.arange(Mc, device=dev).expand(d, Mc).contiguous())
    gather = torch.cat([order_j[:1], torch.gather(pos[:-1], 1, order_j[1:])]).to(torch.int32)
    slice_idx = pos[-1][row_of].to(torch.int32).reshape(n, dp1)

    flat_w = weights.reshape(-1)
    lists = run_lists(cnt, live, Nw)
    return ChainPlan((local // dp1).to(torch.int32), flat_w[local].contiguous(),
                     cnt if first is None else cnt[:live], *lists, gather.contiguous(), tapw, slice_idx, weights,
                     n_lattice)


def chain_build_staged(h1, h2, s, weights, consts, taps, capacity=None, seed=0) -> ChainPlan:
    """K3'a's stages in plain PyTorch: the same plan as :func:`chain_build_plain`, by the kernel's route.

    Dedup the N contributions on their point (axis-0 key, h2), in an order
    that stands for the hash table's race (a seeded shuffle of the distinct
    points); sort only the distinct points, stable by h2 then by key, so a
    point's rank is its table row; place each row's contributions in index
    order by a stable sort of the ranks; then the rows (cnt, the first Mc
    points' axis keys, their sort over the live rows only) and the overflow
    rule: past the capacity the last live row's run ends at N and the
    dropped points' contributions read the last row.
    """
    dev = h1.device
    N = h1.shape[0]
    n, dp1 = weights.shape
    d = dp1 - 1
    Mc = _rows(N, capacity)
    oh1, oh2, mult = (row.long() for row in consts)
    h1, h2, s = h1.long(), h2.long(), s.long()
    key = _key(h1 - s * oh1[0], h2 - s * oh2[0], s)
    # dedup: the distinct points in a race-like order, and each contribution's point
    pairs, point = torch.unique(torch.stack([key, _wrap32(h2)], 1), dim=0, return_inverse=True)
    nl = pairs.shape[0]
    shuffle = torch.randperm(nl, generator=torch.Generator().manual_seed(seed)).to(dev)
    pairs, point = pairs[shuffle], torch.argsort(shuffle)[point]
    # the distinct points sorted by (key, h2): a point's rank is its row
    p1 = torch.sort(pairs[:, 1].to(torch.int32), stable=True).indices
    p2 = torch.sort(pairs[p1, 0], stable=True).indices
    order = p1[p2]
    rank_of = torch.empty(nl, dtype=torch.int64, device=dev)
    rank_of[order] = torch.arange(nl, device=dev)
    rank = rank_of[point]
    # the stable placement: each row's contributions in index order
    sorted_rank, perm = torch.sort(rank, stable=True)
    ends = torch.searchsorted(sorted_rank, torch.arange(nl, device=dev), right=True)
    live = min(nl, Mc)
    cnt = torch.full((Mc,), N, dtype=torch.int32, device=dev)
    cnt[:live - 1] = ends[:live - 1].to(torch.int32)
    # the rows: the first Mc points' keys along every axis, sorted over the live rows only
    uk, uh2 = pairs[order[:live], 0], pairs[order[:live], 1]
    c1 = uk >> 32
    us = ((uk & _MASK32) & _S_MASK) - _S_BIAS
    uh1 = _wrap32(c1 + us * oh1[0])
    keys = torch.full((dp1, Mc), _DEAD, dtype=torch.int64, device=dev)
    keys[:, :live] = _key(mult[:, None] * uh1 - us * oh1[:, None], mult[:, None] * uh2 - us * oh2[:, None], us)
    order_j = torch.arange(Mc, device=dev).repeat(d, 1)
    sorted_keys = keys[1:].clone()
    sorted_keys[:, :live], order_j[:, :live] = torch.sort(keys[1:, :live], dim=1, stable=True)
    tapw = _tap_weights(torch.cat([keys[:1], sorted_keys]), live, d, taps)
    pos = torch.empty_like(order_j)
    pos.scatter_(1, order_j, torch.arange(Mc, device=dev).expand(d, Mc).contiguous())
    gather = torch.cat([order_j[:1], torch.gather(pos[:-1], 1, order_j[1:])]).to(torch.int32)
    slice_idx = pos[-1][rank.clamp(max=Mc - 1)].to(torch.int32).reshape(n, dp1)
    flat_w = weights.reshape(-1)
    return ChainPlan((perm // dp1).to(torch.int32), flat_w[perm].contiguous(), cnt, *run_lists(cnt, live, N),
                     gather.contiguous(), tapw, slice_idx, weights, torch.tensor(nl, dtype=torch.int32, device=dev))


def _carve(dev, parts: dict) -> dict:
    """One allocation cut into contiguous views, ``parts`` name -> (dtype, numel), each 256-byte aligned."""
    offsets, total = {}, 0
    for name, (dtype, numel) in parts.items():
        offsets[name] = total
        total += -(-numel * dtype.itemsize // 256) * 256
    buf = torch.empty(max(total, 1), dtype=torch.uint8, device=dev)
    return {name: buf[offsets[name]:offsets[name] + numel * dtype.itemsize].view(dtype)
            for name, (dtype, numel) in parts.items()}


def chain_build(h1, h2, s, weights, consts, taps, capacity=None, first=None) -> ChainPlan:
    """K3'a: the sort-chain plan from K1's hashes, coordinate sums and weights, on the card.

    The same plan as :func:`chain_build_plain`, bit for bit, by the stages
    of :func:`chain_build_staged`: six entry points of ``csrc/chain.cu``
    (dedup, rank, place, rows, finish, and the run lists') around three
    ``torch.sort`` calls (the distinct points by key, the N ranks, the live
    rows' axis keys batched); one host read (n_lattice, which sizes the
    sorts); one workspace and one output allocation; counted once per build.
    Each stage is a span (``plan.dedup``, ``plan.read``, ... ``plan.run
    lists``; :mod:`simplex_gp_torch.trace`).
    With ``first`` (a sharded plan's rank, see :func:`chain_build_plain`)
    the dedup and the ranks cover every rank's contributions, and the
    stages from the sort of the ranks on only this rank's window of them:
    its ranks sorted, placed with its weights, its run ends and run lists
    over the global rows, its slice_idx.
    """
    if not h1.is_cuda:
        return chain_build_plain(h1, h2, s, weights, consts, taps, capacity, first)
    build.require("chain_build", (h1, torch.int32), (h2, torch.int32), (s, torch.int32),
                  (weights, torch.float32), (consts, torch.int32))
    dev = h1.device
    N = h1.shape[0]
    n, dp1 = weights.shape
    d = dp1 - 1
    order = (len(taps) - 1) // 2
    Nw, lo = n * dp1, 0 if first is None else first
    if ((N != Nw if first is None else (lo < 0 or lo + Nw > N or N % dp1)) or tuple(consts.shape) != (3, dp1)
            or len(taps) != 2 * order + 1 or order < 1):
        raise ValueError(f"chain_build: {N} vertices from {lo}, consts {tuple(consts.shape)} and {len(taps)} taps "
                         f"do not fit {n} points of dimension {d}")
    Mc = _rows(N, capacity)
    slots = 1 << max(1, (2 * N - 1).bit_length())  # >= 2N: every distinct point fits
    if slots > 2**31:
        raise ValueError(f"chain_build: {N} contributions exceed the dedup table's index range")
    lib, st = build.library(), build.stream()
    i32, i64 = torch.int32, torch.int64
    ws = _carve(dev, dict(table=(i32, slots), rep_of=(i32, N), uniq_key=(i64, N), uniq_h2=(i32, N),
                          uniq_rep=(i32, N), row_key=(i64, Mc), row_h2=(i32, Mc), keys=(i64, dp1 * Mc),
                          pos=(i32, d * Mc), long_info=(i32, 3 * Mc)))
    sizes = dict(sp=Nw, sw=Nw, cnt=Mc, gather=d * Mc, tapw=dp1 * order * Mc, slice_idx=Nw, n_lattice=1)
    out = dict(zip(sizes, torch.empty(sum(sizes.values()), dtype=i32, device=dev).split(list(sizes.values()))))
    n_lattice = out["n_lattice"].view(())
    with trace.span("plan.dedup"):
        build.check(lib.sgp_chain_dedup(h1.data_ptr(), h2.data_ptr(), s.data_ptr(), N, consts.data_ptr(), dp1,
                                        ws["table"].data_ptr(), slots - 1, ws["rep_of"].data_ptr(),
                                        ws["uniq_key"].data_ptr(), ws["uniq_h2"].data_ptr(),
                                        ws["uniq_rep"].data_ptr(), n_lattice.data_ptr(), st), "chain_build (dedup)")
    with trace.span("plan.read"):
        nl = int(n_lattice)
        trace.count("host_read.chain_build")
    live = min(nl, Mc)
    with trace.span("plan.unique sort"):
        sk, p = torch.sort(ws["uniq_key"][:nl])  # equal keys' order is fixed by h2 in the rank stage
    # The table's slots are free now: the ranks by representative and by contribution take them; an int16
    # sort key (half torch.sort's radix passes) takes the unique keys' bytes.
    rank_by_rep, rank = ws["table"][:N], ws["table"][N:2 * N]
    key16 = ws["uniq_key"].view(torch.int16)[:N] if nl < 2**15 else None
    with trace.span("plan.rank"):
        build.check(lib.sgp_chain_rank(sk.data_ptr(), p.data_ptr(), ws["uniq_h2"].data_ptr(),
                                       ws["uniq_rep"].data_ptr(), nl, Mc, ws["rep_of"].data_ptr(), N,
                                       rank_by_rep.data_ptr(), ws["row_key"].data_ptr(), ws["row_h2"].data_ptr(),
                                       rank.data_ptr(), None if key16 is None else key16.data_ptr(), st),
                    "chain_build (rank)")
    with trace.span("plan.rank sort"):
        sorted_rank, perm = torch.sort((rank if key16 is None else key16)[lo:lo + Nw], stable=True)
    sw = out["sw"].view(torch.float32)
    with trace.span("plan.place"):
        build.check(lib.sgp_chain_place(perm.data_ptr(), weights.data_ptr(), Nw, dp1, out["sp"].data_ptr(),
                                        sw.data_ptr(), st), "chain_build (place)")
    del perm
    keys, long_info = ws["keys"][:dp1 * live].view(dp1, live), ws["long_info"].view(3, Mc)
    with trace.span("plan.rows"):
        build.check(lib.sgp_chain_rows(ws["row_key"].data_ptr(), ws["row_h2"].data_ptr(), sorted_rank.data_ptr(),
                                       int(key16 is not None), live, Nw, Mc, d, consts.data_ptr(),
                                       out["cnt"].data_ptr(), keys.data_ptr(), long_info.data_ptr(), st),
                    "chain_build (rows)")
    del sorted_rank
    with trace.span("plan.axis sort"):
        sorted_keys, order_j = torch.sort(keys[1:], dim=1, stable=True)
    taps_host = (ctypes.c_float * len(taps))(*[float(t) for t in taps])
    tapw = out["tapw"].view(torch.float32).view(dp1, order, Mc)
    gather, slice_idx = out["gather"].view(d, Mc), out["slice_idx"].view(n, dp1)
    with trace.span("plan.finish"):
        build.check(lib.sgp_chain_finish(keys.data_ptr(), sorted_keys.data_ptr(), order_j.data_ptr(),
                                         rank[lo:].data_ptr(), live, Mc, d, order, ctypes.addressof(taps_host), Nw,
                                         tapw.data_ptr(), ws["pos"].data_ptr(), gather.data_ptr(),
                                         slice_idx.data_ptr(), st), "chain_build (finish)")
    with trace.span("plan.run lists"):
        lists = run_lists_device(long_info, out["cnt"], Nw)
    chain_build.launches += 1
    cnt = out["cnt"] if first is None else out["cnt"][:live]
    return ChainPlan(out["sp"], sw, cnt, *lists, gather, tapw, slice_idx, weights, n_lattice)


def chain_build_stage_times(build_call) -> dict:
    """One ``build_call()`` (a :func:`chain_build` on the card) split by its stages, from the stage spans of
    :mod:`simplex_gp_torch.trace`: for each, the device ms between its CUDA events and its host ms."""
    torch.cuda.synchronize()
    with trace.recording():
        first = len(trace.records())
        build_call()
        torch.cuda.synchronize()
        spans = trace.records()[first:]
    return {r["name"][len("plan."):]: dict(device_ms=r["ms"], host_ms=r["host_ms"])
            for r in spans if r["name"].startswith("plan.")}


def run_lists_device(long_info: torch.Tensor, cnt: torch.Tensor, N: int) -> tuple:
    """:func:`run_lists` on the card, from each row's class: ``long_info`` (3, Mc) holds the long flag, the
    number of pieces and the mid flag of every row (0 past the live rows; csrc/rows.cuh, sgp_run_class).
    A ``torch.cumsum`` of each of its rows and one launch (``sgp_run_lists``) place the long rows, their
    pieces and the mid rows (a join plan's row lists do the same in C, csrc/join_rows.cu)."""
    i32 = dict(dtype=torch.int32, device=cnt.device)
    Mc = cnt.shape[0]
    # One 1-D scan a row: PyTorch scans the innermost dimension of a (3, Mc) tensor a few blocks a row, with
    # which K9's row lists took 25.8 ms at Mc = 15.7M on an H100 against 1.6 ms with these (PERF.md section
    # 6); an (Mc, 3) layout scanned along its outer dimension made the elevators build 18 ms, not 2.1.
    scan = torch.empty_like(long_info)
    for i in range(3):
        torch.cumsum(long_info[i], 0, out=scan[i])
    nl_max, np_max, nm_max = _long_bounds(N, Mc)
    # The eight lists in one zeroed allocation (their padding is 0), each a view.
    sizes = (nl_max, nl_max + 1, np_max, np_max, nm_max, 1, 1, 1)
    long_rows, long_first, piece_row, piece_start, mid_rows, n_long, n_pieces, n_mid = (
        torch.zeros(sum(sizes), **i32).split(sizes))
    n_long, n_pieces, n_mid = n_long.view(()), n_pieces.view(()), n_mid.view(())
    build.check(build.library().sgp_run_lists(
        long_info.data_ptr(), scan.data_ptr(), cnt.data_ptr(), Mc, long_rows.data_ptr(), long_first.data_ptr(),
        piece_row.data_ptr(), piece_start.data_ptr(), n_long.data_ptr(), n_pieces.data_ptr(), mid_rows.data_ptr(),
        n_mid.data_ptr(), build.stream()), "run lists")
    return long_rows, long_first, piece_row, piece_start, n_long, n_pieces, mid_rows, n_mid


chain_build.launches = 0


def _lane_sums(contrib, slot, k, slots):
    """(slots, c): slot i the sum, in order of k, of the contributions that land in it (one per k)."""
    acc = contrib.new_zeros((slots, contrib.shape[1]))
    if k.numel() == 0:
        return acc
    order = torch.argsort(k, stable=True)
    bounds = torch.cumsum(torch.bincount(k), 0).tolist()
    lo = 0
    for hi in bounds:  # within one k every slot appears at most once: each add is exact f32 rounding
        idx = order[lo:hi]
        acc.index_add_(0, slot[idx], contrib[idx])
        lo = hi
    return acc


def _butterfly(acc):
    """(R, 32, c) lane values -> (R, c): lane 0 after the kernel's xor shuffles (x + shfl_xor(x, off))."""
    lane = torch.arange(32, device=acc.device)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lane ^ off]
    return acc[:, 0]


def _warp_sums(values, run, offset, runs):
    """(runs, c): run i the kernel's warp sum of its values (lane l adds offsets l, l + 32, ... in turn,
    then the butterfly); ``run`` and ``offset`` give each value's run and place in it."""
    lanes = _lane_sums(values, run * 32 + offset % 32, offset // 32, runs * 32)
    return _butterfly(lanes.reshape(runs, 32, values.shape[1]))


def chain_splat_plain(plan: ChainPlan, v):
    """Plain K3'b: the (Mc, c) axis-0 table, row g the sum of its run of weighted rows of v.

    Sums in the kernel's order, so that the two agree bit for bit: a run of
    at most PIECE contributions by one warp (the kernel's thread-per-column
    fold of a run of at most SHORT is the same order); a longer one in
    pieces of PIECE, a warp each, whose sums a warp per row adds up.
    """
    N, Mc = plan.splat_points.shape[0], plan.cnt.shape[0]
    dev = v.device
    start = torch.cat([plan.cnt.new_zeros(1), plan.cnt[:-1]]).long()
    row = torch.searchsorted(plan.cnt, torch.arange(N, dtype=torch.int32, device=dev), right=True)
    off = torch.arange(N, device=dev) - start[row]
    contrib = plan.splat_weights[:, None] * v[plan.splat_points.long()]
    nl, n_pc = int(plan.n_long), int(plan.n_pieces)
    long_rows = plan.long_rows[:nl].long()
    is_long = torch.zeros(Mc, dtype=torch.bool, device=dev)
    is_long[long_rows] = True
    short = ~is_long[row]
    table = v.new_zeros((Mc, v.shape[1]))  # a row with no contribution stays 0
    held, run = torch.unique_consecutive(row[short], return_inverse=True)  # the rows that hold short runs
    table[held] = _warp_sums(contrib[short], run, off[short], held.shape[0])
    if nl:
        first = torch.zeros(Mc, dtype=torch.long, device=dev)
        first[long_rows] = plan.long_first[:nl].long()
        lg = ~short
        part = _warp_sums(contrib[lg], first[row[lg]] + off[lg] // PIECE, off[lg] % PIECE, n_pc)
        owner = torch.repeat_interleave(torch.arange(nl, device=dev),
                                        (plan.long_first[1:nl + 1] - plan.long_first[:nl]).long())
        table[long_rows] = _warp_sums(part, owner, torch.arange(n_pc, device=dev) - plan.long_first[owner].long(),
                                      nl)
    return table.contiguous()


def _require_apply(what: str, plan: ChainPlan, v: torch.Tensor) -> None:
    build.require(what, (plan.splat_points, torch.int32), (plan.splat_weights, torch.float32),
                  (plan.cnt, torch.int32), (plan.long_rows, torch.int32), (plan.long_first, torch.int32),
                  (plan.n_long, torch.int32), (plan.piece_row, torch.int32), (plan.piece_start, torch.int32),
                  (plan.n_pieces, torch.int32), (plan.mid_rows, torch.int32), (plan.n_mid, torch.int32),
                  (plan.n_lattice, torch.int32), (v, torch.float32))
    if v.shape[0] != plan.weights.shape[0]:
        raise ValueError(f"{what}: v {tuple(v.shape)} does not fit a plan of {plan.weights.shape[0]} points")


def _splat_args(plan: ChainPlan) -> tuple:
    return (plan.splat_points.data_ptr(), plan.splat_weights.data_ptr(), plan.cnt.data_ptr(),
            plan.long_rows.data_ptr(), plan.long_first.data_ptr(), plan.n_long.data_ptr(), plan.piece_row.data_ptr(),
            plan.piece_start.data_ptr(), plan.n_pieces.data_ptr(), plan.mid_rows.data_ptr(), plan.n_mid.data_ptr(),
            plan.long_rows.shape[0], plan.mid_rows.shape[0], plan.piece_row.shape[0], plan.splat_points.shape[0],
            plan.n_lattice.data_ptr())


def chain_splat(plan: ChainPlan, v: torch.Tensor) -> torch.Tensor:
    """K3'b: the axis-0 table (Mc, c) of v (n, c), each row summed in a fixed order (no atomics).

    The short rows (a thread per row and column), the mid rows and the
    pieces (a warp each) in one launch; the long rows from their pieces in a
    second.
    Rows past the live count are left undefined; no later kernel reads them.
    """
    if not v.is_cuda:
        return chain_splat_plain(plan, v)
    _require_apply("chain_splat", plan, v)
    c, Mc = v.shape[1], plan.cnt.shape[0]
    table = torch.empty((Mc, c), dtype=torch.float32, device=v.device)
    part = torch.empty((plan.piece_row.shape[0], c), dtype=torch.float32, device=v.device)
    build.check(build.library().sgp_chain_splat(*_splat_args(plan), v.data_ptr(), c, Mc, table.data_ptr(),
                                                part.data_ptr(), build.stream()), "chain_splat")
    chain_splat.launches += 1
    return table


chain_splat.launches = 0


def chain_axis_plain(table, tapw_j, gather_j, taps):
    """Plain K3'c: one axis's (2r+1)-tap stencil (_chain_stencil_1d, :915-922), then its transition gather."""
    order = tapw_j.shape[0]
    c = table.shape[1]
    acc = taps[order] * table
    for k in range(1, order + 1):
        w = tapw_j[k - 1][:, None]
        z = table.new_zeros((k, c))
        acc = acc + w * torch.cat([table[k:], z]) + torch.cat([z, (w * table)[:-k]])
    return acc if gather_j is None else acc[gather_j.long()]


def chain_axis(table: torch.Tensor, tapw_j: torch.Tensor, gather_j, n_lattice: torch.Tensor, taps) -> torch.Tensor:
    """K3'c: the blur along one lattice axis of a table in that axis's order, written in the next axis's order.

    ``tapw_j`` (r, Mc) is the axis's taps, ``gather_j`` (Mc,) its transition
    (None for the last axis, whose order is final).  Positions past the live
    count are left undefined.
    """
    if not table.is_cuda:
        return chain_axis_plain(table, tapw_j, gather_j, taps)
    build.require("chain_axis", (table, torch.float32), (tapw_j, torch.float32), (n_lattice, torch.int32))
    if gather_j is not None:
        build.require("chain_axis", (gather_j, torch.int32))
    Mc, c = table.shape
    order = tapw_j.shape[0]
    if tuple(tapw_j.shape) != (order, Mc) or len(taps) != 2 * order + 1:
        raise ValueError(f"chain_axis: taps {tuple(tapw_j.shape)} / {len(taps)} do not fit a table of {Mc} rows")
    out = torch.empty_like(table)
    lib = build.library()
    build.check(lib.sgp_chain_axis(table.data_ptr(), out.data_ptr(), tapw_j.data_ptr(),
                                   None if gather_j is None else gather_j.data_ptr(), n_lattice.data_ptr(), Mc, c,
                                   order, float(taps[order]), build.stream()), "chain_axis")
    chain_axis.launches += 1
    return out


chain_axis.launches = 0


def chain_axes_plain(table, plan: ChainPlan, taps):
    """Plain fused K3'c: the d+1 axis stencils and transitions of an apply, as the fused kernel runs them.

    Only the live positions are computed: a tap past the live count is
    skipped, not multiplied by 0, and a row past it is never read.  Every
    element takes chain_axis_plain's operations in its order, so over the
    live rows the two agree bit for bit.  Returns the final-order table
    (Mc, c); rows past the live count keep ``table``'s values.
    """
    d, order = plan.gather.shape[0], plan.tapw.shape[1]
    live = min(int(plan.n_lattice), table.shape[0])
    a, b = table.clone(), table.clone()
    for j in range(d + 1):
        t = a[:live]
        acc = taps[order] * t
        for k in range(1, min(order, live - 1) + 1):
            w = plan.tapw[j, k - 1, :live - k, None]
            acc[:live - k] = acc[:live - k] + w * t[k:]
            acc[k:] = acc[k:] + w * t[:live - k]
        b[:live] = acc[plan.gather[j, :live].long()] if j < d else acc
        a, b = b, a
    return a


def chain_axes(table: torch.Tensor, plan: ChainPlan, taps) -> torch.Tensor:
    """K3'c fused: the d+1 axes of ``table`` (Mc, c, axis-0 order) in one launch, the final-order table out.

    A grid of resident blocks runs axis 0, then each next axis after a grid
    barrier, the table passing between two buffers.  ``table`` is one of
    them and is overwritten; rows past the live count are left undefined.
    """
    if not table.is_cuda:
        return chain_axes_plain(table, plan, taps)
    build.require("chain_axes", (table, torch.float32), (plan.tapw, torch.float32), (plan.gather, torch.int32),
                  (plan.n_lattice, torch.int32))
    (Mc, c), d, order = table.shape, plan.gather.shape[0], plan.tapw.shape[1]
    if tuple(plan.tapw.shape) != (d + 1, order, Mc) or len(taps) != 2 * order + 1:
        raise ValueError(f"chain_axes: taps {tuple(plan.tapw.shape)} / {len(taps)} do not fit a table of {Mc} rows "
                         f"and {d + 1} axes")
    other = torch.empty_like(table)
    barrier = torch.empty(1, dtype=torch.int32, device=table.device)
    build.check(build.library().sgp_chain_axes(table.data_ptr(), other.data_ptr(), plan.tapw.data_ptr(),
                                               plan.gather.data_ptr(), plan.n_lattice.data_ptr(), Mc, c, d, order,
                                               float(taps[order]), barrier.data_ptr(), build.stream()),
                "chain_axes")
    chain_axes.launches += 1
    return table if (d + 1) % 2 == 0 else other


chain_axes.launches = 0


def chain_maps_plain(gather: torch.Tensor) -> torch.Tensor:
    """The transposed axes' maps (d+1, Mc) int32 of a plan's transitions ``gather`` (d, Mc).

    Row d-1-j is the inverse of transition j (tmap[d-1-j][gather[j][q]] = q):
    each transition is a permutation of the live rows (every axis order sorts
    the dead rows last, in row order, so past the live rows it is the
    identity), and its transpose is that inverse.  Row d is the composite
    G, the axis-0 position of the row at final position q:
    G[q] = gather[0][gather[1][... gather[d-1][q]]].
    """
    d, Mc = gather.shape
    tmap = torch.empty((d + 1, Mc), dtype=torch.int32, device=gather.device)
    q = torch.arange(Mc, device=gather.device)
    p = q
    for j in range(d - 1, -1, -1):
        tmap[d - 1 - j, gather[j].long()] = q.to(torch.int32)
        p = gather[j, p].long()
    tmap[d] = p.to(torch.int32)
    return tmap


def chain_maps(plan: ChainPlan) -> torch.Tensor:
    """:func:`chain_maps_plain` of the plan's transitions: one launch, a thread a position."""
    if not plan.gather.is_cuda:
        return chain_maps_plain(plan.gather)
    build.require("chain_maps", (plan.gather, torch.int32))
    d, Mc = plan.gather.shape
    tmap = torch.empty((d + 1, Mc), dtype=torch.int32, device=plan.gather.device)
    build.check(build.library().sgp_chain_maps(plan.gather.data_ptr(), Mc, d, tmap.data_ptr(), build.stream()),
                "chain_maps")
    chain_maps.launches += 1
    return tmap


chain_maps.launches = 0


def chain_axes_transpose_plain(table, plan: ChainPlan, taps, tmap=None):
    """Plain K3'c transposed: B^T of the axis-0 table (Mc, c), the result in final order, as the kernel runs it.

    B = B_d P_{d-1} ... P_0 B_0 (B_j axis j's symmetric stencil, P_j its
    transition), so B^T = B_0 P_0^-1 ... P_{d-1}^-1 B_d: step j blurs axis
    d-j and moves the table into the next lower axis's order through
    ``tmap[j]`` (:func:`chain_maps_plain`).  Step 0 reads the axis-0 table in
    final order (through G = tmap[d]: the transposed slice's splat is the
    axis-0 splat permuted), and the last step, axis 0, writes in final order
    through G, so K3'd and K5 read the result as the forward's final table.
    Every element takes :func:`chain_axes_plain`'s operations in its order;
    only the live rows are computed, and rows past them keep ``table``'s.
    """
    d, order = plan.gather.shape[0], plan.tapw.shape[1]
    if tmap is None:
        tmap = chain_maps_plain(plan.gather)
    live = min(int(plan.n_lattice), table.shape[0])
    a, b = table.clone(), table.clone()
    for j in range(d + 1):
        t = a[tmap[d, :live].long()] if j == 0 else a[:live]
        acc = taps[order] * t
        for k in range(1, min(order, live - 1) + 1):
            w = plan.tapw[d - j, k - 1, :live - k, None]
            acc[:live - k] = acc[:live - k] + w * t[k:]
            acc[k:] = acc[k:] + w * t[:live - k]
        b[:live] = acc[tmap[j, :live].long()]
        a, b = b, a
    return a


def chain_axes_transpose(table: torch.Tensor, plan: ChainPlan, taps, tmap=None) -> torch.Tensor:
    """K3'c transposed: B^T of ``table`` (Mc, c, axis-0 order) in one launch, the final-order table out.

    The fused axes' kernel run backwards (csrc/chain.cu, chain_axes_kernel's
    kT): the d+1 steps in reverse axis order, a grid barrier between them,
    each step's gather the inverse of a transition, from ``tmap`` (the plan's
    :func:`chain_maps`, computed here when not given).  ``table`` is
    overwritten; rows past the live count are left undefined.
    """
    if not table.is_cuda:
        return chain_axes_transpose_plain(table, plan, taps, tmap)
    if tmap is None:
        tmap = chain_maps(plan)
    build.require("chain_axes_transpose", (table, torch.float32), (plan.tapw, torch.float32), (tmap, torch.int32),
                  (plan.n_lattice, torch.int32))
    (Mc, c), d, order = table.shape, plan.gather.shape[0], plan.tapw.shape[1]
    if (tuple(plan.tapw.shape) != (d + 1, order, Mc) or tuple(tmap.shape) != (d + 1, Mc)
            or len(taps) != 2 * order + 1):
        raise ValueError(f"chain_axes_transpose: taps {tuple(plan.tapw.shape)} / {len(taps)} and maps "
                         f"{tuple(tmap.shape)} do not fit a table of {Mc} rows and {d + 1} axes")
    other = torch.empty_like(table)
    barrier = torch.empty(1, dtype=torch.int32, device=table.device)
    build.check(build.library().sgp_chain_axes_transpose(
        table.data_ptr(), other.data_ptr(), plan.tapw.data_ptr(), tmap.data_ptr(), plan.n_lattice.data_ptr(), Mc,
        Mc, c, d, order, float(taps[order]), barrier.data_ptr(), build.stream()), "chain_axes_transpose")
    chain_axes_transpose.launches += 1
    return table if (d + 1) % 2 == 0 else other


chain_axes_transpose.launches = 0


def chain_slice_plain(table, slice_idx, weights, n_lattice, slice_norm, capacity=None):
    """Plain K3'd: the barycentric sum of each point's d+1 final-order rows, in vertex order as the
    kernel sums them, NaN past the capacity (:1093-1100): the plan's Mc, the table's rows unless
    ``capacity`` says it (a sharded apply's table holds the live rows only)."""
    out = table.new_zeros((slice_idx.shape[0], table.shape[1]))
    for v in range(slice_idx.shape[1]):
        out = out + table[slice_idx[:, v].long()] * weights[:, v:v + 1]
    rows = table.shape[0] if capacity is None else capacity
    return torch.where(n_lattice <= rows, out * slice_norm, float("nan"))


def slice_split(n: int, dp1: int, c: int, sms: int) -> tuple[int, int]:
    """(points, threads) of a K3'd block for n points of d+1 vertices and c columns on a card of ``sms`` SMs.

    points: a multiple of 4 (so every block's slab of slice_idx and weights
    starts on 16 bytes), at most SLICE_POINTS and at most what the two slabs'
    SLICE_SLAB_BYTES hold, and the fewest that spread n over at most
    SLICE_BLOCKS_PER_SM blocks an SM (elevators' 10,623 points: 44 a block,
    242 blocks); threads: the block's points * c elements rounded up to
    whole warps, at most SLICE_THREADS.  At most 96 points a block measured
    faster than 64, 128 or 256 at houseelectric c = 11 (``kernel_times.py
    --slice``; PERF.md section 6).  No output bit depends on it:
    each point sums its own vertices.
    """
    most = min(SLICE_POINTS, (SLICE_SLAB_BYTES // (8 * dp1)) // 4 * 4)
    if most < 4:
        raise ValueError(f"chain_slice: d+1 = {dp1} vertices do not fit a block's {SLICE_SLAB_BYTES}-byte slabs")
    points = min(most, 4 * max(1, -(-n // (4 * SLICE_BLOCKS_PER_SM * sms))))
    return points, min(SLICE_THREADS, 32 * -(-(points * c) // 32))


def _slice_args(plan: ChainPlan, c: int, device) -> tuple:
    """(points, threads) for :func:`slice_split` on ``device``."""
    n, dp1 = plan.slice_idx.shape
    return slice_split(n, dp1, c, torch.cuda.get_device_properties(device).multi_processor_count)


def chain_slice(table: torch.Tensor, plan: ChainPlan, slice_norm: float) -> torch.Tensor:
    """K3'd: ``slice_norm * S^T`` of the final-order table (Mc, c), all NaN when n_lattice > Mc.

    A block stages its points' rows of slice_idx and weights in shared
    memory, then sums each (point, column) over its vertices in order
    (:func:`chain_slice_plain`'s order, so the two agree bit for bit).
    """
    if not table.is_cuda:
        return chain_slice_plain(table, plan.slice_idx, plan.weights, plan.n_lattice, slice_norm)
    build.require("chain_slice", (table, torch.float32), (plan.slice_idx, torch.int32),
                  (plan.weights, torch.float32), (plan.n_lattice, torch.int32))
    Mc, c = table.shape
    n, dp1 = plan.slice_idx.shape
    out = torch.empty((n, c), dtype=torch.float32, device=table.device)
    lib = build.library()
    build.check(lib.sgp_chain_slice(table.data_ptr(), plan.slice_idx.data_ptr(), plan.weights.data_ptr(),
                                    plan.n_lattice.data_ptr(), n, dp1, c, Mc, *_slice_args(plan, c, table.device),
                                    float(slice_norm), out.data_ptr(), build.stream()), "chain_slice")
    chain_slice.launches += 1
    return out


chain_slice.launches = 0


def chain_apply_plain(plan: ChainPlan, v: torch.Tensor, taps, slice_norm: float, transpose: bool = False,
                      return_table: bool = False):
    """The plain versions of K3'b, the fused d+1 K3'c and K3'd in a row (apply_plan_chain, :943).

    With ``transpose`` the transposed apply S^T B^T S (JAX's vjp of
    apply_plan_chain in v): the axis-0 splat, the transposed axes
    (:func:`chain_axes_transpose_plain`, their table in final order), the
    slice.  With ``return_table`` also the final-order table the slice read
    (Mc, c): the forward's B S v, or the transpose's B^T S g permuted into
    final order, the two tables K5 reads.
    """
    table = chain_splat_plain(plan, v)
    table = chain_axes_transpose_plain(table, plan, taps) if transpose else chain_axes_plain(table, plan, taps)
    out = chain_slice_plain(table, plan.slice_idx, plan.weights, plan.n_lattice, slice_norm)
    return (out, table) if return_table else out


def chain_apply(plan: ChainPlan, v: torch.Tensor, taps, slice_norm: float, transpose: bool = False,
                return_table: bool = False):
    """``slice_norm * S^T B_d ... B_0 S v`` for v (n, c) through a sort-chain plan: K3'b, fused K3'c, K3'd.

    On the card the three or four launches (and the fused axes' memset) go
    out from one host call; each kernel's launches are counted on its own
    wrapper (the fused axes on ``chain_axes``).  All NaN when the plan's
    capacity overflowed.  With ``transpose`` the transposed apply
    ``slice_norm * S^T B^T S g``: the maps of the plan's transitions
    (``chain_maps``), the splat, the transposed axes (counted on
    ``chain_axes_transpose``) and the slice, from the same host call.  With
    ``return_table`` also the final-order table (Mc, c) the slice read (see
    :func:`chain_apply_plain`); rows past the live count are undefined.
    """
    if not v.is_cuda:
        return chain_apply_plain(plan, v, taps, slice_norm, transpose, return_table)
    d = plan.weights.shape[1] - 1
    _require_apply("chain_apply", plan, v)
    build.require("chain_apply", (plan.gather, torch.int32), (plan.tapw, torch.float32),
                  (plan.slice_idx, torch.int32), (plan.weights, torch.float32))
    (n, c), Mc, order = v.shape, plan.cnt.shape[0], plan.tapw.shape[1]
    if len(taps) != 2 * order + 1:
        raise ValueError(f"chain_apply: {len(taps)} taps do not fit a plan of order {order}")
    dev = v.device
    ta = torch.empty((Mc, c), dtype=torch.float32, device=dev)
    tb = torch.empty_like(ta)
    part = torch.empty((plan.piece_row.shape[0], c), dtype=torch.float32, device=dev)
    barrier = torch.empty(1, dtype=torch.int32, device=dev)
    tmap = torch.empty((d + 1, Mc), dtype=torch.int32, device=dev) if transpose else None
    out = torch.empty((n, c), dtype=torch.float32, device=dev)
    taps_host = (ctypes.c_float * len(taps))(*[float(t) for t in taps])
    build.check(build.library().sgp_chain_apply(
        *_splat_args(plan), v.data_ptr(), n, c, Mc, d, plan.gather.data_ptr(), plan.tapw.data_ptr(), order,
        ctypes.addressof(taps_host), plan.slice_idx.data_ptr(), plan.weights.data_ptr(),
        *_slice_args(plan, c, dev), float(slice_norm), ta.data_ptr(), tb.data_ptr(), part.data_ptr(),
        barrier.data_ptr(), None if tmap is None else tmap.data_ptr(), out.data_ptr(), build.stream()),
        "chain_apply")
    chain_splat.launches += 1
    if transpose:
        chain_maps.launches += 1
        chain_axes_transpose.launches += 1
    else:
        chain_axes.launches += 1
    chain_slice.launches += 1
    if return_table:
        return out, ta if (d + 1) % 2 == 0 else tb
    return out


def chain_unblock_plain(blocks: torch.Tensor, c: int) -> torch.Tensor:
    """Plain unblock: the (P, nl, cb) column blocks side by side as the (nl, c) table, the padding dropped."""
    P, nl, cb = blocks.shape
    return blocks.permute(1, 0, 2).reshape(nl, P * cb)[:, :c].contiguous()


def chain_unblock(blocks: torch.Tensor, c: int) -> torch.Tensor:
    """The sharded apply's gathered blocks (P, nl, cb) as the (nl, c) row-major final-order table that K3'd
    and K5 read: one launch, a thread an element (csrc/chain.cu, sgp_chain_unblock)."""
    if not blocks.is_cuda:
        return chain_unblock_plain(blocks, c)
    build.require("chain_unblock", (blocks, torch.float32))
    P, nl, cb = blocks.shape
    if not 0 < c <= P * cb:
        raise ValueError(f"chain_unblock: {c} columns do not fit {P} blocks of {cb}")
    table = torch.empty((nl, c), dtype=torch.float32, device=blocks.device)
    build.check(build.library().sgp_chain_unblock(blocks.data_ptr(), cb, nl, c, table.data_ptr(), build.stream()),
                "chain_unblock")
    chain_unblock.launches += 1
    return table


chain_unblock.launches = 0


def chain_apply_sharded_plain(plan: ChainPlan, v: torch.Tensor, taps, slice_norm: float, axis,
                              transpose: bool = False, return_table: bool = False):
    """Plain sharded chain apply (apply_plan_chain's axis branch, :1029-1061), collectives included.

    In the kernels' order, over the plan's n_lattice live rows: the
    row-order splat of this rank's contributions of each column block of v
    (padded with zero columns to c_pad = P cb) into a (P, n_lattice, cb)
    block buffer; the reduce-scatter over the blocks; the fused axes (or
    with ``transpose`` the transposed axes) of this rank's (n_lattice, cb)
    block; the all-gather of the blocks; the (n_lattice, c) final-order
    table; the slice of this rank's points, NaN past the plan's capacity.
    ``return_table`` also returns that table.
    """
    c = v.shape[1]
    P, cb = axis.size, -(-c // axis.size)
    nl = plan.cnt.shape[0]
    padded = torch.nn.functional.pad(v, (0, P * cb - c))
    blocks = chain_splat_plain(plan, padded).reshape(nl, P, cb).permute(1, 0, 2).contiguous()
    a = axis.psum_scatter(blocks)
    # Transposed: the maps over the live positions only, as the kernel lays them out.
    b = (chain_axes_transpose_plain(a, plan, taps, chain_maps_plain(plan.gather[:, :nl])) if transpose
         else chain_axes_plain(a, plan, taps))
    table = chain_unblock_plain(axis.all_gather_blocks(b), c)
    out = chain_slice_plain(table, plan.slice_idx, plan.weights, plan.n_lattice, slice_norm, plan.gather.shape[-1])
    return (out, table) if return_table else out


def chain_apply_sharded(plan: ChainPlan, v: torch.Tensor, taps, slice_norm: float, axis, transpose: bool = False,
                        return_table: bool = False):
    """``slice_norm * S^T B S v`` over a sharded chain plan, for this rank's rows v (n_loc, c).

    ``plan`` is this rank's part of a sharded plan (:func:`chain_build` with
    ``first``); ``axis`` the
    :class:`~simplex_gp_torch.parallel.comm.DataAxis`.  Three host calls
    around the axis's two collectives (csrc/chain.cu, the sharded apply):
    the splat of each column block into a (P, n_lattice, cb) buffer, the
    reduce-scatter, the fused axes on this rank's (n_lattice, cb) block,
    the all-gather, the blocks rejoined into the (n_lattice, c) final-order
    table (``chain_unblock``, P > 1) and the slice.  With ``transpose`` the
    transposed apply: the maps first, then the transposed axes.  Each kernel
    counts on its own wrapper.  No atomics: two calls give the same bits,
    :func:`chain_apply_sharded_plain`'s.  ``return_table`` also returns the
    final-order table, (n_lattice, c), for K5.  All NaN when the plan's
    capacity overflowed, which an untrimmed sharded plan never does.
    """
    if not v.is_cuda:
        return chain_apply_sharded_plain(plan, v, taps, slice_norm, axis, transpose, return_table)
    d = plan.weights.shape[1] - 1
    _require_apply("chain_apply_sharded", plan, v)
    build.require("chain_apply_sharded", (plan.gather, torch.int32), (plan.tapw, torch.float32),
                  (plan.slice_idx, torch.int32), (plan.weights, torch.float32))
    (n, c), nl, Mc, order = v.shape, plan.cnt.shape[0], plan.gather.shape[1], plan.tapw.shape[1]
    if len(taps) != 2 * order + 1 or nl > Mc or c < 1:
        raise ValueError(f"chain_apply_sharded: {len(taps)} taps and {c} columns do not fit a plan of order {order}, "
                         f"{nl} live rows of {Mc}")
    lib, st, dev = build.library(), build.stream(), v.device
    P, cb = axis.size, -(-c // axis.size)
    blocks = torch.empty((P, nl, cb), dtype=torch.float32, device=dev)
    part = torch.empty((plan.piece_row.shape[0], cb), dtype=torch.float32, device=dev)
    # The maps over the live positions only: past them every transition is the identity.
    tmap = torch.empty((d + 1, nl), dtype=torch.int32, device=dev) if transpose else None
    build.check(lib.sgp_chain_splat_blocks(*_splat_args(plan), v.data_ptr(), c, cb, P, nl, blocks.data_ptr(),
                                           part.data_ptr(), plan.gather.data_ptr(), Mc, d,
                                           None if tmap is None else tmap.data_ptr(), st),
                "chain_apply_sharded (splat)")
    chain_splat.launches += 1
    a = axis.psum_scatter(blocks)
    b = torch.empty_like(a)
    barrier = torch.empty(1, dtype=torch.int32, device=dev)
    if transpose:
        err = lib.sgp_chain_axes_transpose(a.data_ptr(), b.data_ptr(), plan.tapw.data_ptr(), tmap.data_ptr(),
                                           plan.n_lattice.data_ptr(), Mc, nl, cb, d, order, float(taps[order]),
                                           barrier.data_ptr(), st)
    else:
        err = lib.sgp_chain_axes(a.data_ptr(), b.data_ptr(), plan.tapw.data_ptr(), plan.gather.data_ptr(),
                                 plan.n_lattice.data_ptr(), Mc, cb, d, order, float(taps[order]), barrier.data_ptr(),
                                 st)
    build.check(err, "chain_apply_sharded (axes)")
    if transpose:
        chain_maps.launches += 1
        chain_axes_transpose.launches += 1
    else:
        chain_axes.launches += 1
    gathered = axis.all_gather_blocks(a if (d + 1) % 2 == 0 else b)
    table = gathered.view(nl, c) if P == 1 else chain_unblock(gathered, c)
    out = torch.empty((n, c), dtype=torch.float32, device=dev)
    build.check(lib.sgp_chain_slice(table.data_ptr(), plan.slice_idx.data_ptr(), plan.weights.data_ptr(),
                                    plan.n_lattice.data_ptr(), n, d + 1, c, Mc, *_slice_args(plan, c, dev),
                                    float(slice_norm), out.data_ptr(), st), "chain_apply_sharded (slice)")
    chain_slice.launches += 1
    return (out, table) if return_table else out
