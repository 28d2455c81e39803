"""K3', the sort-chain plan: wrappers over ``csrc/chain.cu``, beside their plain versions.

K3'a ``chain_build`` builds the plan from K1's hashes, coordinate sums and
weights; K3'b ``chain_splat``, K3'c and K3'd ``chain_slice`` apply it.
K3'c is ``chain_axes``, all d+1 lattice axes in one launch with a grid
barrier between them, or ``chain_axis``, one axis a launch (the tests' and
the A/B's).  :func:`chain_apply` launches the splat, the fused axes and the
slice from one host call, as the CG runs them.  Each wrapper takes its
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
import time
from typing import NamedTuple

import torch

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
    "chain_slice_plain",
    "chain_slice",
    "run_lists",
    "run_lists_device",
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


class ChainPlan(NamedTuple):
    """Sort-chain filter plan; N = n(d+1) contributions, Mc table rows, r = order.

      splat_points:  (N,) int32      point of each contribution, in table (axis-0) order
      splat_weights: (N,) f32        its barycentric weight
      cnt:           (Mc,) int32     end of each row's run of contributions (JAX's cnt)
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


def chain_build_plain(h1, h2, s, weights, consts, taps, capacity=None) -> ChainPlan:
    """Plain K3'a (_chain_core, :693-836, and build_plan_chain's slice index, :894).

    ``h1``, ``h2``, ``s`` (N,) int32 are K1's vertex hashes and coordinate
    sums, point-major; ``weights`` (n, d+1); ``consts`` (3, d+1) int32 the
    per-axis oh1, oh2 and mult; ``taps`` the 2r+1 filter taps.  The table
    has Mc = min(capacity, N) rows; past that the build drops points
    without an out-of-bounds write, and n_lattice, the true occupancy, trips
    the slice's guard.
    """
    dev = h1.device
    N = h1.shape[0]
    n, dp1 = weights.shape
    d = dp1 - 1
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
    cnt = torch.full((Mc,), N, dtype=torch.int32, device=dev)
    cnt[:live - 1] = u_pos[1:live].to(torch.int32)
    row_of = torch.empty(N, dtype=torch.int64, device=dev)
    row_of[perm] = (seg.long() - 1).clamp(max=Mc - 1)

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
    return ChainPlan((perm // dp1).to(torch.int32), flat_w[perm].contiguous(), cnt, *run_lists(cnt, live, N),
                     gather.contiguous(), tapw, slice_idx, weights, n_lattice)


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


def chain_build(h1, h2, s, weights, consts, taps, capacity=None) -> ChainPlan:
    """K3'a: the sort-chain plan from K1's hashes, coordinate sums and weights, on the card.

    The same plan as :func:`chain_build_plain`, bit for bit, by the stages
    of :func:`chain_build_staged`: six entry points of ``csrc/chain.cu``
    (dedup, rank, place, rows, finish, and the run lists') around three
    ``torch.sort`` calls (the distinct points by key, the N ranks, the live
    rows' axis keys batched); one host read (n_lattice, which sizes the
    sorts); one workspace and one output allocation; counted once per build.
    """
    if not h1.is_cuda:
        return chain_build_plain(h1, h2, s, weights, consts, taps, capacity)
    build.require("chain_build", (h1, torch.int32), (h2, torch.int32), (s, torch.int32),
                  (weights, torch.float32), (consts, torch.int32))
    dev = h1.device
    N = h1.shape[0]
    n, dp1 = weights.shape
    d = dp1 - 1
    order = (len(taps) - 1) // 2
    if N != n * dp1 or tuple(consts.shape) != (3, dp1) or len(taps) != 2 * order + 1 or order < 1:
        raise ValueError(f"chain_build: {N} vertices, consts {tuple(consts.shape)} and {len(taps)} taps do not "
                         f"fit {n} points of dimension {d}")
    Mc = _rows(N, capacity)
    slots = 1 << max(1, (2 * N - 1).bit_length())  # >= 2N: every distinct point fits
    if slots > 2**31:
        raise ValueError(f"chain_build: {N} contributions exceed the dedup table's index range")
    lib, st = build.library(), build.stream()
    i32, i64 = torch.int32, torch.int64
    ws = _carve(dev, dict(table=(i32, slots), rep_of=(i32, N), uniq_key=(i64, N), uniq_h2=(i32, N),
                          uniq_rep=(i32, N), row_key=(i64, Mc), row_h2=(i32, Mc), keys=(i64, dp1 * Mc),
                          pos=(i32, d * Mc), long_info=(i32, 3 * Mc)))
    sizes = dict(sp=N, sw=N, cnt=Mc, gather=d * Mc, tapw=dp1 * order * Mc, slice_idx=N, n_lattice=1)
    out = dict(zip(sizes, torch.empty(sum(sizes.values()), dtype=i32, device=dev).split(list(sizes.values()))))
    n_lattice = out["n_lattice"].view(())
    _mark("start")
    build.check(lib.sgp_chain_dedup(h1.data_ptr(), h2.data_ptr(), s.data_ptr(), N, consts.data_ptr(), dp1,
                                    ws["table"].data_ptr(), slots - 1, ws["rep_of"].data_ptr(),
                                    ws["uniq_key"].data_ptr(), ws["uniq_h2"].data_ptr(), ws["uniq_rep"].data_ptr(),
                                    n_lattice.data_ptr(), st), "chain_build (dedup)")
    _mark("dedup")
    nl = int(n_lattice)
    live = min(nl, Mc)
    _mark("read")
    sk, p = torch.sort(ws["uniq_key"][:nl])  # equal keys' order is fixed by h2 in the rank stage
    _mark("unique sort")
    # The table's slots are free now: the ranks by representative and by contribution take them; an int16
    # sort key (half torch.sort's radix passes) takes the unique keys' bytes.
    rank_by_rep, rank = ws["table"][:N], ws["table"][N:2 * N]
    key16 = ws["uniq_key"].view(torch.int16)[:N] if nl < 2**15 else None
    build.check(lib.sgp_chain_rank(sk.data_ptr(), p.data_ptr(), ws["uniq_h2"].data_ptr(),
                                   ws["uniq_rep"].data_ptr(), nl, Mc, ws["rep_of"].data_ptr(), N,
                                   rank_by_rep.data_ptr(), ws["row_key"].data_ptr(), ws["row_h2"].data_ptr(),
                                   rank.data_ptr(), None if key16 is None else key16.data_ptr(), st),
                "chain_build (rank)")
    _mark("rank")
    sorted_rank, perm = torch.sort(rank if key16 is None else key16, stable=True)
    _mark("rank sort")
    sw = out["sw"].view(torch.float32)
    build.check(lib.sgp_chain_place(perm.data_ptr(), weights.data_ptr(), N, dp1, out["sp"].data_ptr(), sw.data_ptr(),
                                    st), "chain_build (place)")
    del perm
    _mark("place")
    keys, long_info = ws["keys"][:dp1 * live].view(dp1, live), ws["long_info"].view(3, Mc)
    build.check(lib.sgp_chain_rows(ws["row_key"].data_ptr(), ws["row_h2"].data_ptr(), sorted_rank.data_ptr(),
                                   int(key16 is not None), live, N, Mc, d, consts.data_ptr(), out["cnt"].data_ptr(),
                                   keys.data_ptr(), long_info.data_ptr(), st), "chain_build (rows)")
    del sorted_rank
    _mark("rows")
    sorted_keys, order_j = torch.sort(keys[1:], dim=1, stable=True)
    _mark("axis sort")
    taps_host = (ctypes.c_float * len(taps))(*[float(t) for t in taps])
    tapw = out["tapw"].view(torch.float32).view(dp1, order, Mc)
    gather, slice_idx = out["gather"].view(d, Mc), out["slice_idx"].view(n, dp1)
    build.check(lib.sgp_chain_finish(keys.data_ptr(), sorted_keys.data_ptr(), order_j.data_ptr(), rank.data_ptr(),
                                     live, Mc, d, order, ctypes.addressof(taps_host), N, tapw.data_ptr(),
                                     ws["pos"].data_ptr(), gather.data_ptr(), slice_idx.data_ptr(), st),
                "chain_build (finish)")
    _mark("finish")
    lists = run_lists_device(long_info, out["cnt"], N)
    _mark("run lists")
    chain_build.launches += 1
    return ChainPlan(out["sp"], sw, out["cnt"], *lists, gather, tapw, slice_idx, weights, n_lattice)


def _mark(stage: str) -> None:
    """A CUDA event and the host clock after a stage of :func:`chain_build`, while
    :func:`chain_build_stage_times` listens."""
    if chain_build.stages is not None:
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        chain_build.stages.append((stage, event, time.perf_counter()))


def chain_build_stage_times(build_call) -> dict:
    """One ``build_call()`` (a :func:`chain_build` on the card) split by its stages: for each, the device ms
    between its CUDA event and the previous one, and the host ms between the two marks."""
    torch.cuda.synchronize()
    chain_build.stages = []
    try:
        build_call()
        torch.cuda.synchronize()
        marks = chain_build.stages
    finally:
        chain_build.stages = None
    return {name: dict(device_ms=prev.elapsed_time(ev), host_ms=1e3 * (t - t_prev))
            for (_, prev, t_prev), (name, ev, t) in zip(marks, marks[1:])}


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
chain_build.stages = None  # a list while chain_build_stage_times listens


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


def chain_slice_plain(table, slice_idx, weights, n_lattice, slice_norm):
    """Plain K3'd: the barycentric sum of each point's d+1 final-order rows, in vertex order as the
    kernel sums them, NaN past the capacity (:1093-1100)."""
    out = table.new_zeros((slice_idx.shape[0], table.shape[1]))
    for v in range(slice_idx.shape[1]):
        out = out + table[slice_idx[:, v].long()] * weights[:, v:v + 1]
    return torch.where(n_lattice <= table.shape[0], out * slice_norm, float("nan"))


def chain_slice(table: torch.Tensor, plan: ChainPlan, slice_norm: float) -> torch.Tensor:
    """K3'd: ``slice_norm * S^T`` of the final-order table (Mc, c), all NaN when n_lattice > Mc."""
    if not table.is_cuda:
        return chain_slice_plain(table, plan.slice_idx, plan.weights, plan.n_lattice, slice_norm)
    build.require("chain_slice", (table, torch.float32), (plan.slice_idx, torch.int32),
                  (plan.weights, torch.float32), (plan.n_lattice, torch.int32))
    Mc, c = table.shape
    n, dp1 = plan.slice_idx.shape
    out = torch.empty((n, c), dtype=torch.float32, device=table.device)
    lib = build.library()
    build.check(lib.sgp_chain_slice(table.data_ptr(), plan.slice_idx.data_ptr(), plan.weights.data_ptr(),
                                    plan.n_lattice.data_ptr(), n, dp1, c, Mc, float(slice_norm), out.data_ptr(),
                                    build.stream()), "chain_slice")
    chain_slice.launches += 1
    return out


chain_slice.launches = 0


def chain_apply_plain(plan: ChainPlan, v: torch.Tensor, taps, slice_norm: float) -> torch.Tensor:
    """The plain versions of K3'b, the fused d+1 K3'c and K3'd in a row (apply_plan_chain, :943)."""
    table = chain_axes_plain(chain_splat_plain(plan, v), plan, taps)
    return chain_slice_plain(table, plan.slice_idx, plan.weights, plan.n_lattice, slice_norm)


def chain_apply(plan: ChainPlan, v: torch.Tensor, taps, slice_norm: float) -> torch.Tensor:
    """``slice_norm * S^T B_d ... B_0 S v`` for v (n, c) through a sort-chain plan: K3'b, fused K3'c, K3'd.

    On the card the three or four launches (and the fused axes' memset) go
    out from one host call; each kernel's launches are counted on its own
    wrapper (the fused axes on ``chain_axes``).  All NaN when the plan's
    capacity overflowed.
    """
    if not v.is_cuda:
        return chain_apply_plain(plan, v, taps, slice_norm)
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
    out = torch.empty((n, c), dtype=torch.float32, device=dev)
    taps_host = (ctypes.c_float * len(taps))(*[float(t) for t in taps])
    build.check(build.library().sgp_chain_apply(
        *_splat_args(plan), v.data_ptr(), n, c, Mc, d, plan.gather.data_ptr(), plan.tapw.data_ptr(), order,
        ctypes.addressof(taps_host), plan.slice_idx.data_ptr(), plan.weights.data_ptr(), float(slice_norm),
        ta.data_ptr(), tb.data_ptr(), part.data_ptr(), barrier.data_ptr(), out.data_ptr(), build.stream()),
        "chain_apply")
    chain_splat.launches += 1
    chain_axes.launches += 1
    chain_slice.launches += 1
    return out
