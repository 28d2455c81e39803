"""The card's K2 and row build (csrc/dedup.cu, csrc/join_rows.cu) in plain PyTorch, stage by stage, for
the join plan's CPU tests (test_torch_join_plan_build.py); jax-free, not collected (no test_ prefix)."""

import torch

from simplex_gp_torch.kernels.chain import PIECE, SHORT, _long_bounds
from simplex_gp_torch.kernels.lattice import JoinRows, _neighbor_rows, _pack, _rows, rows_key_bits


def dedup_staged(h1, h2, oh1, oh2, capacity=None, seed=0):
    """K2's route (``csrc/dedup.cu``) in plain PyTorch: ``dedup_neighbors_plain``'s plan, rows numbered as
    the insert's race numbers them.

    Row r is the r-th point to win its slot, in an order that stands for
    the race (a seeded shuffle of the distinct points); each live row's
    neighbours are its neighbour keys' rows, looked up by key (hash
    linearity), M where absent; past the capacity every seg id is 0 and
    every neighbour M, and n_lattice counts every point.
    """
    N = h1.shape[0]
    M = _rows(N, capacity)
    dp1, r2 = oh1.shape
    dev = h1.device
    keys, inverse = torch.unique(_pack(h1, h2), sorted=True, return_inverse=True)
    nl = keys.shape[0]
    n_lattice = torch.tensor(nl, dtype=torch.int32, device=dev)
    neighbors = torch.full((dp1, M, r2), M, dtype=torch.int32, device=dev)
    if nl > M:
        return torch.zeros(N, dtype=torch.int32, device=dev), neighbors, n_lattice
    row_of_key = torch.randperm(nl, generator=torch.Generator().manual_seed(seed)).to(dev)
    key_of_row = torch.empty_like(keys)
    key_of_row[row_of_key] = keys
    pos, hit = _neighbor_rows(keys, key_of_row, oh1, oh2)
    neighbors[:, :nl, :] = torch.where(hit, row_of_key[pos.clamp(max=nl - 1)], M).to(torch.int32).permute(0, 2, 1)
    return row_of_key[inverse].to(torch.int32), neighbors, n_lattice


def rows_staged(seg_ids, weights, live, M: int, n_pts: int, n_lattice, sparse: bool = False) -> JoinRows:
    """The card's row build (``csrc/join_rows.cu``, ``sgp_rows_build``) in plain PyTorch, stage by stage.

    ``join_rows_device``'s arguments.  A stable sort of the seg ids'
    low ``rows_key_bits`` bits only; each contribution's point and
    weight, and the run ends where the sorted ids change
    (``join_runs_kernel``); every other run end and each row's class by
    ``join_rows_kernel``'s rules (a row no run ends in is left unset, -1,
    where the kernel would read garbage); the classes' three scans; the
    lists placed as ``sgp_run_lists_kernel`` places them.
    """
    dev = seg_ids.device
    dp1 = seg_ids.shape[-1]
    seg = seg_ids.reshape(-1).long()
    N, J = seg.shape[0], live.shape[0]
    Mt = J * M
    sorted_ids, perm = torch.sort(seg & ((1 << rows_key_bits(Mt)) - 1), stable=True)
    sp = (perm // dp1 % n_pts).to(torch.int32)
    sw = weights.reshape(-1)[perm].contiguous()
    ends = torch.ones(N, dtype=torch.bool, device=dev)
    ends[:-1] = sorted_ids[1:] != sorted_ids[:-1]
    runs = torch.full((Mt,), -1, dtype=torch.int64, device=dev)
    runs[sorted_ids[ends]] = torch.nonzero(ends).flatten() + 1
    g = torch.arange(Mt, device=dev)
    j = g // M
    lr = g - j * M
    nl = live.long()[j]
    over = nl > M
    unset = over | (lr >= nl)
    upper = torch.searchsorted(sorted_ids, g, right=True)
    upper_prev = torch.searchsorted(sorted_ids, g - 1, right=True)
    end = torch.where(~unset, upper if sparse else runs, torch.where(over | (j == J - 1), N, upper))
    cnt = torch.where(unset, end, end if sparse else runs)
    start = torch.where(g == 0, 0, torch.where(over, N, torch.where((lr == 0) | sparse, upper_prev,
                                                                   runs[(g - 1).clamp(min=0)])))
    length = torch.where(lr < torch.where(over, M, nl), end - start, 0)
    info = torch.stack([length > PIECE, torch.where(length > PIECE, -(-length // PIECE), 0),
                        (length > SHORT) & (length <= PIECE)]).long()
    scan = torch.cumsum(info, 1)
    nl_max, np_max, nm_max = _long_bounds(N, Mt)
    i32 = dict(dtype=torch.int32, device=dev)
    long_rows, long_first = torch.zeros(nl_max, **i32), torch.zeros(nl_max + 1, **i32)
    piece_row, piece_start = torch.zeros(np_max, **i32), torch.zeros(np_max, **i32)
    mid_rows = torch.zeros(nm_max, **i32)
    mids = torch.nonzero(info[2]).flatten()
    mid_rows[scan[2, mids] - 1] = mids.to(torch.int32)
    longs = torch.nonzero(info[0]).flatten()
    li, last, pieces = scan[0, longs] - 1, scan[1, longs], info[1, longs]
    long_rows[li] = longs.to(torch.int32)
    long_first[li + 1] = last.to(torch.int32)
    first = torch.repeat_interleave(last - pieces, pieces)
    k = torch.arange(first.shape[0], device=dev) - torch.repeat_interleave(torch.cumsum(pieces, 0) - pieces, pieces)
    row_start = torch.where(longs == 0, 0, cnt[(longs - 1).clamp(min=0)])
    piece_row[first + k] = torch.repeat_interleave(longs, pieces).to(torch.int32)
    piece_start[first + k] = (torch.repeat_interleave(row_start, pieces) + PIECE * k).to(torch.int32)
    total = scan[:, -1] if Mt else torch.zeros(3, dtype=torch.int64, device=dev)
    n_long, n_pieces, n_mid = (t.to(torch.int32) for t in total)
    return JoinRows(sp, sw, cnt.to(torch.int32), long_rows, long_first, piece_row, piece_start, n_long, n_pieces,
                    mid_rows, n_mid, n_lattice)


def plan_rows_staged(h1, h2, weights, oh1, oh2, capacity=None, seed=0):
    """``lattice_plan_rows`` by the card's route in plain PyTorch: :func:`dedup_staged`, then
    :func:`rows_staged` with one component; rows numbered by the race's ``seed``."""
    seg_ids, neighbors, n_lattice = dedup_staged(h1, h2, oh1, oh2, capacity, seed)
    seg_ids = seg_ids.reshape(weights.shape)
    return seg_ids, neighbors, n_lattice, rows_staged(seg_ids, weights, n_lattice.reshape(1), neighbors.shape[1],
                                                      weights.shape[0], n_lattice)
