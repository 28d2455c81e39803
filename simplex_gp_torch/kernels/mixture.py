"""K12 lattice_mixture_apply: a wrapper over ``csrc/mixture.cu``, beside its plain version.

The Gaussian-mixture lattice operator ``SN * sum_j w_j S_j^T B_j S_j v``
over J component plans stacked into one table (see ``csrc/mixture.cu`` for
the layout), on the stacked plan's row lists (:func:`mixture_rows`, built
once per plan): K3'b's row-order splat, the live-row blur of each
component, the weighted slice; no atomics, so two applies give the same
bits, those of :func:`mixture_apply_plain`.  The wrapper takes the plain
version for CPU tensors and launches the kernels for CUDA tensors, raising
on a failed build or launch; there is no fallback.  It counts its launches
in ``launches``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .chain import chain_splat_plain
from .lattice import (JoinRows, _blur_plain, _require_rows, _rows_args, _slice_sums, join_rows_device,
                      join_rows_plain)

__all__ = ["mixture_rows_plain", "mixture_rows", "mixture_apply_plain", "lattice_mixture_apply"]

_MAX_MIX = 16  # SGP_MAX_MIX in csrc/rows.cuh
# Columns of v the plain splat sums at a time: its lane sums hold (rows, 32, columns) floats.  Columns do not
# interact, so the width does not change the sums.
_PLAIN_SPLAT_COLS = 16


def _global_neighbors(neighbors: torch.Tensor, J: int) -> torch.Tensor:
    """The stacked (d+1, J M, 2r) neighbour ids with each component's rows offset by j M; missing -> J M."""
    JM = neighbors.shape[1]
    M = JM // J
    offset = (torch.arange(JM, device=neighbors.device) // M * M)[None, :, None]
    nb = neighbors.long()
    return torch.where(nb == M, JM, nb + offset)


def mixture_rows_plain(seg_ids, weights, neighbors) -> JoinRows:
    """Plain row lists of a stacked mixture plan: :func:`~simplex_gp_torch.kernels.lattice.join_rows_plain` over
    the J n stacked points and all J M rows, each contribution's point reduced mod n."""
    J, n, dp1 = seg_ids.shape
    JM = neighbors.shape[1]
    count = torch.tensor(JM, dtype=torch.int32, device=seg_ids.device)
    return join_rows_plain(seg_ids.reshape(J * n, dp1), weights.reshape(J * n, dp1), neighbors, count, n_pts=n)


def mixture_rows(seg_ids, weights, neighbors, live) -> JoinRows:
    """K12's row lists of a stacked plan (``seg_ids``, ``weights`` (J, n, d+1), ``neighbors``, ``live`` (J,)).

    Every stacked row's run of contributions in contribution order, from one
    stable sort of the stacked seg ids (``join_rows_device``: J components
    of M rows, the live counts read on the device); the splat visits all J
    M rows, so the lists' count is J M.  The same lists as
    :func:`mixture_rows_plain`, bit for bit.  Counted in ``join_rows.launches``.
    """
    if not seg_ids.is_cuda:
        return mixture_rows_plain(seg_ids, weights, neighbors)
    J, n, _ = seg_ids.shape
    JM = neighbors.shape[1]
    if live.shape != (J,) or JM % J:
        raise ValueError(f"mixture_rows: live {tuple(live.shape)} and {JM} rows do not fit {J} components")
    count = torch.full((), JM, dtype=torch.int32, device=seg_ids.device)
    return join_rows_device(seg_ids, weights, live, JM // J, n, count)


def mixture_apply_plain(seg_ids, weights, neighbors, v, taps, slice_norm, mix_weights, transpose=False,
                        return_table=False, rows=None):
    """Plain K12 in the kernels' order: the row-order splat, d+1 blurs, the weighted slice.

    ``seg_ids`` (J, n, d+1) are stacked rows (j M + local), ``weights`` the
    (J, n, d+1) barycentric weights, ``neighbors`` (d+1, J M, 2r) each
    component's local ids (M = missing), ``mix_weights`` J floats, ``rows``
    the plan's :func:`mixture_rows` (built when None).  The splat sums each
    stacked row's run as K3'b does (:func:`~simplex_gp_torch.kernels.chain.chain_splat_plain`:
    short runs folded, warp runs, pieces of 1,024); the slice sums each
    component's d+1 rows in vertex order and the weighted components in
    component order, then scales by ``slice_norm``.  The output is
    sum_j w_j (SN S_j^T B_j S_j v), as JAX sums the component filters
    (filter.py:196-204); ``return_table`` also returns the stacked blurred
    (J M, c) table, unweighted.  Differentiable by torch autograd in ``v``.
    """
    J, n, dp1 = seg_ids.shape
    c = v.shape[-1]
    rows = mixture_rows_plain(seg_ids, weights, neighbors) if rows is None else rows
    table = torch.cat([chain_splat_plain(rows, v[:, c0:c0 + _PLAIN_SPLAT_COLS])
                       for c0 in range(0, c, _PLAIN_SPLAT_COLS)], dim=1)
    table = _blur_plain(table, _global_neighbors(neighbors, J), taps, transpose)
    out = v.new_zeros((n, c))
    for j, w in enumerate(mix_weights):
        out = out + float(w) * _slice_sums(table, seg_ids[j], weights[j])
    out = out * slice_norm
    return (out, table) if return_table else out


def lattice_mixture_apply(seg_ids, weights, neighbors, live, v, taps, slice_norm, mix_weights,
                          transpose=False, return_table=False, rows=None):
    """K12: ``SN * sum_j w_j S_j^T B_j S_j v`` for v (n, c) over a stacked mixture plan.

    ``live`` (J,) int32 holds each component's occupied row count, read on
    the device; ``rows`` the plan's :func:`mixture_rows` (built here when
    None; a caller that applies one plan more than once builds them once);
    the other arguments are :func:`mixture_apply_plain`'s.  ``transpose``
    runs the axis blurs in reverse order; ``return_table`` also returns the
    stacked blurred (J M, c) table, whose rows past a component's live
    count are undefined.  From one host call: the splat (one launch, a
    second for the rows of more than 1,024 contributions), d+1 blurs and
    one slice for all J components, with no memset.
    """
    if not v.is_cuda:
        return mixture_apply_plain(seg_ids, weights, neighbors, v, taps, slice_norm, mix_weights, transpose,
                                   return_table, rows)
    build.require("lattice_mixture_apply", (seg_ids, torch.int32), (weights, torch.float32),
                  (neighbors, torch.int32), (live, torch.int32), (v, torch.float32))
    J, n, dp1 = seg_ids.shape
    JM = neighbors.shape[1]
    order = neighbors.shape[2] // 2
    c = v.shape[-1]
    if (weights.shape != seg_ids.shape or v.shape[0] != n or len(taps) != 2 * order + 1
            or len(mix_weights) != J or live.shape != (J,) or JM % J or neighbors.shape[0] != dp1):
        raise ValueError(f"lattice_mixture_apply: v {tuple(v.shape)}, {len(taps)} taps, {len(mix_weights)} "
                         f"weights, live {tuple(live.shape)} do not fit a plan of seg {tuple(seg_ids.shape)} "
                         f"and neighbours {tuple(neighbors.shape)}")
    if J > _MAX_MIX:
        raise ValueError(f"lattice_mixture_apply: {J} components exceed the kernel's limit of {_MAX_MIX}")
    rows = mixture_rows(seg_ids, weights, neighbors, live) if rows is None else rows
    _require_rows("lattice_mixture_apply", rows, J * n * dp1, JM)
    dev = v.device
    taps_host = (ctypes.c_float * len(taps))(*[float(t) for t in taps])
    mix_host = (ctypes.c_float * J)(*[float(w) for w in mix_weights])
    ta = torch.empty((JM, c), dtype=torch.float32, device=dev)
    tb = torch.empty((JM, c), dtype=torch.float32, device=dev)
    part = torch.empty((rows.piece_row.shape[0], c), dtype=torch.float32, device=dev)
    out = torch.empty((n, c), dtype=torch.float32, device=dev)
    rc = build.library().sgp_mixture_apply(
        *_rows_args(rows), seg_ids.data_ptr(), weights.data_ptr(), neighbors.data_ptr(), live.data_ptr(),
        v.data_ptr(), n, dp1, c, J, JM // J, ctypes.addressof(taps_host), order, ctypes.addressof(mix_host),
        float(slice_norm), ta.data_ptr(), tb.data_ptr(), part.data_ptr(), out.data_ptr(), int(transpose),
        build.stream())
    build.check(rc, "lattice_mixture_apply")
    lattice_mixture_apply.launches += 1
    if return_table:
        return out, (ta if dp1 % 2 == 0 else tb)
    return out


lattice_mixture_apply.launches = 0
