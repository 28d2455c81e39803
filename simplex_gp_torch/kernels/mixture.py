"""K12 lattice_mixture_apply: a wrapper over ``csrc/mixture.cu``, beside its plain version.

The Gaussian-mixture lattice operator ``SN * sum_j w_j S_j^T B_j S_j v``
over J component plans stacked into one table (see ``csrc/mixture.cu`` for
the layout).  The wrapper takes the plain PyTorch version for CPU tensors
and launches the kernel for CUDA tensors, raising on a failed build or
launch; there is no fallback.  It counts its launches in ``launches``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .lattice import _blur_axes, _blur_plain

__all__ = ["mixture_apply_plain", "lattice_mixture_apply"]

_MAX_MIX = 16  # SGP_MAX_MIX in csrc/mixture.cu


def _global_neighbors(neighbors: torch.Tensor, J: int) -> torch.Tensor:
    """The stacked (d+1, J M, 2r) neighbour ids with each component's rows offset by j M; missing -> J M."""
    JM = neighbors.shape[1]
    M = JM // J
    offset = (torch.arange(JM, device=neighbors.device) // M * M)[None, :, None]
    nb = neighbors.long()
    return torch.where(nb == M, JM, nb + offset)


def mixture_apply_plain(seg_ids, weights, neighbors, v, taps, slice_norm, mix_weights, transpose=False,
                        return_table=False):
    """Plain K12: the J components' splats into the stacked table, d+1 blurs, the weighted slice.

    ``seg_ids`` (J, n, d+1) are stacked rows (j M + local), ``weights`` the
    (J, n, d+1) barycentric weights, ``neighbors`` (d+1, J M, 2r) each
    component's local ids (M = missing), ``mix_weights`` J floats.  The
    output is sum_j w_j (SN S_j^T B_j S_j v), as JAX sums the component
    filters (filter.py:196-204); ``return_table`` also returns the stacked
    blurred (J M, c) table, unweighted.  Differentiable by torch autograd
    in ``v`` and ``weights``.
    """
    J, n, dp1 = seg_ids.shape
    JM = neighbors.shape[1]
    c = v.shape[-1]
    contrib = (v[None, :, None, :] * weights[..., None]).reshape(J * n * dp1, c)
    table = torch.zeros((JM, c), dtype=torch.float32, device=v.device).index_add_(
        0, seg_ids.reshape(-1).long(), contrib)
    table = _blur_plain(table, _global_neighbors(neighbors, J), taps, transpose)
    per_comp = (table[seg_ids.long()] * weights[..., None]).sum(dim=2) * slice_norm  # (J, n, c)
    out = sum(w * per_comp[j] for j, w in enumerate(mix_weights))
    return (out, table) if return_table else out


def lattice_mixture_apply(seg_ids, weights, neighbors, live, v, taps, slice_norm, mix_weights,
                          transpose=False, return_table=False):
    """K12: ``SN * sum_j w_j S_j^T B_j S_j v`` for v (n, c) over a stacked mixture plan.

    ``live`` (J,) int32 holds each component's occupied row count, read on
    the device; the other arguments are :func:`mixture_apply_plain`'s.
    ``transpose`` runs the axis blurs in reverse order; ``return_table``
    also returns the stacked blurred (J M, c) table, whose rows past a
    component's live count are undefined.  One splat, d+1 blurs and one
    slice: d+3 launches for all J components.
    """
    if not v.is_cuda:
        return mixture_apply_plain(seg_ids, weights, neighbors, v, taps, slice_norm, mix_weights, transpose,
                                   return_table)
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
    M = JM // J
    dev = v.device
    lib = build.library()
    taps_host = (ctypes.c_float * len(taps))(*[float(t) for t in taps])
    mix_host = (ctypes.c_float * J)(*[float(w) for w in mix_weights])
    a = torch.zeros((JM, c), dtype=torch.float32, device=dev)
    b = torch.empty((JM, c), dtype=torch.float32, device=dev)
    out = torch.empty((n, c), dtype=torch.float32, device=dev)
    st = build.stream()
    build.check(lib.sgp_mixture_splat(seg_ids.data_ptr(), weights.data_ptr(), v.data_ptr(), n, dp1, c, J,
                                      a.data_ptr(), st), "lattice_mixture_apply (splat)")
    for j in _blur_axes(dp1, transpose):
        build.check(lib.sgp_mixture_blur(a.data_ptr(), b.data_ptr(), neighbors[j].data_ptr(),
                                         ctypes.addressof(taps_host), M, J, c, order, live.data_ptr(), st),
                    "lattice_mixture_apply (blur)")
        a, b = b, a
    build.check(lib.sgp_mixture_slice(a.data_ptr(), seg_ids.data_ptr(), weights.data_ptr(), n, dp1, c, J,
                                      ctypes.addressof(mix_host), float(slice_norm), out.data_ptr(), st),
                "lattice_mixture_apply (slice)")
    lattice_mixture_apply.launches += 1
    return (out, a) if return_table else out


lattice_mixture_apply.launches = 0
