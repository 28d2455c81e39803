"""K6, the pivoted-Cholesky factor of the exact kernel matrix: wrappers over ``csrc/pivot.cu``.

``pivot_column`` is one step (one launch): column ``j`` of ``L`` written in
place, the updated residual diagonal returned as a new tensor, and, on
request, the argmax of that diagonal (the next pivot) written to a device
scalar by the same launch.  ``pivot_factor`` builds the whole rank-k factor
from one host call, L held column-major (a view of a contiguous (k, n)
tensor): k launches of the step, with no host read and no allocation per
pivot.  K6', the step of the sharded factor,
whose pivot row may live on another rank, is ``pivot_column`` given the
pivot's rows (``pivot_row``).  Each wrapper takes its plain PyTorch version
for CPU tensors and launches the kernel for CUDA tensors (raising on a
failed build or launch), and counts its launches in ``launches``.
"""

from __future__ import annotations

import math

import torch

from . import build

__all__ = ["stationary_value", "pivot_column_plain", "pivot_column", "column_major", "pivot_factor_plain",
           "pivot_factor"]


def stationary_value(d2: torch.Tensor, nu: float) -> torch.Tensor:
    """Exact kernel of squared distance: rbf (``nu == 0``) or Matern-nu.

    Port of simplex_gp_tpu/ops/kernels.py::kernel_value_jnp (:268).
    """
    if nu == 0.0:
        return torch.exp(-d2)
    d = torch.sqrt(torch.clamp(d2, min=1e-30))
    e = torch.exp(-math.sqrt(2.0 * nu) * d)
    if nu == 0.5:
        return e
    if nu == 1.5:
        return (1.0 + math.sqrt(3.0) * d) * e
    if nu == 2.5:
        return (1.0 + math.sqrt(5.0) * d + (5.0 / 3.0) * d2) * e
    raise ValueError(f"Matern nu={nu} not supported (use 0.5, 1.5, 2.5)")


def pivot_column_plain(ref, L, diag, piv, j, outputscale, d0_max, nu, pivots, pivot_row=None, next_piv=None):
    """Plain K6: the body of pivoted_cholesky_features (pivoted_cholesky.py:126-163).

    ``ref`` (n, dim) and ``L`` (n, k) in either layout (the factor holds
    both column-major, as views of (dim, n) and (k, n) tensors).  The
    squared distance and the dot with the pivot's row of L are torch's row
    sums, in another order than the kernel's sequential one.
    ``pivot_row`` is K6''s: ``(x_piv, l_piv, pivot_val)`` of shapes (dim,),
    (k,), (1,), the pivot's rows of ref and L and its residual diagonal, for
    a sharded factor (:129-162) whose pivot may live on another rank; then
    ``piv`` is the pivot's index in this rank's rows, or -1.  Without it they
    are row ``piv`` of ref, L and diag.  With ``next_piv`` (a 0-d int64
    tensor) the argmax of the new diagonal is written there, ties to the
    lowest index.  No value is read back to the host.
    """
    x_piv, l_piv, pivot_val = (ref[piv], L[piv], diag[piv]) if pivot_row is None else pivot_row
    # Row sums over row-major copies: torch's order for a row does not depend on the layout the factor
    # holds or on how many rows a rank holds, so a sharded factor equals the single-device one.
    col = outputscale * stationary_value(((ref.contiguous() - x_piv[None, :]) ** 2).sum(dim=-1), nu)
    mask = (torch.arange(L.shape[1], device=L.device) < j).to(L.dtype)
    col = col - (L.contiguous() * (l_piv * mask)[None, :]).sum(dim=-1)
    pivot_val = pivot_val.reshape(())
    alive = pivot_val > 1e-6 * d0_max
    root = torch.sqrt(torch.clamp(pivot_val, min=1e-12))
    at = torch.arange(ref.shape[0], device=ref.device) == piv
    ell = torch.where(alive, col / root, 0.0)
    ell = torch.where(at, torch.where(alive, root, 0.0), ell)
    L[:, j] = ell
    pivots[j] = piv
    new = torch.where(at, 0.0, torch.clamp(diag - ell * ell, min=0.0))
    if next_piv is not None:
        next_piv.copy_(torch.argmax(new))
    return new


def _dense_strides(what: str, t: torch.Tensor) -> tuple:
    """The (row, column) strides of a 2-D tensor stored row-major or column-major; raises otherwise."""
    if t.dim() != 2 or not (t.is_contiguous() or t.T.is_contiguous()):
        raise ValueError(f"{what}: expected a 2-D tensor stored row- or column-major, got shape "
                         f"{tuple(t.shape)} strides {t.stride()}")
    return t.stride()


def _check(what, ref, L, diag, pivots, nu, *scalars):
    n, dim = ref.shape
    k = L.shape[1]
    build.require(what, (diag, torch.float32), (pivots, torch.int64), *scalars)
    for t in (ref, L):
        if not t.is_cuda or t.dtype != torch.float32:
            raise ValueError(f"{what}: expected CUDA float32 ref and L, got {t.dtype} on {t.device}")
    if L.shape[0] != n or diag.shape != (n,) or pivots.shape != (k,):
        raise ValueError(f"{what}: L {tuple(L.shape)}, diag {tuple(diag.shape)}, pivots {tuple(pivots.shape)} "
                         f"do not fit ref {tuple(ref.shape)}")
    if nu not in (0.0, 0.5, 1.5, 2.5):
        raise ValueError(f"{what}: nu={nu} not supported (0 for rbf, or 0.5, 1.5, 2.5)")
    return (*_dense_strides(what, ref), *_dense_strides(what, L))


def _blocks(n: int) -> int:
    return (n + 255) // 256  # sgp_blocks: SGP_THREADS = 256


def pivot_column(ref, L, diag, piv, j, outputscale, d0_max, nu, pivots, pivot_row=None, next_piv=None):
    """K6: write column j of the pivoted Cholesky factor ``L`` (n, k) in place, one launch.

    ``ref`` (n, dim) and ``L`` row- or column-major (column-major reads
    coalesce).  ``piv`` is the pivot index as a 0-d int64 tensor,
    ``outputscale`` and ``d0_max`` are 0-d f32 tensors, ``nu`` is 0 for rbf
    or the Matern smoothness.  Records ``piv`` in ``pivots[j]`` and returns
    the updated diagonal; with ``next_piv`` (0-d int64) the kernel also
    writes the argmax of the new diagonal there (the fused reduction).  With
    ``pivot_row`` (f32 device tensors, as in :func:`pivot_column_plain`) it
    is K6', the step of a sharded factor, and also counts in
    ``sharded_launches``.
    """
    if not ref.is_cuda:
        return pivot_column_plain(ref, L, diag, piv, j, outputscale, d0_max, nu, pivots, pivot_row, next_piv)
    n, dim = ref.shape
    k = L.shape[1]
    strides = _check("pivot_column", ref, L, diag, pivots, nu, (piv, torch.int64), (outputscale, torch.float32),
                     (d0_max, torch.float32), *((t, torch.float32) for t in pivot_row or ()),
                     *(((next_piv, torch.int64),) if next_piv is not None else ()))
    if not 0 <= j < k:
        raise ValueError(f"pivot_column: j={j} outside a factor of rank {k}")
    if pivot_row is not None and tuple(t.numel() for t in pivot_row) != (dim, k, 1):
        raise ValueError(f"pivot_column: pivot rows of {[t.numel() for t in pivot_row]} entries, "
                         f"expected {[dim, k, 1]}")
    new_diag = torch.empty_like(diag)
    # The fused argmax's block entries and arrival ticket, only where it is asked for.
    part, ticket = (None, None) if next_piv is None else (
        torch.empty(2 * _blocks(n), dtype=torch.float32, device=ref.device),
        torch.zeros(1, dtype=torch.int32, device=ref.device))
    x_piv, l_piv, pv = (None, None, None) if pivot_row is None else (t.data_ptr() for t in pivot_row)
    rc = build.library().sgp_pivot_column(
        ref.data_ptr(), strides[0], strides[1], L.data_ptr(), strides[2], strides[3], diag.data_ptr(),
        new_diag.data_ptr(), x_piv, l_piv, pv, piv.data_ptr(), outputscale.data_ptr(), d0_max.data_ptr(),
        pivots.data_ptr(), *((None, None, None) if next_piv is None else
                             (next_piv.data_ptr(), part.data_ptr(), ticket.data_ptr())),
        n, dim, k, j, float(nu), build.stream())
    build.check(rc, "pivot_column")
    pivot_column.launches += 1
    if pivot_row is not None:
        pivot_column.sharded_launches += 1
    return new_diag


pivot_column.launches = 0
pivot_column.sharded_launches = 0


def column_major(t: torch.Tensor) -> torch.Tensor:
    """``t`` (n, m) as a view of a contiguous (m, n) tensor: the layout the factor reads coalesced."""
    return t if t.T.is_contiguous() else t.T.contiguous().T


def pivot_factor_plain(ref, diag, outputscale, nu, rank: int):
    """The plain factor: the loop of :func:`pivot_column_plain`, each pivot the argmax of the diagonal.

    Returns ``(L, pivots)``: L (n, rank) column-major (a view of a
    contiguous (rank, n) tensor), pivots (rank,) int64.
    """
    n = ref.shape[0]
    L = torch.zeros((rank, n), dtype=torch.float32, device=ref.device).T
    pivots = torch.zeros(rank, dtype=torch.int64, device=ref.device)
    d = diag.to(torch.float32)
    d0_max = d.max()
    for j in range(rank):
        d = pivot_column_plain(ref, L, d, torch.argmax(d), j, outputscale, d0_max, nu, pivots)
    return L, pivots


def pivot_factor(ref, diag, outputscale, nu, rank: int):
    """K6, the whole rank-``rank`` factor from one host call: ``(L, pivots)`` as :func:`pivot_factor_plain`.

    On the card every step runs the one-step kernel with the argmax fused,
    and nothing is read back or allocated per pivot: ``rank`` launches of
    :func:`pivot_column`'s kernel, counted there.
    """
    if not ref.is_cuda:
        return pivot_factor_plain(ref, diag, outputscale, nu, rank)
    n, dim = ref.shape
    ref = column_major(ref.to(torch.float32))
    L = torch.zeros((rank, n), dtype=torch.float32, device=ref.device).T
    pivots = torch.zeros(rank, dtype=torch.int64, device=ref.device)
    d = diag.to(torch.float32).contiguous()
    s = outputscale.to(torch.float32).reshape(()).contiguous()
    strides = _check("pivot_factor", ref, L, d, pivots, nu, (s, torch.float32))
    d0_max = d.max()
    piv = torch.empty(2, dtype=torch.int64, device=ref.device)
    piv[0] = torch.argmax(d)
    d = d.clone()  # the factor overwrites its two diagonal buffers
    scratch = torch.empty_like(d)
    part = torch.empty(2 * _blocks(n), dtype=torch.float32, device=ref.device)
    ticket = torch.zeros(1, dtype=torch.int32, device=ref.device)  # the fused argmax's arrivals
    rc = build.library().sgp_pivot_factor(
        ref.data_ptr(), strides[0], strides[1], L.data_ptr(), strides[2], strides[3], d.data_ptr(),
        scratch.data_ptr(), piv.data_ptr(), s.data_ptr(), d0_max.data_ptr(), pivots.data_ptr(), part.data_ptr(),
        ticket.data_ptr(), n, dim, rank, float(nu), build.stream())
    build.check(rc, "pivot_factor")
    pivot_column.launches += rank
    return L, pivots
