"""K6 pivot_column: one pivoted-Cholesky step, a wrapper over ``csrc/pivot.cu``.

The wrapper takes the plain PyTorch version for CPU tensors and launches the
kernel for CUDA tensors (raising on a failed build or launch).  It counts its
launches in ``launches``.  Both versions write column ``j`` of ``L`` in place
and return the updated residual diagonal as a new tensor.  K6', the step of
the sharded factor, whose pivot row may live on another rank, is the same
kernel given the pivot's rows (``pivot_row``).
"""

from __future__ import annotations

import math

import torch

from . import build

__all__ = ["stationary_value", "pivot_column_plain", "pivot_column"]


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


def pivot_column_plain(ref, L, diag, piv, j, outputscale, d0_max, nu, pivots, pivot_row=None):
    """Plain K6: the body of pivoted_cholesky_features (pivoted_cholesky.py:126-163).

    ``pivot_row`` is K6's: ``(x_piv, l_piv, pivot_val)`` of shapes (dim,),
    (k,), (1,), the pivot's rows of ref and L and its residual diagonal, for
    a sharded factor (:129-162) whose pivot may live on another rank; then
    ``piv`` is the pivot's index in this rank's rows, or -1.  Without it they
    are row ``piv`` of ref, L and diag.  No value is read back to the host.
    """
    x_piv, l_piv, pivot_val = (ref[piv], L[piv], diag[piv]) if pivot_row is None else pivot_row
    col = outputscale * stationary_value(((ref - x_piv[None, :]) ** 2).sum(dim=-1), nu)
    mask = (torch.arange(L.shape[1], device=L.device) < j).to(L.dtype)
    col = col - (L * (l_piv * mask)[None, :]).sum(dim=-1)
    pivot_val = pivot_val.reshape(())
    alive = pivot_val > 1e-6 * d0_max
    root = torch.sqrt(torch.clamp(pivot_val, min=1e-12))
    at = torch.arange(ref.shape[0], device=ref.device) == piv
    ell = torch.where(alive, col / root, 0.0)
    ell = torch.where(at, torch.where(alive, root, 0.0), ell)
    L[:, j] = ell
    pivots[j] = piv
    return torch.where(at, 0.0, torch.clamp(diag - ell * ell, min=0.0))


def pivot_column(ref, L, diag, piv, j, outputscale, d0_max, nu, pivots, pivot_row=None):
    """K6: write column j of the pivoted Cholesky factor ``L`` (n, k) in place.

    ``piv`` is the pivot index as a 0-d int64 tensor (``torch.argmax`` of
    ``diag``), ``outputscale`` and ``d0_max`` are 0-d f32 tensors, ``nu`` is
    0 for rbf or the Matern smoothness.  Records ``piv`` in ``pivots[j]`` and
    returns the updated diagonal.  With ``pivot_row`` (f32 device tensors,
    as in :func:`pivot_column_plain`) it is K6', the step of a sharded
    factor, and also counts in ``sharded_launches``.
    """
    if not ref.is_cuda:
        return pivot_column_plain(ref, L, diag, piv, j, outputscale, d0_max, nu, pivots, pivot_row)
    n, dim = ref.shape
    k = L.shape[1]
    build.require("pivot_column", (ref, torch.float32), (L, torch.float32), (diag, torch.float32),
                  (piv, torch.int64), (outputscale, torch.float32), (d0_max, torch.float32),
                  (pivots, torch.int64), *((t, torch.float32) for t in pivot_row or ()))
    if L.shape[0] != n or diag.shape != (n,) or not 0 <= j < k:
        raise ValueError(f"pivot_column: L {tuple(L.shape)}, diag {tuple(diag.shape)}, j={j} "
                         f"do not fit ref {tuple(ref.shape)}")
    if pivot_row is not None and tuple(t.numel() for t in pivot_row) != (dim, k, 1):
        raise ValueError(f"pivot_column: pivot rows of {[t.numel() for t in pivot_row]} entries, "
                         f"expected {[dim, k, 1]}")
    if nu not in (0.0, 0.5, 1.5, 2.5):
        raise ValueError(f"pivot_column: nu={nu} not supported (0 for rbf, or 0.5, 1.5, 2.5)")
    lib = build.library()
    new_diag = torch.empty_like(diag)
    x_piv, l_piv, pv = (None, None, None) if pivot_row is None else (t.data_ptr() for t in pivot_row)
    rc = lib.sgp_pivot_column(ref.data_ptr(), L.data_ptr(), diag.data_ptr(), new_diag.data_ptr(),
                              x_piv, l_piv, pv, piv.data_ptr(), outputscale.data_ptr(), d0_max.data_ptr(),
                              pivots.data_ptr(), n, dim, k, j, float(nu), build.stream())
    build.check(rc, "pivot_column")
    pivot_column.launches += 1
    if pivot_row is not None:
        pivot_column.sharded_launches += 1
    return new_diag


pivot_column.launches = 0
pivot_column.sharded_launches = 0
