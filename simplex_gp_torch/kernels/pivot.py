"""K6 pivot_column: one pivoted-Cholesky step, wrapper over ``csrc/pivot.cu``.

The wrapper takes the plain PyTorch version for CPU tensors and launches the
kernel for CUDA tensors (raising on a failed build or launch).  It counts its
launches in ``pivot_column.launches``.  Both versions write column ``j`` of
``L`` in place and return the updated residual diagonal as a new tensor.
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


def pivot_column_plain(ref, L, diag, piv, j, outputscale, d0_max, nu, pivots):
    """Plain K6: the body of pivoted_cholesky_features (pivoted_cholesky.py:126-163)."""
    x_piv = ref[piv]
    l_piv = L[piv]
    pivot_val = diag[piv]
    col = outputscale * stationary_value(((ref - x_piv[None, :]) ** 2).sum(dim=-1), nu)
    mask = (torch.arange(L.shape[1], device=L.device) < j).to(L.dtype)
    col = col - (L * (l_piv * mask)[None, :]).sum(dim=-1)
    alive = pivot_val > 1e-6 * d0_max
    pivot_val = torch.clamp(pivot_val, min=1e-12)
    ell = torch.where(alive, col / torch.sqrt(pivot_val), 0.0)
    ell[piv] = torch.where(alive, torch.sqrt(pivot_val), 0.0)
    L[:, j] = ell
    new_diag = torch.clamp(diag - ell * ell, min=0.0)
    new_diag[piv] = 0.0
    pivots[j] = piv
    return new_diag


def pivot_column(ref, L, diag, piv, j, outputscale, d0_max, nu, pivots):
    """K6: write column j of the pivoted Cholesky factor ``L`` (n, k) in place.

    ``piv`` is the pivot index as a 0-d int64 tensor (``torch.argmax`` of
    ``diag``), ``outputscale`` and ``d0_max`` are 0-d f32 tensors, ``nu`` is
    0 for rbf or the Matern smoothness.  Records ``piv`` in ``pivots[j]`` and
    returns the updated diagonal.
    """
    if not ref.is_cuda:
        return pivot_column_plain(ref, L, diag, piv, j, outputscale, d0_max, nu, pivots)
    n, dim = ref.shape
    k = L.shape[1]
    build.require("pivot_column", (ref, torch.float32), (L, torch.float32), (diag, torch.float32),
                  (piv, torch.int64), (outputscale, torch.float32), (d0_max, torch.float32),
                  (pivots, torch.int64))
    if L.shape[0] != n or diag.shape != (n,) or not 0 <= j < k:
        raise ValueError(f"pivot_column: L {tuple(L.shape)}, diag {tuple(diag.shape)}, j={j} "
                         f"do not fit ref {tuple(ref.shape)}")
    if nu not in (0.0, 0.5, 1.5, 2.5):
        raise ValueError(f"pivot_column: nu={nu} not supported (0 for rbf, or 0.5, 1.5, 2.5)")
    lib = build.library()
    new_diag = torch.empty_like(diag)
    rc = lib.sgp_pivot_column(ref.data_ptr(), L.data_ptr(), diag.data_ptr(), new_diag.data_ptr(),
                              piv.data_ptr(), outputscale.data_ptr(), d0_max.data_ptr(),
                              pivots.data_ptr(), n, dim, k, j, float(nu), build.stream())
    build.check(rc, "pivot_column")
    pivot_column.launches += 1
    return new_diag


pivot_column.launches = 0
