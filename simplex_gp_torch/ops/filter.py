"""The lattice filter's forward entry points (reference L2), join engine only.

Port of the forward half of simplex_gp_tpu/ops/filter.py for a single
DiscretizedKernel.  Every width goes through the join engine (K1 + K2 build,
K3 apply): its gathers cost the same per column at any width, so the JAX
package's width dispatch (_WIDE_COLS, _JOIN_MAX_ROWS) and its chunked
sort-chain branch have no counterpart here.  Gradients (the filter's VJP)
belong to the training path and are not ported yet.
"""

from __future__ import annotations

import torch

from .kernels import DiscretizedKernel
from .lattice import LatticePlan, apply_plan_join, build_plan_join

__all__ = ["build_plan_any", "apply_plan_any", "lattice_filter_any", "lattice_filter_rect"]


def build_plan_any(ref: torch.Tensor, dk: DiscretizedKernel) -> LatticePlan:
    """Reusable filter plan of ``dk`` at positions ``ref``; pair with :func:`apply_plan_any`."""
    return build_plan_join(ref, dk.coeffs, dk.variance)


def apply_plan_any(plan: LatticePlan, V: torch.Tensor, dk: DiscretizedKernel) -> torch.Tensor:
    """K @ V through a plan from :func:`build_plan_any` (no outputscale or noise)."""
    return apply_plan_join(plan, V, dk.coeffs)


def lattice_filter_any(src: torch.Tensor, ref: torch.Tensor, dk: DiscretizedKernel) -> torch.Tensor:
    """K(ref, ref) @ src: one plan build and one apply."""
    return apply_plan_any(build_plan_any(ref, dk), src, dk)


def lattice_filter_rect(src: torch.Tensor, x_from: torch.Tensor, x_to: torch.Tensor,
                        dk: DiscretizedKernel) -> torch.Tensor:
    """Cross-covariance MVM ``K(x_to, x_from) @ src`` via the zero-pad trick.

    Joint-filters ``[src; 0]`` over the concatenated positions
    ``[x_from; x_to]`` and keeps the x_to rows (the reference's
    RectangularLazyLattice._matmul, bilateral_kernel.py:150-156).
    """
    n_from = x_from.shape[0]
    x_large = torch.cat([x_from, x_to], dim=0)
    v_large = torch.cat([src, src.new_zeros((x_to.shape[0], src.shape[-1]))], dim=0)
    return lattice_filter_any(v_large, x_large, dk)[n_from:]
