"""The lattice filter's entry points and its autograd bridge (reference L2), join engine only.

Port of simplex_gp_tpu/ops/filter.py for a single DiscretizedKernel.  Every
width goes through the join engine (K1 + K2 build, K3 apply): its gathers
cost the same per column at any width, so the JAX package's width dispatch
(_WIDE_COLS, _JOIN_MAX_ROWS) and its chunked sort-chain branch have no
counterpart here.

:class:`LatticeFilterExactGrad` is the exact gradient of the operator
actually applied, as JAX gets it by autodiff in
``lattice_filter_exact_grad`` (:143), written out: the gradient in the
values is the transposed apply (K3 with the axis blurs reversed), and the
gradient in the positions is K5 (``lattice_filter_grad``), which reads the
forward's and the transposed apply's blurred tables.  The reference-parity
derivative-tap gradient (``lattice_filter``, K7) and mixtures are not ported.
"""

from __future__ import annotations

import torch

from ..kernels.lattice import lattice_filter_grad
from .kernels import DiscretizedKernel
from .lattice import SLICE_NORM, LatticePlan, apply_plan_join, build_plan_join, build_rotation

__all__ = [
    "build_plan_any",
    "apply_plan_any",
    "filter_backward",
    "LatticeFilterExactGrad",
    "lattice_filter_exact_grad",
    "lattice_filter_any",
    "lattice_filter_rect",
]


def build_plan_any(ref: torch.Tensor, dk: DiscretizedKernel) -> LatticePlan:
    """Reusable filter plan of ``dk`` at positions ``ref``; pair with :func:`apply_plan_any`."""
    return build_plan_join(ref, dk.coeffs, dk.variance)


def apply_plan_any(plan: LatticePlan, V: torch.Tensor, dk: DiscretizedKernel, transpose: bool = False,
                   return_table: bool = False):
    """K @ V (or K^T @ V) through a plan from :func:`build_plan_any` (no outputscale or noise)."""
    return apply_plan_join(plan, V, dk.coeffs, transpose, return_table)


def filter_backward(plan: LatticePlan, ref: torch.Tensor, dk: DiscretizedKernel, src: torch.Tensor,
                    g: torch.Tensor, table_f: torch.Tensor):
    """(grad_src, grad_ref) of ``<g, K(ref) @ src>``: transposed K3, then K5.

    ``table_f`` is the blurred table of the forward apply of ``src`` on
    ``plan`` (``apply_plan_any(..., return_table=True)``).
    """
    d = ref.shape[1]
    g = g.to(torch.float32).contiguous()
    grad_src, table_b = apply_plan_any(plan, g, dk, transpose=True, return_table=True)
    E = torch.from_numpy(build_rotation(d, dk.variance)).to(ref.device)
    grad_ref = lattice_filter_grad(ref.to(torch.float32).contiguous(), E, plan.seg_ids,
                                   src.to(torch.float32).contiguous(), g, table_f, table_b, SLICE_NORM(d))
    return grad_src, grad_ref


class LatticeFilterExactGrad(torch.autograd.Function):
    """K(ref, ref) @ src with its exact gradient in both src and ref.

    Forward: one plan build and one apply that keeps its blurred table.
    Backward: :func:`filter_backward` on the same plan, so the positions are
    not hashed twice.  Second derivatives are not defined (as in JAX's
    custom VJP filter).
    """

    @staticmethod
    def forward(ctx, src: torch.Tensor, ref: torch.Tensor, dk: DiscretizedKernel):
        plan = build_plan_any(ref, dk)
        out, table_f = apply_plan_any(plan, src, dk, return_table=True)
        ctx.dk = dk
        ctx.save_for_backward(src, ref, table_f, *plan)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        src, ref, table_f, *plan = ctx.saved_tensors
        grad_src, grad_ref = filter_backward(LatticePlan(*plan), ref, ctx.dk, src, g, table_f)
        return grad_src, grad_ref, None


def lattice_filter_exact_grad(src: torch.Tensor, ref: torch.Tensor, dk: DiscretizedKernel) -> torch.Tensor:
    """K(ref, ref) @ src, differentiable in src and ref by the exact operator gradient."""
    return LatticeFilterExactGrad.apply(src, ref, dk)


def lattice_filter_any(src: torch.Tensor, ref: torch.Tensor, dk: DiscretizedKernel) -> torch.Tensor:
    """K(ref, ref) @ src: one plan build and one apply, differentiable (exact gradients).

    In JAX this also takes a MixtureKernel; mixtures are not ported (ROADMAP item 10).
    """
    return lattice_filter_exact_grad(src, ref, dk)


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
