"""The lattice filter's entry points and its autograd bridges (reference L2).

Port of simplex_gp_tpu/ops/filter.py for a single DiscretizedKernel.
:func:`_filter_plain` keeps JAX's width dispatch (:120-140): values of up to
``_WIDE_COLS`` = 16 columns go to the one-shot filter K4
(``filter_once``), wider ones to the join plan (K1 + K2 build, K3 apply).
JAX's third branch, the chunked sort-chain filter for wide values above
4M contribution rows (K9), is not ported (ROADMAP).

Two gradients of ``K(ref, ref) @ src``:
  * :class:`LatticeFilterExactGrad` is the exact gradient of the operator
    actually applied, as JAX gets it by autodiff in
    ``lattice_filter_exact_grad`` (:143), written out: the gradient in the
    values is the transposed apply (K3 with the axis blurs reversed), and
    the gradient in the positions is K5 (``lattice_filter_grad``), which
    reads the forward's and the transposed apply's blurred tables.
  * :class:`LatticeFilter` (``lattice_filter``, :241-294) is the
    reference-parity gradient: grad_src is one more forward filter of the
    cotangent, and grad_ref is K7 (``lattice_deriv_grad``), one
    derivative-tap filter of [g, g*ref, src, src*ref] on a second plan,
    combined with the constant 2 k'(0) (JAX's fix of the reference's -2).
Mixtures are not ported (ROADMAP item 10).
"""

from __future__ import annotations

import torch

from ..kernels.lattice import lattice_deriv_grad, lattice_filter_grad
from .kernels import DiscretizedKernel
from .lattice import SLICE_NORM, LatticePlan, apply_plan_join, build_plan_join, build_rotation, filter_once

# Widest value block for the one-shot filter; wider blocks take the join plan
# (filter.py:54, :133).
_WIDE_COLS = 16

__all__ = [
    "build_plan_any",
    "apply_plan_any",
    "filter_backward",
    "LatticeFilterExactGrad",
    "lattice_filter_exact_grad",
    "lattice_filter_any",
    "lattice_filter_rect",
    "deriv_filter_grad",
    "LatticeFilter",
    "lattice_filter",
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


def _filter_plain(src: torch.Tensor, ref: torch.Tensor, dk: DiscretizedKernel) -> torch.Tensor:
    """K(ref, ref) @ src, engine chosen by width (filter.py:120-140): K4 up to 16 columns, else join."""
    if src.shape[-1] > _WIDE_COLS:
        return apply_plan_join(build_plan_join(ref, dk.coeffs, dk.variance), src, dk.coeffs)
    return filter_once(src, ref, dk.coeffs, dk.variance)


def deriv_filter_grad(ref: torch.Tensor, dk: DiscretizedKernel, src: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The reference-parity gradient of ``<g, K(ref) @ src>`` in ref (n, d) (filter.py:269-290).

    Builds the derivative plan (K1 + K2 with ``dk.deriv_coeffs`` and
    ``dk.deriv_variance``) and runs K7 with the constant 2 k'(0).
    """
    ref = ref.to(torch.float32).contiguous()
    plan = build_plan_join(ref, dk.deriv_coeffs, dk.deriv_variance)
    return lattice_deriv_grad(plan.seg_ids, plan.weights, plan.neighbors, plan.n_lattice, ref,
                              src.to(torch.float32).contiguous(), g.to(torch.float32).contiguous(),
                              [float(c) for c in dk.deriv_coeffs], SLICE_NORM(ref.shape[1]),
                              2.0 * dk.dk0)


class LatticeFilter(torch.autograd.Function):
    """K(ref, ref) @ src with the reference's gradients (filter.py:241-294).

    Forward: :func:`_filter_plain`.  Backward, each half only when asked for:
    grad_src = K g, one more forward filter with the forward taps (JAX's fix
    2: the reference reuses the derivative filter, exact only for RBF), and
    grad_ref from :func:`deriv_filter_grad`.  Second derivatives are not
    defined.
    """

    @staticmethod
    def forward(ctx, src: torch.Tensor, ref: torch.Tensor, dk: DiscretizedKernel):
        ctx.dk = dk
        ctx.save_for_backward(src, ref)
        return _filter_plain(src, ref, dk)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        src, ref = ctx.saved_tensors
        grad_src = _filter_plain(g, ref, ctx.dk) if ctx.needs_input_grad[0] else None
        grad_ref = deriv_filter_grad(ref, ctx.dk, src, g) if ctx.needs_input_grad[1] else None
        return grad_src, grad_ref, None


def lattice_filter(src: torch.Tensor, ref: torch.Tensor, dk: DiscretizedKernel) -> torch.Tensor:
    """K(ref, ref) @ src, differentiable in src and ref by the reference-parity gradients."""
    return LatticeFilter.apply(src, ref, dk)
