"""K14, the SLQ quadrature of small symmetric tridiagonals: the wrappers over ``csrc/slq.cu`` and their plain versions.

Each probe's e1^T log(T) e1 = sum_i z_i^2 log(max(lambda_i, 1e-10)) for its tridiagonal T, given either as a
band (``slq_quadrature``: diagonal ``diag`` (p, m), off-diagonal ``off`` (p, m-1)) or as the CG record that
``logdet_from_cg_tridiag`` reads (``slq_quadrature_cg``: ``alphas``, ``betas``, ``tmask`` (p, m), whose band is
:func:`cg_band`), in any strides (a transposed view of a step-major (m, p) record works as it is).  On CUDA
tensors one launch: a warp a probe, the band staged (formed from the record, in ``cg_band``'s IEEE operations,
when given one), implicit QL in double on the leading block that holds e1 (up to the first zero
off-diagonal), the first row of the eigenvectors carried along; no dense T, no library call, no host read.
Each launch counts in ``slq_quadrature.launches`` and in the trace counter ``slq.kernel``.  On CPU tensors
the plain versions: the batched float32 ``torch.linalg.eigh`` of the dense T.
"""

from __future__ import annotations

import torch

from .. import trace
from . import build

__all__ = ["MAX_M", "cg_band", "slq_quadrature_plain", "slq_quadrature", "slq_quadrature_cg"]

MAX_M = 2048  # csrc/slq.cu's SLQ_MAX_M: a probe's three double rows in 48 KB of shared memory


def cg_band(alphas: torch.Tensor, betas: torch.Tensor, tmask: torch.Tensor) -> tuple:
    """The band of a CG record's tridiagonals (simplex_gp_tpu/linalg/lanczos.py:163-176) from its (m, p)
    ``alphas``, ``betas`` and live mask: (diag (p, m), off (p, m-1)), transposed views of step-major tensors.

    T[k,k] = 1/alpha_k + beta_{k-1}/alpha_{k-1}, T[k,k+1] = sqrt(beta_k)/alpha_k on live steps; a dead step
    is a decoupled identity row (diagonal 1, couplings 0).
    """
    m, p = alphas.shape
    live = tmask
    live_next = torch.cat([tmask[1:], torch.zeros((1, p), dtype=torch.bool, device=tmask.device)])
    inv_a = 1.0 / torch.where(live, alphas, 1.0)
    b_over_a = torch.where(live, betas, 0.0) * inv_a
    prev_ba = torch.cat([torch.zeros((1, p), dtype=torch.float32, device=alphas.device), b_over_a[:-1]])
    diag = torch.where(live, inv_a + prev_ba, 1.0)
    off = torch.where(live & live_next, torch.sqrt(torch.clamp(betas, min=0.0)) * inv_a, 0.0)[:-1]
    return diag.T, off.T


def slq_quadrature_plain(diag: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Plain K14: batched ``torch.linalg.eigh`` of the dense (p, m, m) T, eigenvalues clamped at 1e-10
    (simplex_gp_tpu/linalg/lanczos.py:128-132, :177-180)."""
    T = torch.diag_embed(diag) + torch.diag_embed(off, offset=1) + torch.diag_embed(off, offset=-1)
    evals, evecs = torch.linalg.eigh(T)
    evals = torch.clamp(evals, min=1e-10)
    return (evecs[:, 0, :] ** 2 * torch.log(evals)).sum(dim=-1)


def _launch(what: str, a: torch.Tensor, b: torch.Tensor, mask, b_cols: int) -> torch.Tensor:
    """One K14 launch on float32 ``a`` (p, m) and ``b`` (p, b_cols), with ``mask`` (p, m) bool or None."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"{what}: expected 2-D inputs, got {tuple(a.shape)}, {tuple(b.shape)}")
    p, m = a.shape
    for t in (a, b):
        if not t.is_cuda or t.dtype != torch.float32 or t.device != a.device:
            raise ValueError(f"{what}: expected float32 tensors on {a.device}, got {t.dtype} on {t.device}")
    if mask is not None and (mask.dtype != torch.bool or mask.device != a.device or mask.shape != (p, m)):
        raise ValueError(f"{what}: expected a ({p}, {m}) bool mask on {a.device}, got {mask.dtype} "
                         f"{tuple(mask.shape)} on {mask.device}")
    if b.shape != (p, b_cols) or not 1 <= m <= MAX_M:
        raise ValueError(f"{what}: {tuple(b.shape)} does not fit {tuple(a.shape)}, or m is outside 1..{MAX_M}")
    out = torch.empty(p, dtype=torch.float32, device=a.device)
    mask_args = (None, 0, 0) if mask is None else (mask.data_ptr(), *mask.stride())
    rc = build.library().sgp_slq_quadrature(a.data_ptr(), *a.stride(), b.data_ptr(), *b.stride(), *mask_args, p, m,
                                            out.data_ptr(), build.stream())
    build.check(rc, what)
    slq_quadrature.launches += 1
    trace.count("slq.kernel")
    return out


def slq_quadrature(diag: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """K14 on a band: the (p,) float32 quadratures of the tridiagonals (``diag`` (p, m), ``off`` (p, m-1))."""
    if not diag.is_cuda:
        return slq_quadrature_plain(diag, off)
    return _launch("slq_quadrature", diag, off, None, diag.shape[-1] - 1)


slq_quadrature.launches = 0


def slq_quadrature_cg(alphas: torch.Tensor, betas: torch.Tensor, tmask: torch.Tensor) -> torch.Tensor:
    """K14 on a CG record: the (p,) quadratures of the tridiagonals of ``alphas``, ``betas``, ``tmask`` (m, p),
    the record's layout (the kernel reads the transposed views; one launch, counted in
    ``slq_quadrature.launches``)."""
    if not alphas.is_cuda:
        return slq_quadrature_plain(*cg_band(alphas, betas, tmask))
    return _launch("slq_quadrature_cg", alphas.T, betas.T, tmask.T, alphas.shape[0])
