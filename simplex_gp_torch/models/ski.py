"""SKIP baseline: structured kernel interpolation with product structure.

Port of simplex_gp_tpu/models/ski.py.  Each dimension j has a 1-D
stationary kernel on a regular grid of ``grid_size`` points spanning the
data with a two-cell margin; its top-r eigenpairs give a (g, r) factor U_j,
cubic interpolation (Keys, 4 taps) carries it to the points as F_j (n, r),
and the product kernel's root R (K ~= R R^T, without the outputscale) is
built by Hadamard steps R <- trunc_r(R (.) F_j), each truncated back to
rank r by a randomized range finder: Y = M Omega_j, Q = qr(Y),
B = Q^T M, R = Q U_B S_B from the SVD of B.  M = R (.) F_j is never
formed: K13 (``kernels/ski.py``, ``csrc/ski.cu``) computes F_j, M Omega,
Q^T M and their adjoints.  The NLML and the predictions are the Woodbury
algebra of the rank-r + noise operator, in JAX's order.

Omega_j (r^2, r) is ``omegas[j - 1]`` when given (e.g. JAX's
``jax.random.normal(PRNGKey(j), (r^2, r))`` arrays), else standard normal
draws from a CPU ``torch.Generator`` seeded with j, moved to the device, so
CPU and card runs draw the same Omega; they differ from JAX's draws.

Signs.  The eigenvectors of each grid kernel and the columns of Q and U_B
are defined up to sign, and LAPACK and cuSOLVER choose differently.  Since
Omega is fixed, a flipped column of F_j or R is a different range finder
(the NLML moves by ~3e-3 at the round-5 checkpoint), so the port fixes
every such sign by :func:`fix_signs`; JAX leaves them to its LAPACK.  With
the same rule applied to JAX's ``eigh``, ``qr`` and ``svd`` the two agree.

The grid kernels' eigendecompositions run on the host, in float32, on any
device (:meth:`SKIP.grid_factors`).  The 30-odd smallest of the r kept
eigenvalues lie within float32 roundoff of each other, so the
eigenvectors returned for them depend on the eigensolver, and through the
fixed Omega the root does too: on an H100, cuSOLVER's moved the NLML at
the round-5 checkpoint by 2.1e-3, and the raw gradient at the median init
by 13% (relative), from JAX's CPU LAPACK, where the host's LAPACK stays
within 1.7e-4 and 0.7% (precipitation, 65,536 rows).  A
(g, g) = (100, 100) eigh is cheap on the host, and CPU and card runs then
take the same eigenvectors.

Gradients: ``sqrt(clamp(evals, min=0))`` has a zero gradient at a clamped
eigenvalue, where JAX's ``sqrt(maximum(evals, 0))`` gives NaN (it happens
with the RBF grid kernel, whose small eigenvalues go negative in float32).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..kernels.ski import KhatriRaoGram, KhatriRaoMatmul, SkiInterp
from .exact_gp import _RawParams

__all__ = ["SKIP", "fix_signs", "sign_weights"]

_PHI = (math.sqrt(5.0) - 1.0) / 2.0


def sign_weights(rows: int, device=None) -> torch.Tensor:
    """Weyl-sequence weights frac(i phi) - 1/2, i = 1..rows (float64 arithmetic, exact on any device).

    Generic: no symmetric or antisymmetric vector (the grid kernel's
    eigenvectors are one or the other) is orthogonal to them.
    """
    i = torch.arange(1, rows + 1, dtype=torch.float64, device=device)
    return (torch.remainder(i * _PHI, 1.0) - 0.5).to(torch.float32)


def fix_signs(V: torch.Tensor) -> torch.Tensor:
    """V with each column's sign chosen so that its product with :func:`sign_weights` is >= 0."""
    with torch.no_grad():
        s = torch.where(sign_weights(V.shape[0], V.device) @ V >= 0, 1.0, -1.0)
    return V * s[None, :]


@contextlib.contextmanager
def _one_host_thread():
    """torch's host threads set to one within the block, then restored.

    The grid's (g, g) LAPACK calls gain nothing from threads, and the idle
    threads of a threaded call spin on the cores that launch the card's
    work: on an H100 host (8 cores, MKL) a SKIP step took 109-119 ms with
    8 threads and 40 ms with one.
    """
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


class _HostGridFactor(torch.autograd.Function):
    """:meth:`SKIP.grid_factor` on the host in one thread, forward and backward; differentiable in the
    lengthscale (the data range is data)."""

    @staticmethod
    def forward(ctx, inv_ell_j, lo, hi, model, r):
        with _one_host_thread(), torch.enable_grad():
            leaf = inv_ell_j.detach().requires_grad_()
            grid_min, step, U = model.grid_factor(leaf, lo, hi, r)
        ctx.graph = (leaf, U)
        ctx.mark_non_differentiable(grid_min, step)
        return grid_min, step, U.detach()

    @staticmethod
    def backward(ctx, _d_grid_min, _d_step, dU):
        leaf, U = ctx.graph
        with _one_host_thread():
            (grad,) = torch.autograd.grad(U, leaf, dU)
        return grad, None, None, None, None


class SKIP(_RawParams):
    """Product-structure KISS-GP regression model (SKIP baseline), ``nn.Module`` of the raw parameters."""

    def __init__(self, num_dims: int, grid_size: int = 100, rank: int = 64, kernel: str = "rbf", nu: float = 1.5,
                 min_noise: float = 1e-4, omegas: Optional[Sequence] = None, device=None):
        if not (kernel == "rbf" or (kernel == "matern" and nu == 1.5)):
            raise ValueError(f"unsupported kernel {kernel}/{nu}")
        super().__init__(num_dims, min_noise, device)
        self.grid_size = grid_size
        self.rank = rank
        self.kernel = kernel
        self.nu = nu
        self.omegas = omegas
        self._omega_cache = {}

    def extra_repr(self) -> str:
        return (f"num_dims={self.num_dims}, grid_size={self.grid_size}, rank={self.rank}, kernel={self.kernel!r}, "
                f"nu={self.nu}, min_noise={self.min_noise}")

    def _grid_kernel_1d(self, inv_ell_j: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
        d2 = ((grid[:, None] - grid[None, :]) * inv_ell_j) ** 2
        if self.kernel == "rbf":
            return torch.exp(-d2)
        dd = torch.sqrt(d2 + 1e-12)
        return (1 + math.sqrt(3.0) * dd) * torch.exp(-math.sqrt(3.0) * dd)

    def omega(self, j: int, r: int, device) -> torch.Tensor:
        """Omega_j (r^2, r) of Hadamard step j >= 1."""
        key = (j, r, str(device))
        if key not in self._omega_cache:
            if self.omegas is not None:
                w = self.omegas[j - 1]
                w = w.detach().float() if isinstance(w, torch.Tensor) else torch.from_numpy(np.array(w, np.float32))
            else:
                w = torch.randn((r * r, r), generator=torch.Generator().manual_seed(j), dtype=torch.float32)
            if w.shape != (r * r, r):
                raise ValueError(f"omega {j} has shape {tuple(w.shape)}, expected {(r * r, r)}")
            self._omega_cache[key] = w.to(device).contiguous()
        return self._omega_cache[key]

    def grid_factor(self, inv_ell_j: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, r: int):
        """(grid origin, step, U (g, r)) of one dimension with data range [lo, hi]: the grid and its kernel's
        top-r eigenpairs (ski.py:97-106), on the device of the arguments."""
        g = self.grid_size
        step = (hi - lo) / (g - 5) + 1e-12
        grid_min = lo - 2 * step
        grid = grid_min + step * torch.arange(g, dtype=lo.dtype, device=lo.device)
        evals, evecs = torch.linalg.eigh(self._grid_kernel_1d(inv_ell_j, grid))
        U = fix_signs(evecs[:, -r:]) * torch.sqrt(torch.clamp(evals[-r:], min=0.0))[None, :]
        return grid_min, step, U.contiguous()  # LAPACK's eigenvectors come column-major

    def grid_factors(self, params: dict, x: torch.Tensor, r: int) -> list:
        """Each dimension's (grid origin, step, U) on x's device, computed on the host (one copy of the data
        ranges and the lengthscales; see the module docstring)."""
        lo, hi = torch.stack(torch.aminmax(x, dim=0)).cpu()
        inv_ell = params["inv_ell"].cpu()
        return [tuple(t.to(x.device) for t in _HostGridFactor.apply(inv_ell[j], lo[j], hi[j], self, r))
                for j in range(x.shape[1])]

    @staticmethod
    def hadamard_step(R: torch.Tensor, F: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
        """trunc_r(R (.) F) by the randomized range finder (ski.py:112-123): K13b, QR, K13c, SVD."""
        r = R.shape[1]
        Q, _ = torch.linalg.qr(KhatriRaoMatmul.apply(R, F, omega))
        Q = fix_signs(Q)
        Ub, sb, _ = torch.linalg.svd(KhatriRaoGram.apply(Q, R, F), full_matrices=False)
        return (Q @ fix_signs(Ub[:, :r])) * sb[:r][None, :]

    def root(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """Rank-r root R (n, r) with K ~= R R^T, without the outputscale (ski.py:87-124)."""
        r = min(self.rank, self.grid_size)
        R = None
        for j, (grid_min, step, U) in enumerate(self.grid_factors(params, x, r)):
            F = SkiInterp.apply(x[:, j].contiguous(), grid_min, step, U)
            R = F if R is None else self.hadamard_step(R, F, self.omega(j, r, x.device))
        return R

    def nlml(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Exact NLML / n of the rank-r + noise operator, by Woodbury and the determinant lemma (ski.py:135-148)."""
        params = self.constrained()
        R = self.root(params, x)
        n, r = R.shape
        s, noise = params["outputscale"], params["noise"]
        yc = y - params["mean"]
        A = s * (R.T @ R) / noise + torch.eye(r, dtype=R.dtype, device=R.device)
        L = torch.linalg.cholesky(A)
        logdet = 2 * torch.log(torch.diagonal(L)).sum() + n * torch.log(noise)
        Rty = R.T @ yc
        sol = torch.cholesky_solve(Rty[:, None], L)[:, 0]
        quad = ((yc * yc).sum() - s * (Rty * sol).sum() / noise) / noise
        return 0.5 * (quad + logdet + n * math.log(2 * math.pi)) / n

    @torch.no_grad()
    def predict(self, x: torch.Tensor, y: torch.Tensor, x_test: torch.Tensor):
        """Posterior mean and variance at x_test from one joint root over [x; x_test] (ski.py:150-172).

        The variance is the reference's, which is known to be too small
        (its test NLL is ~47 on precipitation); it is clamped at 1e-8.
        """
        params = self.constrained()
        s, noise = params["outputscale"], params["noise"]
        n = x.shape[0]
        R = self.root(params, torch.cat([x, x_test], dim=0))
        Rtr, Rte = R[:n], R[n:]
        yc = y - params["mean"]
        r = R.shape[1]
        C = Rtr.T @ Rtr
        A = s * C / noise + torch.eye(r, dtype=R.dtype, device=R.device)
        L = torch.linalg.cholesky(A)
        Rty = Rtr.T @ yc
        sol = torch.cholesky_solve(Rty[:, None], L)[:, 0]
        alpha_r = (Rty - s * (Rtr.T @ (Rtr @ sol)) / noise) / noise
        mean = s * (Rte @ alpha_r) + params["mean"]
        AinvC = torch.cholesky_solve(C, L)
        inner = (C - s * C @ AinvC / noise) / noise
        var = s + noise - (s**2) * ((Rte @ inner) * Rte).sum(dim=-1)
        return mean, torch.clamp(var, min=1e-8)
