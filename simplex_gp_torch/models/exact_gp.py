"""Simplex-GP serving: the posterior cache and prediction.

Port of the serving half of simplex_gp_tpu/models/exact_gp.py::SimplexGP
for the rbf and Matern lattice kernels:

    ConstantMean + ScaleKernel(RBFLattice/MaternLattice, ard_num_dims=d)
    + GaussianLikelihood(GreaterThan(min_noise))

``posterior_cache`` builds one lattice plan over the training positions,
a rank-k pivoted-Cholesky preconditioner, solves alpha = K_hat^{-1} (y - mu)
by preconditioned CG at the eval tolerance, and forms the LOVE root from a
randomized range sketch.  ``predict_from_cache`` runs one rectangular filter
of 1+m columns over [train; test].  Training (the NLML and its gradients)
is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..linalg.cg import cg_solve
from ..linalg.mll import BBMMConfig, build_precond
from ..linalg.pivoted_cholesky import precond_solve
from ..ops.filter import apply_plan_any, build_plan_any, lattice_filter_rect
from ..ops.kernels import DiscretizedKernel, matern_kernel, rbf_kernel
from .components import constrain, init_raw_params

__all__ = ["SimplexGP"]

_RAW_NAMES = ("raw_lengthscale", "raw_outputscale", "raw_noise", "mean")


class SimplexGP(nn.Module):
    """Lattice-accelerated exact GP regression model.

    The raw (unconstrained) parameters are ``nn.Parameter``s named as the
    JAX package's raw dict: ``raw_lengthscale`` (d,), ``raw_outputscale``,
    ``raw_noise`` and ``mean``.  Every method runs on the device of the
    module's parameters and of its inputs.
    """

    def __init__(
        self,
        num_dims: int,
        kernel: str = "rbf",
        nu: float = 1.5,
        order: int = 1,
        min_noise: float = 1e-4,
        bbmm: BBMMConfig = BBMMConfig(),
        eval_cg_tolerance: float = 1e-2,
        device=None,
    ):
        super().__init__()
        if kernel not in ("rbf", "matern"):
            raise ValueError(f"unknown kernel {kernel!r} (the port has rbf and matern)")
        self.num_dims = num_dims
        self.kernel = kernel
        self.nu = nu
        self.order = order
        self.min_noise = min_noise
        self.bbmm = bbmm
        self.eval_cg_tolerance = eval_cg_tolerance
        for name, value in init_raw_params(num_dims, device=device).items():
            setattr(self, name, nn.Parameter(value))

    @property
    def dk(self) -> DiscretizedKernel:
        if self.kernel == "rbf":
            return rbf_kernel(self.order)
        return matern_kernel(self.nu, self.order)

    def raw(self) -> dict:
        return {name: getattr(self, name) for name in _RAW_NAMES}

    @torch.no_grad()
    def load_raw(self, raw: dict) -> "SimplexGP":
        """Copy a raw parameter dict (tensors or numpy arrays) into the module."""
        for name in _RAW_NAMES:
            p = getattr(self, name)
            value = raw[name]
            if not isinstance(value, torch.Tensor):
                value = torch.from_numpy(np.array(value, dtype=np.float32))
            p.copy_(value.reshape(p.shape))
        return self

    def constrained(self) -> dict:
        return constrain(self.raw(), self.min_noise)

    def _khat_mv(self, params: dict, plan):
        s, noise = params["outputscale"], params["noise"]

        def mv(V):
            return s * apply_plan_any(plan, V, self.dk) + noise * V

        return mv

    @torch.no_grad()
    def posterior_cache(
        self,
        x: torch.Tensor,
        y: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        omega: Optional[torch.Tensor] = None,
        root_rank: Optional[int] = None,
    ) -> dict:
        """alpha = K_hat^{-1} (y - mu) and the LOVE root for variances.

        The root comes from a randomized range sketch: Y = K_hat Omega,
        Q = qr(Y), T = Q^T K_hat Q, root_inv = Q U L^{-1/2} for T = U L U^T.
        ``Omega`` (n, m) is ``omega`` when given, else standard normal draws
        from ``generator``.  Both sketch MVMs reuse the CG's plan.  The cache
        also records the CG iteration count and mean final residual.
        """
        params = self.constrained()
        ref = x * params["inv_ell"]
        plan = build_plan_any(ref, self.dk)
        mv = self._khat_mv(params, plan)
        yc = y - params["mean"]

        P = build_precond(self.dk, self.bbmm, params, ref, x.shape[0])
        precond = None if P is None else (lambda V: precond_solve(P, V))
        sol = cg_solve(
            mv, yc[:, None], tol=self.eval_cg_tolerance,
            max_iters=self.bbmm.max_cg_iterations, precond=precond,
        )
        alpha = sol.x[:, 0]

        n = x.shape[0]
        m = min(root_rank or self.bbmm.max_lanczos_iterations, n)
        if omega is None:
            omega = torch.randn((n, m), generator=generator, dtype=torch.float32, device=x.device)
        elif omega.shape != (n, m):
            raise ValueError(f"omega has shape {tuple(omega.shape)}, expected {(n, m)}")
        Q, _ = torch.linalg.qr(mv(omega))
        T = Q.T @ mv(Q)
        T = 0.5 * (T + T.T)
        evals, evecs = torch.linalg.eigh(T)
        evals = torch.clamp(evals, min=1e-8)
        root_inv = Q @ (evecs / torch.sqrt(evals)[None, :])
        return {
            "alpha": alpha,
            "root_inv": root_inv,
            "params": params,
            "cg_iters": sol.iterations,
            "cg_res": sol.residual_norm.mean(),
        }

    @torch.no_grad()
    def predict_from_cache(self, cache: dict, x: torch.Tensor, x_test: torch.Tensor):
        """Posterior mean and variance at x_test: one rect filter of 1+m columns."""
        params = cache["params"]
        ref = x * params["inv_ell"]
        ref_test = x_test * params["inv_ell"]
        s = params["outputscale"]

        cols = torch.cat([cache["alpha"][:, None], cache["root_inv"]], dim=-1)
        F = lattice_filter_rect(cols, ref, ref_test, self.dk)  # (n_test, 1+m)
        mean = s * F[:, 0] + params["mean"]
        S = s * F[:, 1:]
        var = s + params["noise"] - (S * S).sum(dim=-1)
        return mean, torch.clamp(var, min=1e-8)

    def predict(self, x, y, x_test, generator: Optional[torch.Generator] = None):
        """Posterior mean and variance at x_test: build the cache, predict once."""
        return self.predict_from_cache(self.posterior_cache(x, y, generator), x, x_test)
