"""SGPR baseline: sparse GP regression with inducing points (Titsias' collapsed bound).

Port of simplex_gp_tpu/models/sgpr.py: m inducing locations Z, trained
with the kernel's parameters, and the collapsed variational bound of the
Nystrom kernel K_nm K_mm^{-1} K_mn plus noise, with its trace correction;
O(n m^2) time in (n, m) matrix products and m x m Cholesky factors, which
stay ``torch.linalg`` as JAX leaves them to XLA.  No kernel of its own.

:meth:`SGPR.init_inducing` draws Z from the training rows with a
``torch.Generator``; JAX draws with ``jax.random.choice``, so the rows
differ, and parity with JAX passes Z explicitly (``load_raw``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .exact_gp import _RawParams

__all__ = ["SGPR"]


class SGPR(_RawParams):
    """Sparse GP regression; the raw parameters are the exact GP's plus ``inducing`` (m, d)."""

    def __init__(self, num_dims: int, num_inducing: int = 512, kernel: str = "rbf", nu: float = 1.5,
                 min_noise: float = 1e-4, device=None):
        if not (kernel == "rbf" or (kernel == "matern" and nu == 1.5)):
            raise ValueError(f"unsupported kernel {kernel}/{nu}")
        super().__init__(num_dims, min_noise, device)
        self.num_inducing = num_inducing
        self.kernel = kernel
        self.nu = nu
        self.inducing = nn.Parameter(torch.zeros((num_inducing, num_dims), dtype=torch.float32, device=device))

    def extra_repr(self) -> str:
        return (f"num_dims={self.num_dims}, num_inducing={self.num_inducing}, kernel={self.kernel!r}, nu={self.nu}, "
                f"min_noise={self.min_noise}")

    def raw(self) -> dict:
        return {**super().raw(), "inducing": self.inducing}

    @torch.no_grad()
    def load_raw(self, raw: dict):
        """Copy a raw dict, ``inducing`` included when it has one: in place at the same number of rows (an
        optimizer over the parameters keeps them), else as a new parameter."""
        super().load_raw(raw)
        if "inducing" in raw:
            z = raw["inducing"]
            z = z.detach().float() if isinstance(z, torch.Tensor) else torch.from_numpy(np.array(z, np.float32))
            z = z.reshape(-1, self.num_dims).to(self.inducing.device)
            if z.shape == self.inducing.shape:
                self.inducing.copy_(z)
            else:
                self.inducing = nn.Parameter(z.clone())
                self.num_inducing = z.shape[0]
        return self

    @torch.no_grad()
    def init_inducing(self, x: torch.Tensor, seed: int = 0) -> "SGPR":
        """Z = min(m, n) training rows drawn without replacement (sgpr.py:37-44, with torch's generator)."""
        m = min(self.num_inducing, x.shape[0])
        idx = torch.randperm(x.shape[0], generator=torch.Generator().manual_seed(seed))[:m]
        return self.load_raw({**self.raw(), "inducing": x[idx.to(x.device)]})

    def constrained(self) -> dict:
        p = super().constrained()
        p["inducing"] = self.inducing
        return p

    def _k(self, params: dict, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        r1 = x1 * params["inv_ell"]
        r2 = x2 * params["inv_ell"]
        # Matmul-form squared distances, as sgpr.py:55 (they lose precision near duplicates).
        d2 = (r1 * r1).sum(-1)[:, None] + (r2 * r2).sum(-1)[None, :] - 2.0 * (r1 @ r2.T)
        d2 = torch.clamp(d2, min=0.0)
        if self.kernel == "rbf":
            k = torch.exp(-d2)
        else:
            d = torch.sqrt(d2 + 1e-12)
            k = (1 + math.sqrt(3.0) * d) * torch.exp(-math.sqrt(3.0) * d)
        return params["outputscale"] * k

    def _common(self, params: dict, x: torch.Tensor, y: torch.Tensor) -> dict:
        z = params["inducing"]
        m = z.shape[0]
        noise = params["noise"]
        eye = torch.eye(m, dtype=x.dtype, device=x.device)
        L = torch.linalg.cholesky(self._k(params, z, z) + 1e-5 * eye)
        A = torch.linalg.solve_triangular(L, self._k(params, z, x), upper=False) / torch.sqrt(noise)  # (m, n)
        LB = torch.linalg.cholesky(eye + A @ A.T)
        yc = (y - params["mean"]) / torch.sqrt(noise)
        c = torch.linalg.solve_triangular(LB, (A @ yc)[:, None], upper=False)[:, 0]
        return dict(L=L, A=A, LB=LB, c=c, yc=yc, n=x.shape[0], noise=noise)

    def nlml(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """The negated collapsed bound / n, the training loss (sgpr.py:82-95)."""
        params = self.constrained()
        q = self._common(params, x, y)
        n, noise = q["n"], q["noise"]
        logdet = 2 * torch.log(torch.diagonal(q["LB"])).sum() + n * torch.log(noise)
        quad = (q["yc"] * q["yc"]).sum() - (q["c"] * q["c"]).sum()
        kdiag = params["outputscale"] * torch.ones((n,), dtype=x.dtype, device=x.device)
        qdiag = noise * (q["A"] * q["A"]).sum(dim=0)
        trace = (kdiag.sum() - qdiag.sum()) / noise
        return 0.5 * (logdet + quad + n * math.log(2 * math.pi) + trace) / n

    @torch.no_grad()
    def predict(self, x: torch.Tensor, y: torch.Tensor, x_test: torch.Tensor):
        """Posterior mean and variance (with noise) at x_test (sgpr.py:97-111)."""
        params = self.constrained()
        q = self._common(params, x, y)
        lk = torch.linalg.solve_triangular(q["L"], self._k(params, params["inducing"], x_test), upper=False)
        w = torch.linalg.solve_triangular(q["LB"], lk, upper=False)
        mean = w.T @ q["c"] + params["mean"]
        var = params["outputscale"] - (lk * lk).sum(dim=0) + (w * w).sum(dim=0) + q["noise"]
        return mean, torch.clamp(var, min=1e-8)
