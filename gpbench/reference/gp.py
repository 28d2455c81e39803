"""The Simplex-GP model in plain PyTorch: the training loss and its gradient, an Adam step, the posterior.

The model of simplex_gp_torch/models/exact_gp.py as its docstrings state it:
ConstantMean + ScaleKernel(Matern lattice, ARD) + Gaussian noise above
``min_noise`` (models/components.py:21-28 for the constraints).

- ``nlml_and_grad``: (y^T K_hat^{-1} y + log|K_hat| + n log 2 pi) / 2n for
  K_hat = s K + noise I, K the lattice operator at x / ell: the solves and the
  SLQ tridiagonals from one preconditioned CG over [y - mu | P^{1/2} z]
  (linalg/mll.py:198-245).  Its gradient is that of the same stochastic
  estimate (linalg/mll.py:274-299): with U = [-a alpha | (b/p) K_hat^{-1}
  P^{1/2} z] and V = [alpha | P^{-1/2} z] held fixed, the gradient of
  sum(U * K_hat V) + 2a (y - mu) . alpha, here by autograd through the
  operator's barycentric weights.
- ``adam``: torch.optim.Adam's update with its defaults.
- ``root`` and ``predict``: the posterior_cache's range sketch and
  predict_from_cache (models/exact_gp.py:181-260).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from .lattice import Lattice, filter_rect, ident
from .solver import cg, logdet_from_record, pivot_factor, precond

__all__ = ["constrain", "nlml_and_grad", "adam", "solve", "posterior", "root", "predict", "residual"]


def constrain(raw: dict, min_noise: float) -> dict:
    """The constrained parameters, softplus as logaddexp(x, 0) (models/components.py:16-28): the positions
    x / ell then equal the program's to the bit, so no point lands in another simplex by a rounding of ell."""
    sp = lambda v: torch.logaddexp(v, torch.zeros_like(v))
    return {"inv_ell": 1.0 / sp(raw["raw_lengthscale"]), "outputscale": sp(raw["raw_outputscale"]),
            "noise": min_noise + sp(raw["raw_noise"]), "mean": raw["mean"]}


def nlml_and_grad(cfg: dict, taps: tuple, variance: float, raw: dict, x: torch.Tensor, y: torch.Tensor,
                  probes: torch.Tensor, q: Callable = ident, follow: Optional[dict] = None) -> dict:
    """The loss and {leaf: gradient} at the raw parameters ``raw`` (tensors), with what they came from.

    Alone, the reference builds its own preconditioner and runs its own CG
    (``solves``, their best relative residuals ``res`` and the Lanczos
    ``record`` (alphas, betas, mask of the probe columns, the probes' squared
    norms) are returned).  With ``follow`` (a dict of those four and the
    ``pivots`` of another run of the same step) it takes that run's pivots and
    CG output as its own and checks those two stages by themselves:
    ``pivot_gap``, how far below the largest residual diagonal the pivots
    lie (solver.pivot_factor), and ``res_gap``, the largest gap between a
    column's relative residual under this operator and the one the run
    claims.  The loss (y^T alpha, log|P| and the SLQ quadrature of the record)
    and the gradient are this module's from there on.
    """
    live = {k: v.detach().clone().requires_grad_(True) for k, v in raw.items()}
    p = constrain(live, cfg["min_noise"])
    n, num_probes = probes.shape
    out = {}
    with torch.no_grad():
        s, noise, mu = p["outputscale"].detach(), p["noise"].detach(), p["mean"].detach()
        lat = Lattice(x * p["inv_ell"].detach(), taps, variance, q)
        mv = lambda V: s * lat.apply(V) + noise * V
        L, out["pivots"], out["pivot_gap"] = pivot_factor(x * p["inv_ell"].detach(), s, cfg["nu"],
                                                          min(cfg["precond_rank"], n - 1), q,
                                                          None if follow is None else follow["pivots"])
        P = precond(L, noise, n, q)
        yc = y - mu
        bp = P.sqrt(probes)
        b = torch.cat([yc[:, None], bp], 1)
        if follow is None:
            m = min(cfg["root_rank"], n, cfg["max_cg_iterations"])
            sol = cg(mv, b, P, cfg["cg_tolerance"], cfg["max_cg_iterations"], m, q)
            out.update(solves=sol.x, res=sol.residual, iters=sol.iterations,
                       record=(sol.alphas[:, 1:], sol.betas[:, 1:], sol.tmask[:, 1:], (probes * probes).sum(0)))
        else:
            X = follow["solves"]
            true = (mv(X) - b).norm(dim=0) / b.norm(dim=0)
            out.update(solves=X, record=follow["record"], res_gap=float((true - follow["res"]).abs().max()),
                       true_res=float(true.mean()))
        X = out["solves"]
        logdet = logdet_from_record(*out["record"]) + P.logdet
        alpha = X[:, 0]
        loss = 0.5 * ((yc * alpha).sum() + logdet + n * math.log(2.0 * math.pi)) / n
        a = c = 0.5 / n
        U = torch.cat([-a * alpha[:, None], (c / num_probes) * X[:, 1:]], 1)
        V = torch.cat([alpha[:, None], P.solve(bp)], 1)
    # The estimate's gradient: K's weights live in the positions x / ell, everything the CG gave held fixed.
    w = lat.live_weights(x * p["inv_ell"])
    surrogate = ((U * (p["outputscale"] * lat.apply(V, weights=w) + p["noise"] * V)).sum()
                 + 2 * a * ((y - p["mean"]) * alpha).sum())
    grads = torch.autograd.grad(surrogate, [live[k] for k in raw])
    out.update(loss=float(loss), grad=dict(zip(raw, grads)))
    return out


def adam(params: dict, grads: dict, state: dict, lr: float, betas=(0.9, 0.999), eps: float = 1e-8) -> dict:
    """One step of torch.optim.Adam's update (no weight decay, no amsgrad); ``state`` carries over."""
    state["t"] = state.get("t", 0) + 1
    t = state["t"]
    out = {}
    for k, g in grads.items():
        m = state.setdefault(("m", k), torch.zeros_like(g)).mul_(betas[0]).add_(g, alpha=1 - betas[0])
        v = state.setdefault(("v", k), torch.zeros_like(g)).mul_(betas[1]).addcmul_(g, g, value=1 - betas[1])
        denom = (v.sqrt() / math.sqrt(1 - betas[1] ** t)).add_(eps)
        out[k] = params[k] - (lr / (1 - betas[0] ** t)) * m / denom
    return out


def solve(cfg: dict, taps: tuple, variance: float, params: dict, x: torch.Tensor, y: torch.Tensor,
          q: Callable = ident) -> tuple:
    """(alpha, the CG's best relative residual): posterior_cache's eval CG, to its tolerance or its stall guard."""
    s, noise = params["outputscale"], params["noise"]
    ref = x * params["inv_ell"]
    lat = Lattice(ref, taps, variance, q)
    P = precond(pivot_factor(ref, s, cfg["nu"], min(cfg["precond_rank"], x.shape[0] - 1), q)[0], noise, x.shape[0], q)
    sol = cg(lambda V: s * lat.apply(V) + noise * V, (y - params["mean"])[:, None], P, cfg["eval_cg_tolerance"],
             cfg["max_cg_iterations"], 0, q)
    return sol.x[:, 0], float(sol.residual.mean())


def posterior(cfg: dict, taps: tuple, variance: float, params: dict, x: torch.Tensor, y: torch.Tensor,
              omega: torch.Tensor, q: Callable = ident) -> tuple:
    """(alpha, the CG's best relative residual, R): posterior_cache's eval CG and the root."""
    return (*solve(cfg, taps, variance, params, x, y, q), root(cfg, taps, variance, params, x, omega, q))


def root(cfg: dict, taps: tuple, variance: float, params: dict, x: torch.Tensor, omega: torch.Tensor,
         q: Callable = ident) -> torch.Tensor:
    """The LOVE root R (n, m) from the range sketch of K_hat with ``omega``: R R^T = Q (Q^T K_hat Q)^{-1} Q^T."""
    s, noise = params["outputscale"], params["noise"]
    lat = Lattice(x * params["inv_ell"], taps, variance, q)
    mv = lambda V: s * lat.apply_blocks(V) + noise * V
    Q, _ = torch.linalg.qr(mv(omega))
    T = q(Q).T @ q(mv(Q))
    evals, evecs = torch.linalg.eigh(0.5 * (T + T.T))
    return q(Q) @ q(evecs / torch.sqrt(torch.clamp(evals, min=1e-8))[None, :])


def predict(taps: tuple, variance: float, params: dict, x: torch.Tensor, x_test: torch.Tensor,
            alpha: torch.Tensor, R: torch.Tensor, q: Callable = ident) -> tuple:
    """(mean, var) at x_test from alpha and the root R (predict_from_cache, models/exact_gp.py:246-258)."""
    s = params["outputscale"]
    F = filter_rect(torch.cat([alpha[:, None], R], 1), x * params["inv_ell"], x_test * params["inv_ell"], taps,
                    variance, q)
    S = s * F[:, 1:]
    var = s + params["noise"] - (q(S) * q(S)).sum(-1)
    return s * F[:, 0] + params["mean"], torch.clamp(var, min=1e-8)


def residual(taps: tuple, variance: float, params: dict, x: torch.Tensor, y: torch.Tensor,
             alpha: torch.Tensor) -> float:
    """|K_hat alpha - (y - mu)| / |y - mu| under the reference operator."""
    lat = Lattice(x * params["inv_ell"], taps, variance)
    yc = y - params["mean"]
    r = params["outputscale"] * lat.apply_blocks(alpha[:, None])[:, 0] + params["noise"] * alpha - yc
    return float(r.norm() / yc.norm())
