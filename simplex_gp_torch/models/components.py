"""Parameter constraints: raw (unconstrained) values to the positive quantities.

Port of simplex_gp_tpu/models/components.py: lengthscale and outputscale
through softplus, noise through softplus above a GreaterThan(min_noise)
floor (reference train_simplexgp.py:15-16).
"""

from __future__ import annotations

import torch

__all__ = ["softplus", "inv_softplus", "constrain", "init_raw_params"]


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def inv_softplus(y: torch.Tensor) -> torch.Tensor:
    # inverse of softplus for y > 0
    return torch.log(torch.expm1(torch.clamp(y, min=1e-8)))


def constrain(raw: dict, min_noise: float) -> dict:
    """Map raw parameters to inv_ell, outputscale, noise and mean."""
    return {
        "inv_ell": 1.0 / softplus(raw["raw_lengthscale"]),
        "outputscale": softplus(raw["raw_outputscale"]),
        "noise": min_noise + softplus(raw["raw_noise"]),
        "mean": raw["mean"],
    }


def init_raw_params(
    num_dims: int,
    lengthscale: float = 0.6931,
    outputscale: float = 0.6931,
    noise: float = 0.6931,
    mean: float = 0.0,
    device=None,
) -> dict:
    """Raw parameters matching GPyTorch's defaults (softplus(0) = 0.6931)."""
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "raw_lengthscale": torch.full((num_dims,), float(inv_softplus(torch.tensor(lengthscale))), **f32),
        "raw_outputscale": inv_softplus(torch.tensor(outputscale, **f32)),
        "raw_noise": inv_softplus(torch.tensor(noise, **f32)),
        "mean": torch.tensor(mean, **f32),
    }
