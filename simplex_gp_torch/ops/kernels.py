"""Stationary kernel functions (of squared distance) and their discretizations.

Port of simplex_gp_tpu/ops/kernels.py (:35-132, :268-295).  The numpy forms
feed the host-side tap search in :mod:`coeffs`; :func:`kernel_value` is the
exact kernel on torch tensors, for pivoted-Cholesky columns.  The Gaussian
mixture kernel is not ported yet.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..kernels.pivot import stationary_value
from .coeffs import get_coeffs, tap_variance

__all__ = ["DiscretizedKernel", "rbf_kernel", "matern_kernel", "kernel_value"]


def _rbf(d2: np.ndarray) -> np.ndarray:
    return np.exp(-d2)


def _rbf_deriv(d2: np.ndarray) -> np.ndarray:
    # d/dz exp(-z) = -exp(-z)
    return -np.exp(-d2)


def _matern(d2: np.ndarray, nu: float) -> np.ndarray:
    d = np.sqrt(np.abs(d2))
    exp_component = np.exp(-np.sqrt(2 * nu) * d)
    if nu == 0.5:
        poly = 1.0
    elif nu == 1.5:
        poly = np.sqrt(3) * d + 1.0
    elif nu == 2.5:
        poly = np.sqrt(5) * d + 1.0 + (5.0 / 3.0) * d**2
    else:
        raise NotImplementedError(f"Matern nu={nu} not supported (use 0.5, 1.5, 2.5)")
    return poly * exp_component


def _matern_deriv(d2: np.ndarray, nu: float) -> np.ndarray:
    """d/dz matern(z, nu) evaluated at z = d2 (closed form, finite at 0 for nu>=1.5)."""
    d = np.sqrt(np.abs(d2))
    exp_component = np.exp(-np.sqrt(2 * nu) * d)
    if nu == 1.5:
        poly = -1.5
    elif nu == 2.5:
        poly = -(5.0 / 6.0) * (1.0 + np.sqrt(5) * d)
    else:
        raise NotImplementedError(f"Matern derivative for nu={nu} not supported")
    return poly * exp_component


@dataclasses.dataclass(frozen=True)
class DiscretizedKernel:
    """A stationary kernel discretized to (2*order+1) filter taps.

    Attributes:
      name: kernel name, "rbf" or "matern<nu>".
      order: filter order r; the blur has 2r+1 taps.
      coeffs: forward filter taps, center-normalized, tuple of 2r+1 floats.
      deriv_coeffs: taps of dk/d(d^2), center-normalized.
      dk0: dk/d(d^2) at d^2=0, the signed scale lost by center-normalization.
      variance / deriv_variance: discrete tap variances, which calibrate the
        lattice scale factors (permutohedral.h:388-389).
      nu: Matern smoothness; 0.0 for RBF.
    """

    name: str
    order: int
    coeffs: tuple
    deriv_coeffs: tuple
    dk0: float
    variance: float
    deriv_variance: float
    nu: float = 0.0

    @staticmethod
    def build(name: str, kernel_fn, deriv_fn, order: int, nu: float = 0.0) -> "DiscretizedKernel":
        coeffs = get_coeffs(lambda tau: kernel_fn(tau**2), order)
        deriv_coeffs = get_coeffs(lambda tau: deriv_fn(tau**2), order)
        dk0 = float(deriv_fn(np.zeros(1))[0])
        return DiscretizedKernel(
            name=name,
            order=order,
            coeffs=tuple(float(c) for c in coeffs),
            deriv_coeffs=tuple(float(c) for c in deriv_coeffs),
            dk0=dk0,
            variance=tap_variance(coeffs),
            deriv_variance=tap_variance(deriv_coeffs),
            nu=nu,
        )


@functools.lru_cache(maxsize=None)
def rbf_kernel(order: int = 2) -> DiscretizedKernel:
    """Discretized RBF kernel k(d^2) = exp(-d^2) (reference RBFLattice default order=2)."""
    return DiscretizedKernel.build("rbf", _rbf, _rbf_deriv, order)


@functools.lru_cache(maxsize=None)
def matern_kernel(nu: float = 1.5, order: int = 3) -> DiscretizedKernel:
    """Discretized Matern kernel, nu in {1.5, 2.5} (reference MaternLattice default order=3)."""
    return DiscretizedKernel.build(
        f"matern{nu}",
        lambda d2: _matern(d2, nu),
        lambda d2: _matern_deriv(d2, nu),
        order,
        nu=nu,
    )


def kernel_value(dk: DiscretizedKernel, d2: torch.Tensor) -> torch.Tensor:
    """Exact (undiscretized) kernel value k(d2) of ``dk`` on torch tensors."""
    if dk.name != "rbf" and not dk.name.startswith("matern"):
        raise ValueError(f"unknown kernel {dk.name!r}")
    return stationary_value(d2, dk.nu)
