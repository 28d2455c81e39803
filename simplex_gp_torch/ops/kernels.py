"""Stationary kernel functions (of squared distance) and their discretizations.

Port of simplex_gp_tpu/ops/kernels.py.  The numpy forms feed the host-side
tap search in :mod:`coeffs`; :func:`kernel_value` is the exact kernel on
torch tensors, for pivoted-Cholesky columns.  :class:`MixtureKernel` is the
Gaussian-mixture discretization of a Matern kernel (:135-265): its host
constants (alphas and profile-fit weights) are computed here as in JAX, with
scipy's ``nnls``, and :func:`fit_mixture_weights_subset` refits the weights
on the port's own filter.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..kernels.pivot import stationary_value
from .coeffs import get_coeffs, tap_variance

__all__ = [
    "DiscretizedKernel",
    "MixtureKernel",
    "rbf_kernel",
    "matern_kernel",
    "mixture_kernel",
    "fit_mixture_weights_subset",
    "kernel_value",
]


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


@dataclasses.dataclass(frozen=True)
class MixtureKernel:
    """Gaussian-mixture discretization of a stationary kernel (kernels.py:135-176).

    k(r) ~= sum_j w_j exp(-(alpha_j r)^2), w_j >= 0: each component is the
    plain RBF lattice filter at the scaled positions ``ref * alpha_j``, and
    the nonnegative weights keep the operator PSD.  The weights are fit on
    the host (profile NNLS at construction, or a subset refit against the
    dense target, :func:`fit_mixture_weights_subset`).
    """

    name: str
    order: int
    alphas: tuple  # per-component inverse-lengthscale multipliers
    weights: tuple  # nonnegative mixture weights
    base: DiscretizedKernel  # the shared RBF taps
    nu: float = 1.5  # target Matern smoothness

    @property
    def coeffs(self):
        return self.base.coeffs

    @property
    def variance(self):
        return self.base.variance


def _fit_profile_weights(kernel_fn, alphas: np.ndarray, r_max: float = 8.0, n_grid: int = 512) -> np.ndarray:
    """Nonnegative LSQ fit of ``kernel_fn(r^2)`` by sum_j w_j exp(-(a_j r)^2) on [0, r_max], sum 1."""
    from scipy.optimize import nnls

    r = np.linspace(0.0, r_max, n_grid)
    target = np.asarray(kernel_fn(r**2), dtype=np.float64)
    comp = np.exp(-np.outer(r**2, np.asarray(alphas, np.float64) ** 2))
    w, _ = nnls(comp, target)
    return w / max(w.sum(), 1e-12)


@functools.lru_cache(maxsize=None)
def mixture_kernel(nu: float = 1.5, order: int = 1, n_components: int = 8,
                   alpha_range: tuple = (0.25, 4.0)) -> MixtureKernel:
    """Gaussian-mixture discretization targeting Matern-``nu`` (kernels.py:201-218)."""
    alphas = np.geomspace(alpha_range[0], alpha_range[1], n_components)
    w = _fit_profile_weights(lambda d2: _matern(d2, nu), alphas)
    return MixtureKernel(
        name=f"mixture:matern{nu}",
        order=order,
        alphas=tuple(float(a) for a in alphas),
        weights=tuple(float(x) for x in w),
        base=rbf_kernel(order),
        nu=nu,
    )


def fit_mixture_weights_subset(mk: MixtureKernel, ref, m: int = 1024, n_probe: int = 8,
                               seed: int = 0) -> MixtureKernel:
    """Refit the mixture weights against the dense target on a data subset (kernels.py:221-265).

    ``ref`` (n, d) are the lengthscale-scaled positions, a numpy array or a
    tensor (the filters run on its device).  The seeded subset, probes and
    dense target are numpy, as in JAX; each component's filter is the
    port's (K4, ``filter_once``, at ``ref * alpha_j``); the weights come from
    ``nnls`` and are not renormalized: each lattice component delivers less
    mass than its ideal Gaussian, so the weights sum above 1 to make the
    operator match the unit-diagonal target.
    """
    from scipy.optimize import nnls

    from .filter import _filter_plain

    dev = ref.device if isinstance(ref, torch.Tensor) else torch.device("cpu")
    ref = ref.detach().cpu().numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref)
    rng = np.random.default_rng(seed)
    idx = rng.permutation(ref.shape[0])[: min(m, ref.shape[0])]
    rs = ref[idx]
    d2 = (rs * rs).sum(-1)[:, None] + (rs * rs).sum(-1)[None, :] - 2.0 * (rs @ rs.T)
    d2 = np.maximum(d2, 0.0)
    target = np.asarray(_matern(d2, mk.nu))
    v = rng.normal(size=(rs.shape[0], n_probe)).astype(np.float32)
    b = (target @ v).ravel()
    rt, vt = torch.from_numpy(np.ascontiguousarray(rs)).to(dev), torch.from_numpy(v).to(dev)
    with torch.no_grad():
        cols = [_filter_plain(vt, rt * float(a), mk.base).cpu().numpy().ravel() for a in mk.alphas]
    w, _ = nnls(np.stack(cols, axis=1), b)
    return dataclasses.replace(mk, weights=tuple(float(x) for x in w))


def kernel_value(dk, d2: torch.Tensor) -> torch.Tensor:
    """Exact (undiscretized) kernel value k(d2) of ``dk`` on torch tensors.

    For a :class:`MixtureKernel` this is the target Matern-nu, not the sum
    of Gaussians (kernels.py:268-282): the preconditioner's exact columns
    are those of the kernel the operator approximates.
    """
    if isinstance(dk, MixtureKernel):
        dk = matern_kernel(dk.nu, dk.order)
    if dk.name != "rbf" and not dk.name.startswith("matern"):
        raise ValueError(f"unknown kernel {dk.name!r}")
    return stationary_value(d2, dk.nu)
