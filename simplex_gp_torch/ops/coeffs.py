"""Filter-coefficient search for discretized stationary kernels.

Given a stationary, isotropic kernel k(tau) (a function of distance) and a
filter order r, the lattice filter approximates the kernel with a separable
(2r+1)-tap blur.  The tap values are samples of k at spacing ``s``, where
``s`` is chosen so that the *spatial* coverage of the sampled window matches
the *spectral* coverage below the Nyquist frequency -- i.e. the discretization
wastes neither spatial nor frequency resolution.

Behavioral parity target: reference ``gpytorch_lattice_kernel/
bilateral_kernel.py:14-56`` (``get_coeffs`` / ``coverage_diff`` /
``binary_search``).  This implementation is pure numpy (it runs once per
kernel construction, on host) and takes numpy-callable kernel functions.
"""

from __future__ import annotations

import logging
from typing import Callable

import numpy as np

__all__ = ["get_coeffs", "coverage_diff", "binary_search", "tap_variance"]

log = logging.getLogger(__name__)

_N_SAMPLES = 10**4
_HALF_WIDTH = 30.0


def coverage_diff(
    spacing: float,
    order: int,
    x: np.ndarray,
    w: np.ndarray,
    fn_values: np.ndarray,
    fft_values: np.ndarray,
) -> float:
    """Spatial-minus-spectral coverage of a (2*order+1)-tap sampling at ``spacing``.

    Spatial coverage: fraction of the kernel's mass inside the sampled window
    [-s*(2r+1)/2, s*(2r+1)/2].  Spectral coverage: fraction of |FFT| mass
    inside the Nyquist band [-pi/s, pi/s].  Monotone decreasing in ``spacing``
    minus monotone increasing => a single zero crossing.
    """
    k = 2 * order + 1
    a = spacing * k / 2.0
    nyquist_w = np.pi / spacing
    spatial = fn_values[(-a <= x) & (x <= a)].sum() / fn_values.sum()
    spectral = fft_values[(-nyquist_w <= w) & (w <= nyquist_w)].sum() / fft_values.sum()
    log.debug("coverage: spatial %.4f spectral %.4f (s=%.5f)", spatial, spectral, spacing)
    return spatial - spectral


def binary_search(
    target: float,
    bounds: tuple[float, float],
    fn: Callable[[float], float],
    eps: float = 1e-2,
    max_iters: int = 500,
) -> float:
    """Find x with fn(x) == target for monotone-increasing fn, to eps precision."""
    lb, ub = bounds
    i = 0
    while ub - lb > eps:
        guess = 0.5 * (ub + lb)
        y = fn(guess)
        if y < target:
            lb = guess
        else:
            ub = guess
        i += 1
        if i > max_iters:
            raise RuntimeError("binary_search failed to converge")
    return 0.5 * (ub + lb)


def get_coeffs(kernel_fn: Callable[[np.ndarray], np.ndarray], order: int) -> np.ndarray:
    """Optimal (2*order+1) filter taps for a stationary kernel function of distance.

    ``kernel_fn`` maps distance tau (numpy array) -> kernel value.  The
    returned taps are ``k(s * [-r..r])`` normalized by the center value
    (so taps[order] == 1 even for sign-flipped derivative kernels).
    """
    n = _N_SAMPLES
    x = np.linspace(-_HALF_WIDTH, _HALF_WIDTH, n)
    fn_values = np.asarray(kernel_fn(x), dtype=np.float64)
    w = 2 * np.pi * np.fft.fftfreq(n, 2 * _HALF_WIDTH / n)
    fft_values = np.absolute(np.fft.fft(fn_values) / (2 * np.pi * np.sqrt(n)))

    def obj(s: float) -> float:
        return coverage_diff(s, order, x, w, fn_values, fft_values)

    s = binary_search(0.0, (0.1, 9.0), obj, eps=1e-4)
    taps = np.asarray(kernel_fn(s * np.arange(-order, order + 1, dtype=np.float64)))
    return (taps / taps[order]).astype(np.float32)


def tap_variance(coeffs: np.ndarray) -> float:
    """Discrete second central moment of the filter taps.

    Used to calibrate the lattice spacing so the total blur variance matches
    the kernel's (reference: ``cpp/permutohedral.h:203-219`` ``variance`` and
    its use at ``:388-389``).
    """
    c = np.asarray(coeffs, dtype=np.float64)
    i = np.arange(c.shape[0], dtype=np.float64)
    mom0 = c.sum()
    mean = (i * c).sum() / mom0
    return float((i * i * c).sum() / mom0 - mean * mean)
