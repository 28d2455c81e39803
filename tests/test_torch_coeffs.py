"""Ports of tests/test_coeffs.py: the coefficient search and the discretized kernels, on the port.

``simplex_gp_torch/ops/coeffs.py`` is a verbatim copy of the JAX module
(test_torch_constants.py holds it so), and these are the JAX tests' checks
of its behaviour, run on the port's modules with the same bounds.
"""

import numpy as np

from simplex_gp_torch.ops import coeffs as C
from simplex_gp_torch.ops import kernels as K


def test_rbf_coeffs_shape_and_normalization():
    for order in (1, 2, 3):
        taps = np.asarray(K.rbf_kernel(order).coeffs)
        assert taps.shape == (2 * order + 1,)
        assert taps[order] == 1.0  # center-normalized
        np.testing.assert_allclose(taps, taps[::-1], rtol=1e-6)  # symmetric
        assert np.all(np.diff(taps[: order + 1]) > 0)  # increasing toward the center


def test_coverage_diff_monotone_crossing():
    """The binary-search objective crosses zero exactly once within its bounds."""
    n = 10**4
    x = np.linspace(-30, 30, n)
    fn = np.exp(-(x**2))
    w = 2 * np.pi * np.fft.fftfreq(n, 60 / n)
    fftv = np.absolute(np.fft.fft(fn) / (2 * np.pi * np.sqrt(n)))
    assert C.coverage_diff(0.1, 2, x, w, fn, fftv) < 0 < C.coverage_diff(5.0, 2, x, w, fn, fftv)


def test_matern_coeffs_positive_and_deriv_sign():
    dk = K.matern_kernel(nu=1.5, order=3)
    assert np.all(np.asarray(dk.coeffs) > 0)
    np.testing.assert_allclose(dk.dk0, -1.5, rtol=1e-6)  # dk/d(d^2) at 0 for nu = 1.5
    np.testing.assert_allclose(K.rbf_kernel(2).dk0, -1.0, rtol=1e-6)


def test_tap_variance_matches_dense_moment():
    # mean 1, E[i^2] = (0 * .25 + 1 + 4 * .25) / 1.5 = 4/3, so the variance is 1/3
    np.testing.assert_allclose(C.tap_variance(np.array([0.25, 1.0, 0.25])), 1.0 / 3.0, rtol=1e-12)


def test_discretized_kernel_is_hashable_and_cached():
    """Port of test_discretized_kernel_is_hashable_static_arg: hashable, one object per order."""
    dk = K.rbf_kernel(1)
    hash(dk)
    assert dk is K.rbf_kernel(1)
    hash(K.mixture_kernel(1.5, 1))
    assert K.mixture_kernel(1.5, 1) is K.mixture_kernel(1.5, 1)
