"""Host constants of the PyTorch port equal the JAX package's, bit for bit.

The port copies the numpy-only pieces (coefficient search, lattice
constants, datasets) because ``simplex_gp_tpu`` cannot be imported without
jax; these tests hold each copy to its original.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplex_gp_torch.kernels import chain as t_chain
from simplex_gp_torch.ops import coeffs as t_coeffs
from simplex_gp_torch.ops import kernels as t_kernels
from simplex_gp_torch.ops import lattice as t_lattice
from simplex_gp_torch.utils import data as t_data
from simplex_gp_tpu.ops import coeffs as j_coeffs
from simplex_gp_tpu.ops import kernels as j_kernels
from simplex_gp_tpu.ops import lattice as j_lattice
from simplex_gp_tpu.utils import data as j_data

DIMS = [1, 2, 3, 5, 9, 17, 18]


@pytest.mark.parametrize("d", DIMS)
def test_lattice_constants_equal(d):
    dk = j_kernels.matern_kernel(1.5, 1)
    np.testing.assert_array_equal(t_lattice.build_rotation(d, dk.variance),
                                  j_lattice.build_rotation(d, dk.variance))
    np.testing.assert_array_equal(t_lattice._canonical_simplex(d), j_lattice._canonical_simplex(d))
    np.testing.assert_array_equal(t_lattice._hash_vectors(d), j_lattice._hash_vectors(d))
    for order in (1, 2, 3):
        np.testing.assert_array_equal(t_lattice._axis_offsets(d, order),
                                      j_lattice._axis_offsets(d, order))
    assert t_lattice.SLICE_NORM(d) == j_lattice.SLICE_NORM(d)


@pytest.mark.parametrize("d,order", [(2, 1), (5, 2), (18, 3)])
def test_offset_hashes_match_plan_tables(d, order):
    """The port's offset hashes are _plan_tables' (lattice.py:414-418)."""
    a = j_lattice._hash_vectors(d)
    offsets = j_lattice._axis_offsets(d, order).astype(np.int64)
    a64 = a.astype(np.int64)
    wrap = lambda h: ((h & 0xFFFFFFFF).astype(np.uint32)).view(np.int32)
    oh1, oh2 = t_lattice._offset_hashes(d, order, a)
    np.testing.assert_array_equal(oh1, wrap((offsets * a64[0]).sum(-1)))
    np.testing.assert_array_equal(oh2, wrap((offsets * a64[1]).sum(-1)))


@pytest.mark.parametrize("order", [1, 2, 3])
def test_kernel_taps_equal(order):
    for t_dk, j_dk in (
        (t_kernels.rbf_kernel(order), j_kernels.rbf_kernel(order)),
        (t_kernels.matern_kernel(1.5, order), j_kernels.matern_kernel(1.5, order)),
        (t_kernels.matern_kernel(2.5, order), j_kernels.matern_kernel(2.5, order)),
    ):
        assert t_dk.coeffs == j_dk.coeffs
        assert t_dk.deriv_coeffs == j_dk.deriv_coeffs
        assert (t_dk.variance, t_dk.deriv_variance, t_dk.dk0, t_dk.nu) == (
            j_dk.variance, j_dk.deriv_variance, j_dk.dk0, j_dk.nu)


@pytest.mark.parametrize("kind,nu", [("rbf", 0.0), ("matern", 1.5), ("matern", 2.5)])
def test_kernel_value_matches_jax(kind, nu):
    """The exact kernel behind the preconditioner's columns (kernel_value_jnp)."""
    d2 = np.concatenate([[0.0, 1e-12], np.geomspace(1e-6, 40.0, 200)]).astype(np.float32)
    order = 1
    t_dk = t_kernels.rbf_kernel(order) if kind == "rbf" else t_kernels.matern_kernel(nu, order)
    j_dk = j_kernels.rbf_kernel(order) if kind == "rbf" else j_kernels.matern_kernel(nu, order)
    ours = t_kernels.kernel_value(t_dk, torch.from_numpy(d2)).numpy()
    np.testing.assert_allclose(ours, np.asarray(j_kernels.kernel_value_jnp(j_dk, jnp.asarray(d2))),
                               rtol=1e-6, atol=1e-7)


def test_coeffs_module_is_a_verbatim_copy():
    for name in j_coeffs.__all__:
        assert getattr(t_coeffs, name).__code__.co_code == getattr(j_coeffs, name).__code__.co_code
    assert t_coeffs.tap_variance([0.5, 1.0, 0.5]) == j_coeffs.tap_variance([0.5, 1.0, 0.5])


def test_elevators_data_equal():
    t = t_data.prepare_dataset(t_data.load_uci("elevators"), "elevators")
    j = j_data.prepare_dataset(j_data.load_uci("elevators"), "elevators")
    for a, b in zip(t[:6], j[:6]):
        np.testing.assert_array_equal(a, b)
    assert t.train_x.shape == (10623, 18) and t.test_x.shape == (3320, 18)
    assert t_data.UCI_SHAPES == j_data.UCI_SHAPES


@pytest.mark.parametrize("d", DIMS)
def test_chain_constants_equal(d):
    """The sort chain's packing constants, axis directions and per-axis chain-word constants."""
    for name in ("_S_BITS", "_S_BIAS", "_S_MASK", "_TOP_MASK", "_PAD_H1", "_PAD_H2"):
        ours, theirs = getattr(t_lattice, name), getattr(j_lattice, name)
        assert ours == theirs and type(ours) is type(theirs), name
    assert (t_chain._S_BIAS, t_chain._S_MASK, t_chain._TOP_MASK) == (
        int(j_lattice._S_BIAS), int(j_lattice._S_MASK), int(j_lattice._TOP_MASK))
    for ours, theirs in zip(t_lattice._axis_dir(d), j_lattice._axis_dir(d)):
        np.testing.assert_array_equal(ours, theirs)
    oh1, oh2, mult = j_lattice._axis_hash_consts(d)  # _chain_words' oh1, oh2, mult for every axis
    consts = t_lattice._chain_consts(d)
    assert consts.dtype == np.int32
    np.testing.assert_array_equal(consts, np.array([oh1, oh2, mult], np.int32))


@pytest.mark.parametrize("d", [1, 5, 18])
def test_chain_keys_pack_jax_chain_words(d):
    """The port's int64 sort key holds JAX's chain word c1 over its packed word (_pack, :638) with the
    sign bit flipped, for every axis, on wrapping hashes and clipped coordinate sums."""
    rng = np.random.default_rng(d)
    N = 4096
    h1 = rng.integers(-2**31, 2**31, size=N, dtype=np.int64).astype(np.int32)
    h2 = rng.integers(-2**31, 2**31, size=N, dtype=np.int64).astype(np.int32)
    s = np.concatenate([rng.integers(-3000, 3000, size=N - 4), [-2**21, 2**21, -2**20, 2**20 - 1]]).astype(np.int32)
    c1, c2 = j_lattice._chain_words(jnp.asarray(h1), jnp.asarray(h2), jnp.asarray(s), np.arange(d + 1), d)
    packed = np.asarray(j_lattice._pack(c2, jnp.asarray(s)[None, :]))
    oh1, oh2, mult = (torch.from_numpy(r).long()[:, None] for r in t_lattice._chain_consts(d))
    h1t, h2t, st = (torch.from_numpy(a).long()[None, :] for a in (h1, h2, s))
    key = t_chain._key(mult * h1t - st * oh1, mult * h2t - st * oh2, st.expand(d + 1, N)).numpy()
    np.testing.assert_array_equal((key >> 32).astype(np.int32), np.asarray(c1))
    np.testing.assert_array_equal(((key & 0xFFFFFFFF) ^ 0x80000000).astype(np.uint32).view(np.int32), packed)


def test_chain_plan_refuses_asymmetric_taps():
    taps = (0.2, 1.0, 0.5)
    x = np.random.default_rng(0).normal(size=(16, 2)).astype(np.float32)
    with pytest.raises(ValueError, match="symmetric"):
        j_lattice.build_plan_chain(jnp.asarray(x), taps, 0.5)
    with pytest.raises(ValueError, match="chain plan requires symmetric filter taps"):
        t_lattice.build_plan_chain(torch.from_numpy(x), taps, 0.5)
