"""The host-side block rules of K3'd, K13a and K13c against their definitions, on the CPU.

``kernels/chain.py::slice_split`` sizes a block of K3'd, the sort chain's
slice: its points (a multiple of 4, so every block's slab of slice_idx and
weights starts on 16 bytes; slabs within SLICE_SLAB_BYTES of shared memory)
and its threads (its points * c elements in whole warps).  No output bit
depends on it.  ``kernels/ski.py::_gram_split`` cuts K13c's rows into chunks
of whole stages, one wave of blocks over the card; the kernel sums each chunk
into its own partial and adds the partials in chunk order, so the chunks must
cover every row once: the chunked sum of the plain version in that order
stays within rel 1e-6 of the unchunked one (float32 sums in another order).
``kernels/ski.py::interp_split`` gives a K13a block its lanes a point (each
lane sums four columns, so 4 lanes must reach r; a power of two, so the
teams tile the block's warps) and its shared memory (the grid factor's rows
padded to a multiple of 4 floats, and a pass's taps).
"""

import numpy as np
import pytest
import torch

from simplex_gp_torch.kernels import chain as KC
from simplex_gp_torch.kernels import ski as KS

# (n, d+1, c, SMs): houseelectric at the eval and training widths, elevators, the card tests' edges
# (n = 1, a slab past the compiled widths, slabs that cap the points) on an H100 SXM (132 SMs) and PCIe (114).
SLICE_CASES = [(1311539, 12, 1, 132), (1311539, 12, 11, 132), (10623, 19, 11, 132), (10623, 19, 1, 132),
               (10623, 19, 11, 114), (1, 2, 1, 132), (1, 40, 17, 132), (1001, 20, 17, 132),
               (70001, 20, 17, 132), (70001, 40, 1, 132), (300, 64, 100, 114), (5000, 12, 300, 132)]


@pytest.mark.parametrize("n,dp1,c,sms", SLICE_CASES)
def test_slice_split_follows_its_definition(n, dp1, c, sms):
    points, threads = KC.slice_split(n, dp1, c, sms)
    most = min(KC.SLICE_POINTS, KC.SLICE_SLAB_BYTES // (8 * dp1) // 4 * 4)
    assert points % 4 == 0 and 4 <= points <= most
    assert 8 * points * dp1 <= KC.SLICE_SLAB_BYTES
    grid = -(-n // points)
    # the fewest points that keep the grid within SLICE_BLOCKS_PER_SM blocks an SM, unless the slab caps them
    assert points == most or grid <= KC.SLICE_BLOCKS_PER_SM * sms
    assert points == 4 or -(-n // (points - 4)) > KC.SLICE_BLOCKS_PER_SM * sms
    assert threads % 32 == 0 and 32 <= threads <= KC.SLICE_THREADS
    assert threads == min(KC.SLICE_THREADS, 32 * -(-(points * c) // 32))


def test_slice_split_takes_the_main_paths_widths_in_full_blocks():
    """Houseelectric fills blocks of SLICE_POINTS = 96 points, 96 threads at c = 1 and 256 at c = 11;
    elevators spreads 10,623 points over 242 blocks of 44."""
    assert KC.SLICE_POINTS == 96
    assert KC.slice_split(1311539, 12, 1, 132) == (96, 96)
    assert KC.slice_split(1311539, 12, 11, 132) == (96, 256)
    assert KC.slice_split(10623, 19, 11, 132) == (44, 256)
    assert KC.slice_split(10623, 19, 1, 132) == (44, 64)


def test_slice_split_refuses_rows_past_its_slabs():
    with pytest.raises(ValueError, match="slabs"):
        KC.slice_split(100, KC.SLICE_SLAB_BYTES // 24 + 1, 1, 132)


# (n, r): SKIP's 65,536 and joint 191,231 rows at r = 64, one stage -1 / 0 / +1 row, the edge where a chunk
# grows from one stage to two (511 / 512 / 513), ragged r, n = 0 and a chunk count a-groups leave uneven.
GRAM_CASES = [(65536, 64), (191231, 64), (31, 64), (32, 64), (33, 64), (5, 64), (511, 64), (512, 64), (513, 64),
              (4097, 63), (1000, 5), (0, 64), (65537, 64), (70001, 1), (99999, 44)]


@pytest.mark.parametrize("n,r", GRAM_CASES)
def test_gram_split_covers_every_row_once_in_whole_stages(n, r):
    chunks, rows = KS._gram_split(n, r)
    groups = -(-r // KS._GRAM_A)
    assert rows % KS._GRAM_STAGE == 0 and rows >= KS._GRAM_STAGE
    assert chunks * groups <= KS._GRAM_SLOTS  # one wave
    assert chunks * rows >= n and (chunks == 1 or (chunks - 1) * rows < n)  # every row once, no empty chunk
    want = max(1, min(KS._GRAM_SLOTS // groups, -(-n // KS._GRAM_STAGE)))  # the chunks before whole stages
    assert rows == KS._GRAM_STAGE * max(1, -(-n // (want * KS._GRAM_STAGE))) and chunks <= want


def test_gram_split_at_skips_shapes():
    """Sixteen a-groups by sixteen chunks: 256 blocks, two an SM on 128 of an H100's 132 SMs, the same
    split on every card."""
    assert KS._GRAM_SLOTS == 264
    assert KS._gram_split(65536, 64) == (16, 4096)
    assert KS._gram_split(191231, 64) == (16, 11968)


@pytest.mark.parametrize("n,r,k", [(1000, 5, 7), (4097, 16, 16), (513, 8, 1)])
def test_chunked_gram_in_chunk_order_is_the_gram(n, r, k):
    """K13c's sum as the kernel splits it, each chunk's partial then the partials in chunk order, against the
    plain K13c on all rows at once (float64 reference for both)."""
    rng = np.random.default_rng(n)
    Q, R, F = (torch.from_numpy(rng.normal(size=(n, w)).astype(np.float32)) for w in (k, r, r))
    chunks, rows = KS._gram_split(n, r)
    out = torch.zeros((k, r * r))
    for c in range(chunks):
        s = slice(c * rows, min((c + 1) * rows, n))
        out = out + KS.kr_gram_plain(Q[s], R[s], F[s])
    want = KS.kr_gram_plain(Q.double(), R.double(), F.double())
    assert float((out.double() - want).norm() / want.norm()) < 1e-6
    assert float((KS.kr_gram_plain(Q, R, F).double() - want).norm() / want.norm()) < 1e-6


@pytest.mark.parametrize("g,r", [(100, 64), (100, 32), (100, 33), (9, 5), (40, 3), (1, 1), (100, 4), (300, 64)])
def test_interp_split_follows_its_definition(g, r):
    lanes, smem = KS.interp_split(g, r)
    r4 = -(-r // 4) * 4
    assert lanes & (lanes - 1) == 0 and 4 * lanes >= r and (lanes == 1 or 4 * (lanes // 2) < r4)
    assert 256 % lanes == 0 and lanes <= 32
    assert smem == 4 * (g * r4 + 8 * KS._INTERP_POINTS) and smem <= 227 * 1024
    if (g, r) == (100, 64):  # precipitation's SKIP: 16 lanes a point, a row of 64 floats in 16 float4 stores
        assert (lanes, smem) == (16, 33792)


def test_interp_split_refuses_a_grid_past_a_block():
    with pytest.raises(ValueError, match="does not fit a block"):
        KS.interp_split(1000, 64)
    with pytest.raises(ValueError, match="does not fit a block"):
        KS.interp_split(10, 200)
