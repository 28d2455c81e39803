"""K14, the SLQ quadrature kernel (``csrc/slq.cu``), by a plain transcription of its algorithm, on the CPU.

The kernel runs only on a card (``test_torch_kernels_cuda.py`` holds it there), so this module transcribes
its arithmetic line for line in float64 Python (``_kernel_quadrature``: the leading block up to the first
zero off-diagonal, implicit QL with Wilkinson shifts carrying the first row of the eigenvectors, the clamp)
and holds that to float64 ``numpy.linalg.eigh`` of the dense padded T.  Tolerances, each with its reason:
  * the transcription against float64 eigh: 1e-11 of the quadrature's scale, sum_i z_i^2 |log lambda_i|
    (the scale keeps a sum that cancels to ~0 from failing on rounding), plus 1e-14 ||T|| of its
    sensitivity to the eigenvalues, sum_i z_i^2 / max(|lambda_i|, 1e-10): both methods are backward stable
    in double, so each eigenvalue is off by a few ulps of ||T||, which is a large share of one near 0;
  * a Jacobi matrix built from given eigenvalues and weights, against sum_i w_i log(max(lambda_i, 1e-10)):
    1e-6 of the scale (an eigenvalue carries ~1e-14 ||T|| from the construction and the QL, which is ~2e-6
    of the log of the eigenvalue 1.5e-10 just above the clamp, at ||T|| = 30);
  * on CG records, the gate chip_smoke.py applies on the card: the kernel's float32 output no further from
    the float64 value than twice the float32 eigh path's error, plus one float32 ulp of the value.
The CPU path of ``logdet_from_cg_tridiag`` and ``slq_logdet`` is the float32 ``torch.linalg.eigh`` it
always was, bit for bit, and counts no kernel launch.
"""

import math

import numpy as np
import pytest
import torch

from simplex_gp_torch import trace
from simplex_gp_torch.kernels import slq as KQ
from simplex_gp_torch.linalg import cg as t_cg
from simplex_gp_torch.linalg import lanczos as t_lz

CLAMP = float(np.float32(1e-10))  # torch.clamp(evals, min=1e-10) on float32 eigenvalues
MAX_SWEEPS = 30  # csrc/slq.cu's SLQ_MAX_SWEEPS


def _block_quadrature(d, e):
    """csrc/slq.cu::slq_block_quadrature and slq_sweep in float64, the rotations in the same order and the
    sum in the warp's order; the kernel's rsqrt (the SFU's approximation and two Newton steps) is 1 / sqrt(h)
    here.  Returns (quadrature, most sweeps an eigenvalue took)."""
    d, e = [float(v) for v in d], [float(v) for v in e]
    n = len(d)
    z = [1.0] + [0.0] * (n - 1)
    eps = np.finfo(np.float64).eps
    most = 0
    for l in range(n):
        sweeps = 0
        while True:
            mm = l
            while mm < n - 1 and not abs(e[mm]) <= eps * (abs(d[mm]) + abs(d[mm + 1])):
                mm += 1
            if mm == l:
                break
            sweeps += 1
            most = max(most, sweeps)
            if sweeps > MAX_SWEEPS:
                return math.nan, most
            g = (d[l + 1] - d[l]) / (2.0 * e[l])
            r = math.hypot(g, 1.0)
            g = d[mm] - d[l] + e[l] / (g + math.copysign(r, g))
            s = c = 1.0
            p = 0.0
            vanished = False
            for i in range(mm - 1, l - 1, -1):
                f, b = s * e[i], c * e[i]
                h = f * f + g * g
                if h == 0.0:
                    d[i + 1] -= p
                    e[i + 1] = 0.0
                    e[mm] = 0.0
                    vanished = True
                    break
                t = 1.0 / math.sqrt(h)
                e[i + 1] = h * t
                s, c = f * t, g * t
                g = d[i + 1] - p
                r = (d[i] - g) * s + 2.0 * c * b
                p = s * r
                d[i + 1] = g + p
                g = c * r - b
                zi, zn = z[i], z[i + 1]
                z[i + 1] = s * zi + c * zn
                z[i] = c * zi - s * zn
            if vanished:
                continue
            d[l] -= p
            e[l] = g
            e[mm] = 0.0
    # Each lane's strided partial sum, then the warp's xor butterfly.
    part = [0.0] * 32
    for i in range(n):
        part[i % 32] += z[i] * z[i] * math.log(CLAMP if d[i] < CLAMP else d[i])
    for off in (16, 8, 4, 2, 1):
        part = [part[k] + part[k ^ off] for k in range(32)]
    return part[0], most


def _leading_block(off_row) -> int:
    """The kernel's L: one past the first exactly-zero off-diagonal, or m."""
    zero = np.flatnonzero(np.asarray(off_row) == 0.0)
    return int(zero[0]) + 1 if zero.size else len(off_row) + 1


def _kernel_quadrature(diag, off, dtype=np.float32):
    """The kernel on a (p, m) / (p, m-1) band read as float32 (or ``dtype``): (p,) float64 quadratures before
    the float32 rounding, the block lengths and the most sweeps an eigenvalue took."""
    diag, off = np.asarray(diag, dtype), np.asarray(off, dtype)
    quads, lengths, most = [], [], 0
    for dj, oj in zip(diag, off):
        n = _leading_block(oj)
        e = np.zeros(n, np.float64)
        e[:n - 1] = oj[:n - 1]
        q, sweeps = _block_quadrature(dj[:n].astype(np.float64), e)
        quads.append(q)
        lengths.append(n)
        most = max(most, sweeps)
    return np.array(quads), lengths, most


def _dense(diag_row, off_row) -> np.ndarray:
    return np.diag(diag_row) + np.diag(off_row, 1) + np.diag(off_row, -1)


def _eigh64(diag, off):
    """(p,) quadratures by float64 eigh of the dense padded T, and what each may be off by: 1e-11 of its scale
    sum_i z_i^2 |log lambda_i| (at least 1), plus 1e-14 ||T|| sum_i z_i^2 / max(|lambda_i|, 1e-10)."""
    quads, tols = [], []
    for dj, oj in zip(np.asarray(diag, np.float64), np.asarray(off, np.float64)):
        lam, vec = np.linalg.eigh(_dense(dj, oj))
        w, lg = vec[0] ** 2, np.log(np.maximum(lam, CLAMP))
        quads.append(float((w * lg).sum()))
        tols.append(1e-11 * max(1.0, float((w * np.abs(lg)).sum()))
                    + 1e-14 * np.abs(lam).max() * float((w / np.maximum(np.abs(lam), CLAMP)).sum()))
    return np.array(quads), np.array(tols)


def _random_band(p, m, seed):
    """SPD tridiagonals over three decades: diagonals in [0.5, 1.5] times 10^U(-1, 2), couplings below half
    the smaller neighbour (diagonally dominant)."""
    rng = np.random.default_rng(seed)
    diag = rng.uniform(0.5, 1.5, size=(p, m)) * 10.0 ** rng.uniform(-1, 2, size=(p, m))
    off = rng.uniform(-0.49, 0.49, size=(p, m - 1)) * np.minimum(diag[:, 1:], diag[:, :-1])
    return diag.astype(np.float32), off.astype(np.float32)


def _jacobi(evals, weights):
    """The (diag, off) of the Jacobi matrix with these eigenvalues and first-component weights: Lanczos in
    float64 with full reorthogonalisation on diag(evals) from sqrt(weights)."""
    lam = np.asarray(evals, np.float64)
    q = np.sqrt(np.asarray(weights, np.float64))
    q = q / np.linalg.norm(q)
    Q, alphas, betas = [q], [], []
    for k in range(lam.size):
        v = lam * Q[-1]
        alphas.append(float(Q[-1] @ v))
        for _ in range(2):
            v = v - np.stack(Q, 1) @ (np.stack(Q, 1).T @ v)
        if k + 1 < lam.size:
            betas.append(float(np.linalg.norm(v)))
            Q.append(v / betas[-1])
    return np.array(alphas), np.array(betas)


def _spd(n, seed, evals):
    Qm, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(n, n)))
    return ((Qm * evals) @ Qm.T).astype(np.float32)


def _cg_band(A, p, m, seed, **kw):
    """A CG record's band (float32 (p, m), (p, m-1)) from the port's cg_solve on A with Rademacher columns."""
    z = np.random.default_rng(seed).choice([-1.0, 1.0], size=(A.shape[0], p)).astype(np.float32)
    tA = torch.from_numpy(A)
    res = t_cg.cg_solve(lambda v: tA @ v, torch.from_numpy(z), tridiag_m=m, **kw)
    diag, off = KQ.cg_band(res.alphas, res.betas, res.tmask)
    return diag.numpy(), off.numpy(), res


def _assert_close(diag, off):
    got, lengths, most = _kernel_quadrature(diag, off)
    want, tol = _eigh64(diag, off)
    assert np.all(np.abs(got - want) <= tol), (got, want, tol)
    assert most <= 10  # far inside the sweep limit
    return got, lengths


@pytest.mark.parametrize("L", [1, 2, 22, 100])
def test_transcription_matches_float64_eigh_on_random_spd_tridiagonals(L):
    diag, off = _random_band(3, L, seed=L)
    _, lengths = _assert_close(diag, off)
    assert lengths == [L] * 3


def test_cg_records_with_dead_step_padding():
    """The CG stops long before its record fills: identity padding after the live steps, cut by the kernel."""
    A = _spd(96, 9, np.geomspace(1.0, 5.0, 96))
    diag, off, res = _cg_band(A, 6, 80, 17, tol=1e-6, max_iters=80)
    assert not bool(res.tmask.all())
    _, lengths = _assert_close(diag, off)
    live = res.tmask.numpy().sum(axis=0)
    assert lengths == [int(v) for v in live] and max(lengths) < 80


def test_a_mask_that_is_not_a_prefix():
    """A dead step between live ones: the block ends there, the live steps after it weigh nothing."""
    A = _spd(60, 3, np.geomspace(1.0, 50.0, 60))
    z = np.random.default_rng(5).choice([-1.0, 1.0], size=(60, 2)).astype(np.float32)
    res = t_cg.cg_solve(lambda v: torch.from_numpy(A) @ v, torch.from_numpy(z), tol=1e-8, max_iters=30,
                        min_iters=30, tridiag_m=30)
    tmask = res.tmask.clone()
    tmask[7, 0] = False
    tmask[12, 1] = False
    diag, off = (t.numpy() for t in KQ.cg_band(res.alphas, res.betas, tmask))
    _, lengths = _assert_close(diag, off)
    assert lengths == [7, 12]
    assert (off[0, 7:] != 0).any()  # live couplings after the hole, outside the block


def test_a_zero_off_diagonal_between_live_steps():
    """beta exactly 0 at a live step (a Lanczos breakdown): T splits there, exactly."""
    diag, off = _random_band(2, 40, seed=3)
    off[0, 9] = 0.0
    off[1, 0] = 0.0
    _, lengths = _assert_close(diag, off)
    assert lengths == [10, 1]


def test_near_duplicate_eigenvalues():
    """Wilkinson's W21+ (pairs of eigenvalues equal to ~1e-14) and a 100-step CG record whose Ritz values
    repeat as the CG loses orthogonality."""
    w = np.abs(np.arange(21, dtype=np.float64) - 10.0)
    lam = np.linalg.eigvalsh(_dense(w, np.ones(20)))
    assert np.diff(lam)[-1] < 1e-12 * lam[-1]  # the fixture's top pair
    _assert_close(w[None].astype(np.float32), np.ones((1, 20), np.float32))

    evals = np.concatenate([np.geomspace(1e-2, 1.0, 190), [50.0, 80.0, 100.0, 200.0, 400.0, 1000.0, 1e3 + 1e-2,
                                                            2e3, 3e3, 4e3]])
    A = _spd(200, 11, evals)
    diag, off, res = _cg_band(A, 2, 100, 23, tol=1e-30, max_iters=100, min_iters=100)
    assert bool(res.tmask.all())
    ritz = np.linalg.eigvalsh(_dense(diag[0].astype(np.float64), off[0].astype(np.float64)))
    assert (np.diff(ritz) / ritz[1:]).min() < 1e-6  # a ghost copy of a converged Ritz value
    _, lengths = _assert_close(diag, off)
    assert lengths == [100, 100]


def test_eigenvalues_at_the_clamp():
    """Eigenvalues below, at and above 1e-10, one negative (f32 Lanczos can give one): each clamped."""
    evals = [-1e-4, 1e-12, 3e-11, 1.5e-10, 1e-6, 0.5, 2.0, 30.0]
    weights = [0.2, 0.1, 0.15, 0.1, 0.05, 0.2, 0.1, 0.1]
    diag, off = _jacobi(evals, weights)
    lg = np.log(np.maximum(evals, CLAMP))
    want, scale = float(np.dot(weights, lg)), float(np.dot(weights, np.abs(lg)))
    got, lengths, _ = _kernel_quadrature(diag[None], off[None], np.float64)  # the algorithm on the exact band
    assert lengths == [8] and abs(got[0] - want) <= 1e-6 * scale
    # Read in float32, the band moves each eigenvalue by ~1e-7 ||T||, so the smallest land on both sides of
    # the clamp: against float64 eigh of the float32 band.
    _assert_close(diag[None].astype(np.float32), off[None].astype(np.float32))


def test_leading_block_quadrature_equals_the_padded_matrix():
    """e1's block alone gives the padded matrix's quadrature: float64 eigh of both."""
    diag, off = _random_band(1, 50, seed=8)
    off[0, 19] = 0.0  # a second coupled block after the first
    diag[0, 35:] = 1.0
    off[0, 34:] = 0.0  # identity padding, as a CG record's dead steps
    full, _ = _eigh64(diag, off)
    block, tol = _eigh64(diag[:, :20], off[:, :19])
    assert abs(full[0] - block[0]) <= tol[0]
    got, lengths = _assert_close(diag, off)
    assert lengths == [20] and abs(got[0] - block[0]) <= tol[0]


def test_transcription_is_no_further_from_float64_than_float32_eigh():
    """The card gate's rule on CG records: per probe, the float32-rounded output within twice the float32 eigh
    path's error of the float64 value, plus one float32 ulp."""
    for A, seed in ((_spd(150, 2, np.geomspace(0.1, 30.0, 150)), 31), (_spd(120, 4, np.geomspace(1.0, 1e3, 120)), 37)):
        diag, off, _ = _cg_band(A, 5, 100, seed, tol=1e-5, max_iters=100)
        got = _kernel_quadrature(diag, off)[0].astype(np.float32).astype(np.float64)
        want, _ = _eigh64(diag, off)
        f32 = KQ.slq_quadrature_plain(torch.from_numpy(diag), torch.from_numpy(off)).numpy().astype(np.float64)
        ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
        assert np.all(np.abs(got - want) <= 2.0 * np.abs(f32 - want) + ulp), (got, want, f32)


def test_a_nan_in_the_band_gives_nan():
    diag, off = _random_band(2, 12, seed=4)
    diag[0, 5] = np.nan
    off[1, 2] = np.nan
    got, _, most = _kernel_quadrature(diag, off)
    assert np.isnan(got).all() and most == MAX_SWEEPS + 1


def test_the_cpu_path_is_the_float32_eigh_bit_for_bit_and_counts_no_launch():
    """logdet_from_cg_tridiag and slq_logdet on CPU tensors: today's dense float32 eigh, no K14 launch."""
    A = _spd(96, 9, np.geomspace(1.0, 5.0, 96))
    z = torch.from_numpy(np.random.default_rng(1).choice([-1.0, 1.0], size=(96, 8)).astype(np.float32))
    res = t_cg.cg_solve(lambda v: torch.from_numpy(A) @ v, z, tol=1e-6, max_iters=60, tridiag_m=60)
    z2 = (z * z).sum(0)
    diag, off = KQ.cg_band(res.alphas, res.betas, res.tmask)
    launches = KQ.slq_quadrature.launches
    trace.clear()
    with trace.recording():
        got = t_lz.logdet_from_cg_tridiag(res.alphas, res.betas, res.tmask, z2)
        lz = t_lz.lanczos(lambda v: torch.from_numpy(A) @ v, z, 20)
        got_l = t_lz.slq_logdet(lambda v: torch.from_numpy(A) @ v, z, 20)
    assert "slq.kernel" not in trace.counters() and KQ.slq_quadrature.launches == launches
    trace.clear()

    def eigh_path(T):  # the port's quadrature before K14 (and JAX's, lanczos.py:128-132)
        evals, evecs = torch.linalg.eigh(T)
        return (evecs[:, 0, :] ** 2 * torch.log(torch.clamp(evals, min=1e-10))).sum(dim=-1)

    assert torch.equal(got, (z2 * eigh_path(t_lz.tridiag_matrices(diag, off))).mean())
    assert torch.equal(got_l, (z2 * eigh_path(t_lz.tridiag_matrices(lz.alphas, lz.betas))).mean())
    assert torch.equal(KQ.slq_quadrature(diag, off), KQ.slq_quadrature_plain(diag, off))
