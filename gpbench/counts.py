"""The yardstick: the chip's peaks, and the bytes and float operations that the algorithm needs.

Frozen copies of chip_smoke.py's formulas (the line of each beside it), in
shape arguments, and their sums over one training step, one posterior fit
and one predict request.  Each input is counted read once and each output
written once; operations are float32 operations.  They count what the
algorithm needs at these shapes whatever implements it, so a later change
that removes a kernel still faces the same least time.
"""

from __future__ import annotations

# One NVIDIA H100 SXM at its full 700 W (NVIDIA's data sheet; chip_smoke.py:497-498).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def least_s(nbytes: float, ops: float) -> float:
    """The larger of bytes over the memory rate and operations over the float32 rate (chip_smoke.py:569)."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def geometry_cost(n: int, d: int) -> tuple:
    """K1 with the coordinate sums: x in; two hashes, s and a weight a vertex out (PERF.md section 6, K1's
    bytes 4nd + 16n(d+1)); the per-point operations of chip_smoke.py:587 (geometry_ops)."""
    return 4 * n * d + 16 * n * (d + 1), n * (d + 1) * (3 * d + 9)


def chain_build_cost(N: int, live: int, d: int, order: int) -> tuple:
    """K3'a (chip_smoke.py:3365): h1, h2, s, w in; splat points, weights, slice_idx out; cnt, gathers and
    taps of the live rows out."""
    return 4 * (4 * N + 3 * N + live * (1 + d + (d + 1) * order)), 0


def dedup_bytes(N: int, M: int, dp1: int, order: int) -> int:
    """K2 (chip_smoke.py:600): the N hash pairs in, the N seg ids and the (d+1, M, 2r) neighbours out."""
    return 4 * (2 * N + N + dp1 * M * 2 * order)


def rows_bytes(N: int, M: int) -> int:
    """The join rows (chip_smoke.py:605): seg ids and weights in; points, weights and run ends out."""
    return 4 * (4 * N + M)


def apply_cost(n: int, d: int, c: int, n_lattice: int, order: int) -> tuple:
    """K3 / K9, a join apply (chip_smoke.py:592)."""
    N = n * (d + 1)
    nbytes = 4 * (2 * N + (d + 1) * n_lattice * 2 * order + 2 * n * c)
    return nbytes, 4 * N * c + 2 * (2 * order + 1) * (d + 1) * n_lattice * c + n * c


def splat_cost(N: int, n: int, c: int, live: int) -> tuple:
    """K3'b (chip_smoke.py:3357): the plan's points and weights and v (n, c) in, the live table out."""
    return 4 * (2 * N + live + n * c + live * c), 2 * N * c


def axes_cost(nl: int, d: int, c: int, order: int) -> tuple:
    """K3'c, the d+1 axes as one function (chip_smoke.py:4232)."""
    return 4 * (2 * nl * c + (d + 1) * order * nl + d * nl), (d + 1) * 2 * (2 * order + 1) * nl * c


def axes_transpose_cost(nl: int, d: int, c: int, order: int) -> tuple:
    """K3'c transposed with its d+1 maps (PERF.md section 6, K3'c-T's bytes 4(2 nl c + (d+1) r nl + (d+1) nl))."""
    return 4 * (2 * nl * c + (d + 1) * order * nl + (d + 1) * nl), (d + 1) * 2 * (2 * order + 1) * nl * c


def slice_cost(n: int, dp1: int, c: int, live: int) -> tuple:
    """K3'd (chip_smoke.py:3418): the live table, slice_idx and weights in, the (n, c) output out."""
    return 4 * (live * c + 2 * n * dp1 + n * c), 2 * n * dp1 * c


def k5_cost(n: int, d: int, c: int, n_lattice: int) -> tuple:
    """K5 (chip_smoke.py:580): ref, seg ids, v, g and both tables' live rows in, grad_ref out."""
    N = n * (d + 1)
    return 4 * (2 * n * d + N + 2 * n * c + 2 * min(n_lattice, N) * c), 4 * N * c + N * (3 * d + 1)


def factor_cost(n: int, dim: int, k: int) -> tuple:
    """K6's rank-k factor (chip_smoke.py:4226): per pivot j, ref and L[:, :j] read, the diagonal read and
    written, L[:, j] written."""
    return sum(4 * n * (dim + j + 3) for j in range(k)), sum(n * (3 * dim + 2 * j + 12) for j in range(k))


def cg_iteration_bytes(n: int, c: int, k: int) -> int:
    """K10, one CG iteration's vector work and the Woodbury solve's two reads of U (chip_smoke.py:611)."""
    return 4 * (17 * n * c + 2 * n * k)


def _add(*costs) -> tuple:
    return sum(c[0] for c in costs), sum(c[1] for c in costs)


def chain_mvm_cost(n: int, d: int, c: int, nl: int, N: int, order: int) -> tuple:
    """One chain apply (K3'b-d) at c columns over n points and N contributions."""
    return _add(splat_cost(N, n, c, nl), axes_cost(nl, d, c, order), slice_cost(n, d + 1, c, nl))


def precond_cost(n: int, k: int) -> tuple:
    """The preconditioner from L (n, k): L^T L, U = L V, U^T U twice, the polish (n k^2 products each), the
    k x k eigh twice; L read, U written and read."""
    return 4 * 7 * n * k, 10 * n * k * k + 2 * 9 * k ** 3


def woodbury_cost(n: int, k: int, t: int) -> tuple:
    """One pass of P^{+-1/2} or P^{-1} over (n, t): U^T V and U G, U read twice, V in, the result out."""
    return 4 * (2 * n * k + 2 * n * t), 4 * n * k * t + 3 * n * t


def qr_cost(n: int, m: int) -> tuple:
    """Householder QR with Q formed, (n, m): 4 n m^2 operations, the matrix read and Q written."""
    return 4 * 2 * n * m, 4 * n * m * m


def gemm_cost(n: int, m: int, k: int) -> tuple:
    """(n, k) @ (k, m): 2 n m k operations, both inputs read, the output written."""
    return 4 * (n * k + k * m + n * m), 2 * n * m * k


def train_step_cost(n: int, d: int, nl: int, iters: int, k: int, p: int, order: int, capacity: int) -> tuple:
    """One training step: the chain plan, the factor and preconditioner, P^{1/2} of the probes, the CG's
    iterations (an MVM at c = p + 1 and K10's work each, one more preconditioning at the start), the SLQ
    quadrature (p tridiagonal eighs of the CG's record), P^{-1} of the probes, the exact backward (an
    apply with its table, the transposed apply, K5, the two sums), at n points of dimension d."""
    c, N = p + 1, n * (d + 1)
    live = min(nl, capacity)
    m = min(iters, 100)
    mvm = chain_mvm_cost(n, d, c, live, N, order)
    mvm_t = _add(splat_cost(N, n, c, live), axes_transpose_cost(live, d, c, order), slice_cost(n, d + 1, c, live))
    return _add(geometry_cost(n, d), chain_build_cost(N, live, d, order), factor_cost(n, d, k), precond_cost(n, k),
                woodbury_cost(n, k, p), *([mvm] * iters),
                (cg_iteration_bytes(n, c, k) * (iters + 1), (4 * n * k * c + 20 * n * c) * (iters + 1)),
                (4 * p * m * m, 9 * p * m ** 3), woodbury_cost(n, k, p), mvm, mvm_t, k5_cost(n, d, c, live),
                (4 * 3 * n * c, 4 * n * c))


def fit_cost(n: int, d: int, nt: int, nl: int, nl_rect: int, iters: int, k: int, m: int, order: int) -> tuple:
    """One posterior fit below the join threshold: the CG's chain plan, the factor and preconditioner, the
    eval CG at c = 1, the sketch's join plan and rows, its two applies at c = m, the QR, T, the eigh and the
    root; then the predict: the join plan and rows over [train; test] and one apply at c = 1 + m, the
    variances."""
    N, Nr = n * (d + 1), (n + nt) * (d + 1)
    return _add(geometry_cost(n, d), chain_build_cost(N, nl, d, order), factor_cost(n, d, k), precond_cost(n, k),
                *([chain_mvm_cost(n, d, 1, nl, N, order)] * iters),
                (cg_iteration_bytes(n, 1, k) * (iters + 1), (4 * n * k + 20 * n) * (iters + 1)),
                geometry_cost(n, d), (dedup_bytes(N, N, d + 1, order) + rows_bytes(N, N), 0),
                apply_cost(n, d, m, nl, order), apply_cost(n, d, m, nl, order), qr_cost(n, m), gemm_cost(m, m, n),
                (4 * m * m, 9 * m ** 3), gemm_cost(n, m, m),
                geometry_cost(n + nt, d), (dedup_bytes(Nr, Nr, d + 1, order) + rows_bytes(Nr, Nr), 0),
                apply_cost(n + nt, d, 1 + m, nl_rect, order), (4 * nt * (m + 2), 2 * nt * m))


def predict_cost(n: int, d: int, b: int, nl_rect: int, m: int, order: int, block: int = 16) -> tuple:
    """One predict above the join threshold: K1 and the untrimmed chain plan over [train; batch], the
    1 + m columns in blocks of ``block`` (each block's apply, copied in and out), the variances."""
    nn_ = n + b
    N = nn_ * (d + 1)
    blocks = [min(block, 1 + m - c0) for c0 in range(0, 1 + m, block)]
    return _add(geometry_cost(nn_, d), chain_build_cost(N, nl_rect, d, order),
                *(chain_mvm_cost(nn_, d, c, nl_rect, N, order) for c in blocks),
                (4 * 2 * nn_ * (1 + m), 0), (4 * b * (m + 2), 2 * b * m))
