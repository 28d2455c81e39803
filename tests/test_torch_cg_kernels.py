"""K10, the CG body (kernels/cg.py), and cg_solve on it, against the JAX package's cg_solve.

Same numpy inputs on both sides, PyTorch on the CPU, where every K10
wrapper runs its plain twin.  The twins sum each column dot in the kernels'
fixed order (a lane's rows in turn, then trees over the lanes and the
blocks), JAX in XLA's; on these well-conditioned systems (JAX given the
port's preconditioner factors) that keeps x, the residuals (above an
absolute 1e-7) and the tridiagonal record within rel 1e-5, and every
iteration count equal.  Two solves on one device are bit-equal.
The record is written at the device's iteration counter (JAX's k = min(it,
m - 1)); it equals the host-indexed record of the previous eager loop run on
the same dots bit for bit.
"""

import importlib
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel_err

import simplex_gp_torch
from simplex_gp_torch.kernels import cg as K10
from simplex_gp_torch.linalg import cg as t_cg
from simplex_gp_torch.linalg import pivoted_cholesky as t_pc
from simplex_gp_tpu.linalg import cg as j_cg

j_pc = importlib.import_module("simplex_gp_tpu.linalg.pivoted_cholesky")

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-5


def _system(n=300, k=20, seed=0):
    """A = L L^T + noise I + E (E small, SPD) and the Woodbury preconditioner of L L^T + noise I, in both
    packages: JAX's built from the port's factors, so that the two solves differ by K10's arithmetic
    alone (the two eigh of the preconditioner's Gram alone move a solve by rel ~1e-4)."""
    rng = np.random.default_rng(seed)
    L = (rng.normal(size=(n, k)) * np.geomspace(0.3, 0.01, k)).astype(np.float32)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    E = (Q * np.geomspace(3.0, 0.1, n)) @ Q.T
    noise = np.float32(1.0)
    A = (L @ L.T + noise * np.eye(n) + E).astype(np.float32)
    tP = t_pc.make_preconditioner(torch.from_numpy(L), torch.tensor(noise), n)
    jP = j_pc.Preconditioner(**{f: jnp.asarray(getattr(tP, f).numpy()) for f in j_pc.Preconditioner._fields})
    return A, tP, jP


def _rhs(n, c, seed=1):
    return np.random.default_rng(seed).normal(size=(n, c)).astype(np.float32)


def _both(A, b, tP=None, jP=None, **kw):
    jA, tA = jnp.asarray(A), torch.from_numpy(A)
    jr = j_cg.cg_solve(lambda V: jA @ V, jnp.asarray(b), precond=None if jP is None else
                       (lambda V: j_pc.precond_solve(jP, V)), **kw)
    tr = t_cg.cg_solve(lambda V: tA @ V, torch.from_numpy(b), precond=tP, **kw)
    return jr, tr


def _assert_close(tr, jr, record=False):
    assert tr.iterations == int(jr.iterations)
    assert rel_err(tr.x.numpy(), np.asarray(jr.x)) <= REL
    np.testing.assert_allclose(tr.residual_norm.numpy(), np.asarray(jr.residual_norm), rtol=REL, atol=1e-7)
    if record:
        np.testing.assert_array_equal(tr.tmask.numpy(), np.asarray(jr.tmask))
        for got, want in ((tr.alphas, jr.alphas), (tr.betas, jr.betas)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=REL, atol=1e-7)


# ---- the layout and each twin's arithmetic ----------------------------------------------


@pytest.mark.parametrize("n,t", [(1, 1), (30, 2), (300, 11), (10623, 11), (1311539, 1), (5000, 101), (64, 256)])
def test_layout_fits_the_kernels_limits(n, t):
    rp, nb = K10.cg_layout(n, t)
    assert rp & (rp - 1) == 0 and nb & (nb - 1) == 0
    assert rp * t <= K10.THREADS < 2 * rp * t and nb * t <= K10.TREE and nb <= K10.MAX_BLOCKS
    assert nb * rp * K10.LANE_ROWS >= n or nb == min(K10.MAX_BLOCKS, 1 << ((K10.TREE // t).bit_length() - 1))


@pytest.mark.parametrize("n,t", [(7, 1), (300, 11), (4097, 3), (20000, 1)])
def test_dot_partials_fold_to_the_column_dot(n, t):
    """cg_dot's block partials, folded, are the column dots; with a shift it writes s v + noise u."""
    rng = np.random.default_rng(n)
    u, v = (torch.from_numpy(rng.normal(size=(n, t)).astype(np.float32)) for _ in range(2))
    rp, nb = K10.cg_layout(n, t)
    part = torch.empty((nb, t))
    K10.cg_dot(u, v, part)
    want = (u.double() * v.double()).sum(0)
    assert rel_err(K10._fold_blocks(part).numpy(), want.numpy()) <= 1e-6
    s, noise, out = torch.tensor(0.7), torch.tensor(0.2), torch.empty_like(u)
    K10.cg_dot(u, v, part, s, noise, out)
    assert torch.equal(out, s * v + noise * u)
    assert rel_err(K10._fold_blocks(part).numpy(), (u.double() * out.double()).sum(0).numpy()) <= 1e-6


def _woodbury(tP, r):
    """The Woodbury solve through K10's passes over U, as CGLoop runs it: (z, G2, the r . z partials)."""
    (n, k), t = tP.U.shape, r.shape[1]
    lay = K10.u_layout(n, k, t)
    w = tP.s2 / (tP.noise * (tP.noise + tP.s2)) / tP.gamma
    part_g, G2 = torch.empty((lay.nb, k, t)), torch.empty((k, t))
    z, part = torch.empty_like(r), torch.empty((lay.nb, t))
    K10.cg_utr(tP.U, r, part_g)
    K10.cg_fold(part_g, w, G2)
    K10.cg_precond(tP.U, G2, r, tP.noise, z, part)
    return z, G2, part, w


def _assert_woodbury_matches_jax(tP, jP, r):
    """z against JAX's precond_solve (rel REL: sums in other orders); G2 = w U^T r and r . z against float64."""
    z, G2, part, w = _woodbury(tP, torch.from_numpy(r))
    assert rel_err(z.numpy(), np.asarray(j_pc.precond_solve(jP, jnp.asarray(r)))) <= REL
    U64 = tP.U.double().numpy()
    assert rel_err(G2.numpy(), w.double().numpy()[:, None] * (U64.T @ r.astype(np.float64))) <= 1e-6
    assert rel_err(K10._fold_blocks(part).numpy(), (r.astype(np.float64) * z.numpy()).sum(0)) <= 1e-6


def test_precond_twins_match_jax_precond_solve():
    """cg_utr, cg_fold and cg_precond give JAX's Woodbury solve P^{-1} r and r . z (the test system's k = 20)."""
    _, tP, jP = _system()
    _assert_woodbury_matches_jax(tP, jP, _rhs(300, 11, seed=5))


@pytest.mark.parametrize("k", [1, 7, 100])
@pytest.mark.parametrize("t", [1, 11])
def test_u_passes_match_jax_precond_solve(t, k):
    """The passes over U at the widths the CG runs (t = 1 the eval, 11 the training CG) and ranks k of the
    preconditioner: one, not a multiple of 4 (one U value a load), 100; n = 1,003 is no multiple of a block's
    rows, so the last block and its last tile are short."""
    n = 1003
    lay = K10.u_layout(n, k, t)
    assert n % lay.rb and n % lay.tr
    rng = np.random.default_rng(k * 100 + t)
    L = (rng.normal(size=(n, k)) * np.geomspace(0.3, 0.01, k)).astype(np.float32)
    tP = t_pc.make_preconditioner(torch.from_numpy(L), torch.tensor(np.float32(0.5)), n)
    jP = j_pc.Preconditioner(**{f: jnp.asarray(getattr(tP, f).numpy()) for f in j_pc.Preconditioner._fields})
    _assert_woodbury_matches_jax(tP, jP, _rhs(n, t, seed=k + t))


@pytest.mark.parametrize("t", [1, 11, 24])
def test_u_layout_takes_the_ranks_bbmm_config_states(t):
    """The passes over U take k + t <= 1024 and at most 256 output groups: ceil(k / 4) (k, if k is not a
    multiple of 4) times ceil(t / tca), the stated limit of BBMMConfig.precond_rank; past it u_layout raises."""
    tca = 1 if t == 1 else 4 if t <= 4 else 12
    for k in range(1, 1100):
        groups = (-(-k // 4) if k % 4 == 0 else k) * -(-t // tca)
        fits = k + t <= 1024 and groups <= 256
        if fits:
            lay = K10.u_layout(50_000, k, t)
            assert lay.lanes * -(-k // lay.jb) * -(-t // lay.tca) <= K10.THREADS
        else:
            with pytest.raises(ValueError):
                K10.u_layout(50_000, k, t)


@pytest.mark.parametrize("P", [1, 2, 3, 4])
def test_fold_adds_every_ranks_partials_in_rank_order(P):
    """cg_fold's twin given (P, nb, k, t) partials: each rank's nb partials folded in halves, then the ranks added
    in order 0 .. P-1, then w; P = 1 is the one-device call on the (nb, k, t) partials bit for bit; P > 1 is
    the one-device fold of each rank's partials with w = 1, added in rank order by hand and scaled by w."""
    k, t, nb = 7, 11, 16
    part = torch.rand((P, nb, k, t), generator=torch.Generator().manual_seed(P)) - 0.5
    w = torch.rand(k, generator=torch.Generator().manual_seed(10 + P)) + 0.5
    got, want = torch.empty((k, t)), torch.empty((k, t))
    K10.cg_fold(part, w, got)
    ranks = []
    for q in range(P):
        g = torch.empty((k, t))
        K10.cg_fold(part[q], torch.ones(k), g)
        ranks.append(g)
    total = ranks[0]
    for g in ranks[1:]:
        total = total + g
    want.copy_(w[:, None] * total)
    assert torch.equal(got, want)
    if P == 1:
        one = torch.empty((k, t))
        K10.cg_fold(part[0], w, one)
        assert torch.equal(got, one)
    assert rel_err(got.numpy(), w.double().numpy()[:, None] * part.double().sum((0, 1)).numpy()) <= 1e-6


def test_fold_of_gathered_ranks_is_the_sharded_loops_g2():
    """The sharded loop's two folds (each rank's own partials with w = 1, then the gathered (P, 1, k, t) ranks
    with w) give the one fold of every rank's (P, nb, k, t) partials bit for bit."""
    P, k, t, nb = 3, 5, 4, 8
    part = torch.rand((P, nb, k, t), generator=torch.Generator().manual_seed(3)) - 0.5
    w = torch.rand(k, generator=torch.Generator().manual_seed(4))
    one, two, G = torch.empty((k, t)), torch.empty((k, t)), torch.empty((P, k, t))
    K10.cg_fold(part, w, one)
    for q in range(P):
        K10.cg_fold(part[q], torch.ones(k), G[q])
    K10.cg_fold(G[:, None], w, two)
    assert torch.equal(one, two)


def _twin_loop(A, b, P, rules):
    """The K10 twins called one by one, as cg_solve calls them: an independent driver of the same loop."""
    n, t = b.shape
    rp, nb = K10.cg_layout(n, t)
    fs, is_ = K10.cg_state(t, "cpu")
    st = K10.state_views(fs, is_)
    lay = K10.u_layout(n, P.U.shape[1], t)
    parts = [torch.empty((nb, t)), torch.empty((nb, t)), torch.empty((lay.nb, t)), torch.empty((nb, t))]
    x, x_best, r = torch.zeros_like(b), torch.zeros_like(b), b.clone()
    rec = (torch.ones((rules.m, t)), torch.zeros((rules.m, t)), torch.zeros((rules.m, t), dtype=torch.int32))
    w = P.s2 / (P.noise * (P.noise + P.s2)) / P.gamma
    part_g, G2, z = torch.empty((lay.nb, P.U.shape[1], t)), torch.empty((P.U.shape[1], t)), torch.empty_like(b)

    def precondition():
        K10.cg_utr(P.U, r, part_g)
        K10.cg_fold(part_g, w, G2)
        K10.cg_precond(P.U, G2, r, P.noise, z, parts[2])

    K10.cg_dot(b, b, parts[3])
    precondition()
    p = z.clone()
    K10.cg_init(parts[3], parts[2], fs, is_, rules.max_iters)
    while not int(st.stop):
        kp = A @ p
        K10.cg_dot(p, kp, parts[0])
        K10.cg_step_x(parts[0], x, r, p, kp, fs, is_, parts[1])
        precondition()
        K10.cg_step_p(parts[2], parts[1], x, z, p, x_best, fs, is_, *rec, rules)
    return x_best, int(st.it), st.res_best.clone(), rec


@pytest.mark.parametrize("mode", ["mean", "column"])
@pytest.mark.parametrize("c", [1, 11])
def test_twins_one_by_one_match_jax_iteration_by_iteration(c, mode):
    """Each iteration's alpha (cg_step_x) and beta (cg_step_p) against JAX's record, row by row; the
    best iterate, residual and iteration count at the end."""
    A, tP, jP = _system()
    b = _rhs(300, c)
    m = 8
    rules = K10.CGRules(1e-4, 10, 200, 50, mode == "column", m)
    x, iters, res, (Ar, Br, TMr) = _twin_loop(torch.from_numpy(A), torch.from_numpy(b), tP, rules)
    jA = jnp.asarray(A)
    jr = j_cg.cg_solve(lambda V: jA @ V, jnp.asarray(b), tol=1e-4, max_iters=200, stop_mode=mode,
                       precond=lambda V: j_pc.precond_solve(jP, V), tridiag_m=m)
    assert iters == int(jr.iterations) > m
    np.testing.assert_array_equal(TMr.bool().numpy(), np.asarray(jr.tmask))
    for k in range(m):
        np.testing.assert_allclose(Ar[k].numpy(), np.asarray(jr.alphas[k]), rtol=REL, err_msg=f"alpha row {k}")
        np.testing.assert_allclose(Br[k].numpy(), np.asarray(jr.betas[k]), rtol=REL, atol=1e-8,
                                   err_msg=f"beta row {k}")
    assert rel_err(x.numpy(), np.asarray(jr.x)) <= REL
    np.testing.assert_allclose(res.numpy(), np.asarray(jr.residual_norm), rtol=REL, atol=1e-7)


@pytest.mark.parametrize("tridiag_m", [0, 8])
@pytest.mark.parametrize("mode,tol", [("mean", 1e-3), ("column", 1e-4)])
@pytest.mark.parametrize("c", [1, 11])
def test_cg_solve_matches_jax_with_a_woodbury_preconditioner(c, mode, tol, tridiag_m):
    A, tP, jP = _system(seed=2)
    b = _rhs(300, c, seed=3)
    jr, tr = _both(A, b, tP, jP, tol=tol, max_iters=300, stop_mode=mode, tridiag_m=tridiag_m)
    _assert_close(tr, jr, record=bool(tridiag_m))


def test_cg_solve_shift_is_the_shifted_operator():
    """shift = (s, noise): the solve of s K + noise I, bit-equal to passing that operator whole."""
    A, tP, _ = _system(seed=4)
    K = torch.from_numpy(A)
    b = torch.from_numpy(_rhs(300, 3))
    s, noise = torch.tensor(0.8), torch.tensor(0.3)
    fused = t_cg.cg_solve(lambda V: K @ V, b, tol=1e-4, precond=tP, shift=(s, noise), tridiag_m=5)
    whole = t_cg.cg_solve(lambda V: s * (K @ V) + noise * V, b, tol=1e-4, precond=tP, tridiag_m=5)
    assert fused.iterations == whole.iterations
    for got, want in zip(fused, whole):
        if isinstance(got, torch.Tensor):
            assert torch.equal(got, want)


# ---- K10': every rank's partials, folded in rank order ---------------------------------------------


def _hand_fold(part: torch.Tensor) -> torch.Tensor:
    """(P, nb, t) -> (t,) by float32 scalar additions: each rank's nb partials in halves, then the ranks in order."""
    P, nb, t = part.shape
    out = []
    for c in range(t):
        total = None
        for q in range(P):
            v = [np.float32(e) for e in part[q, :, c].tolist()]
            while len(v) > 1:
                h = len(v) // 2
                v = [np.float32(v[i] + v[i + h]) for i in range(h)]
            total = v[0] if total is None else np.float32(total + v[0])
        out.append(total)
    return torch.from_numpy(np.array(out, dtype=np.float32))


def _one_rank(part: torch.Tensor, P: int) -> torch.Tensor:
    """The (nb, t) buffer of today's call that stands for ``part`` (P, nb, t): at P = 1 its one block; else
    the hand-written fold in block 0 and zeros after, whose own fold is that sum exactly."""
    if P == 1:
        return part[0].clone()
    one = torch.zeros(part.shape[1:])
    one[0] = _hand_fold(part)
    return one


@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("kernel", ["cg_step_x", "cg_step_p", "cg_init"])
def test_reducing_twins_fold_every_ranks_partials_in_rank_order(kernel, P):
    """The three twins that reduce a dot, given a stacked (P, nb, t) buffer (two as views of one
    (P, 2, nb, t) gather, as the sharded loop passes them), from a state three iterations into a solve: at
    P = 1 torch.equal to today's (nb, t) call on the same partials; at P = 2 and 4 torch.equal to the call
    on one block holding the hand-written fold (each rank's halves, then the ranks in order)."""
    A, tP, _ = _system(seed=15)
    tA = torch.from_numpy(A)
    loop = t_cg.CGLoop(lambda V: tA @ V, torch.from_numpy(_rhs(300, 11)), tol=1e-6, precond=tP, tridiag_m=8)
    for _ in range(3):
        loop.iteration()
    nb = loop.part_pap.shape[0]
    rr, rz = (torch.rand((P, 2, nb, 11), generator=torch.Generator().manual_seed(P)) + 0.5).transpose(0, 1)
    kp = tA @ loop.p
    state = lambda: [a.clone() for a in (loop.x, loop.r, loop.p, loop.x_best, loop.fs, loop.is_, loop.part_rr,
                                         loop.A, loop.B, loop.TM)]

    def call(a, b_):
        x, r, p, x_best, fs, is_, part_rr, *rec = S = state()
        if kernel == "cg_step_x":
            K10.cg_step_x(a, x, r, p, kp, fs, is_, part_rr)
        elif kernel == "cg_step_p":
            K10.cg_step_p(b_, a, x, loop.z, p, x_best, fs, is_, *rec, loop.rules)
        else:
            K10.cg_init(a, b_, fs, is_, 500)
        return S

    for got, want in zip(call(rr, rz), call(_one_rank(rr, P), _one_rank(rz, P))):
        assert torch.equal(got, want)


# ---- the stop cases --------------------------------------------------------------------------


def test_stops_at_the_floor_like_jax():
    A, tP, jP = _system(seed=6)
    jr, tr = _both(A, _rhs(300, 11), tP, jP, tol=1.0, max_iters=100, tridiag_m=20)
    assert tr.iterations == 10
    _assert_close(tr, jr, record=True)


def test_stops_on_the_stall_guard_like_jax():
    A, tP, jP = _system(seed=7)
    jr, tr = _both(A, _rhs(300, 2), tP, jP, tol=0.0, max_iters=400, stall_window=5)
    assert 10 <= tr.iterations < 400
    _assert_close(tr, jr)


def test_pap_breakdown_freezes_like_jax():
    """An indefinite operator: pap <= 0 freezes the column at its best iterate (no preconditioner)."""
    rng = np.random.default_rng(8)
    Q, _ = np.linalg.qr(rng.normal(size=(60, 60)))
    A = ((Q * np.concatenate([-np.ones(6), np.linspace(1.0, 3.0, 54)])) @ Q.T).astype(np.float32)
    b = rng.normal(size=(60, 11)).astype(np.float32)
    jr, tr = _both(A, b, tol=1e-6, max_iters=300, stop_mode="column", tridiag_m=30)
    assert tr.iterations < 300 and (tr.residual_norm.numpy() > 1e-6).any()
    _assert_close(tr, jr, record=True)


def test_rz_breakdown_freezes_like_jax():
    """An indefinite preconditioner on an SPD operator (pap > 0 always): rz < 0 freezes every column
    far above the tolerance, with no stall guard."""
    A, _, _ = _system(n=80, k=5, seed=9)
    d = np.ones(80, np.float32)
    d[:2] = -2.0
    jd, td = jnp.asarray(d), torch.from_numpy(d)
    b = _rhs(80, 11, seed=10)
    jA, tA = jnp.asarray(A), torch.from_numpy(A)
    kw = dict(tol=1e-6, max_iters=300, stop_mode="column", stall_window=0, tridiag_m=30)
    jr = j_cg.cg_solve(lambda V: jA @ V, jnp.asarray(b), precond=lambda V: V / jd[:, None], **kw)
    tr = t_cg.cg_solve(lambda V: tA @ V, torch.from_numpy(b), precond=lambda V: V / td[:, None], **kw)
    assert tr.iterations < 300 and (tr.residual_norm.numpy() > 1e-3).all()
    _assert_close(tr, jr, record=True)


def test_zero_rhs_column_stays_zero_like_jax():
    A, tP, jP = _system(seed=11)
    b = _rhs(300, 3)
    b[:, 1] = 0.0
    jr, tr = _both(A, b, tP, jP, tol=1e-4, max_iters=200, tridiag_m=10)
    assert (tr.x[:, 1] == 0).all() and float(tr.residual_norm[1]) == 0.0
    _assert_close(tr, jr, record=True)


# ---- the record and repeatability -----------------------------------------------------------


def _host_indexed_record(A, b, P, m, tol, max_iters):
    """The previous eager loop's record, indexed by the host's iteration count, on K10's dots."""
    n, t = b.shape
    rp, nb = K10.cg_layout(n, t)

    def dot(u, v):
        return K10._fold_blocks(K10._fold_rows(u * v, nb, rp))

    def precondition(r):  # z and r . z, K10's Woodbury solve and its r . z order
        z, _, part, _ = _woodbury(P, r)
        return z, K10._fold_blocks(part)

    x, r = torch.zeros_like(b), b.clone()
    z, rz = precondition(r)
    p = z
    done = torch.zeros(t, dtype=torch.bool)
    Ar, Br, TMr = torch.ones((m, t)), torch.zeros((m, t)), torch.zeros((m, t), dtype=torch.bool)
    alive = torch.ones(t, dtype=torch.bool)
    b_norm = torch.sqrt(dot(b, b))
    it = 0
    while it < max_iters and not bool(done.all()):
        ap = A @ p
        pap = dot(p, ap)
        alpha = torch.where(done | (pap <= 0), 0.0, rz / torch.where(pap <= 0, 1.0, pap))
        x, r = x + alpha * p, r - alpha * ap
        z, rz_new = precondition(r)
        broken = ~done & ((pap <= 0) | (rz_new < 0))
        beta = torch.where(done | broken | (rz == 0), 0.0, rz_new / torch.where(rz == 0, 1.0, rz))
        p = z + beta * p
        res = torch.sqrt(dot(r, r)) / b_norm
        ok = alive & ~done & (pap > 0) & (rz > 0)
        if it < m:
            Ar[it] = torch.where(ok, alpha, Ar[it])
            Br[it] = torch.where(ok, beta, Br[it])
            TMr[it] = TMr[it] | ok
        alive = ok
        done = done | (K10._column_mean(res) < tol) & (it + 1 >= 10) | (res < 1e-10) | broken
        rz, it = rz_new, it + 1
    return it, Ar, Br, TMr


def test_device_counter_record_equals_the_host_indexed_record():
    """More iterations than record rows: the device-counter record is the host-indexed one bit for bit."""
    A, tP, _ = _system(seed=12)
    b = torch.from_numpy(_rhs(300, 11))
    m = 6
    res = t_cg.cg_solve(lambda V: torch.from_numpy(A) @ V, b, tol=1e-4, max_iters=200, precond=tP, tridiag_m=m)
    it, Ar, Br, TMr = _host_indexed_record(torch.from_numpy(A), b, tP, m, 1e-4, 200)
    assert res.iterations == it > m
    assert torch.equal(res.alphas, Ar) and torch.equal(res.betas, Br) and torch.equal(res.tmask, TMr)


@pytest.mark.parametrize("precond", ["woodbury", "callable", "none"])
def test_two_solves_are_bit_equal(precond):
    A, tP, _ = _system(seed=13)
    tA = torch.from_numpy(A)
    P = {"woodbury": tP, "callable": lambda V: t_pc.precond_solve(tP, V), "none": None}[precond]
    b = torch.from_numpy(_rhs(300, 11))
    one, two = (t_cg.cg_solve(lambda V: tA @ V, b, tol=1e-3, precond=P, tridiag_m=20, graph=True)
                for _ in range(2))
    assert one.iterations == two.iterations
    for u, v in zip(one, two):
        assert u == v if isinstance(u, str) else torch.equal(torch.as_tensor(u), torch.as_tensor(v))


def test_max_iters_zero_runs_no_iteration():
    A, tP, _ = _system(seed=14)
    res = t_cg.cg_solve(lambda V: torch.from_numpy(A) @ V, torch.from_numpy(_rhs(300, 2)), max_iters=0, precond=tP)
    assert res.iterations == 0 and (res.x == 0).all() and torch.equal(res.residual_norm, torch.ones(2))


# ---- the port's own rules ----------------------------------------------------------------------


def test_every_port_module_imports_without_jax():
    """No module of simplex_gp_torch, and not chip_smoke.py, imports jax or the JAX package."""
    names = [m.name for m in pkgutil.walk_packages(simplex_gp_torch.__path__, "simplex_gp_torch.")]
    assert "simplex_gp_torch.kernels.cg" in names and "simplex_gp_torch.linalg.cg" in names
    code = ("import sys, importlib; sys.modules['jax'] = None; sys.modules['simplex_gp_tpu'] = None; "
            f"sys.path.insert(0, '.'); [importlib.import_module(m) for m in {names!r}]; import chip_smoke")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


@pytest.mark.parametrize("module", ["train", "train_skip", "train_sgpr", "train_exact", "mvm_err", "scaling"])
def test_entry_points_default_to_the_card(module):
    """Every entry point's --device defaults to cuda, which raises without a card: no CPU fallback."""
    mod = importlib.import_module(f"simplex_gp_torch.{module}")
    args = mod._parser().parse_args([]) if module == "scaling" else mod.parse_args([])
    assert args.device == "cuda"
