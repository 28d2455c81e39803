"""K10, the CG body: wrappers over ``csrc/cg.cu`` beside their plain versions.

One iteration of batched preconditioned CG (simplex_gp_tpu/linalg/cg.py::
cg_solve, the ``lax.while_loop`` body :133-205) is five kernels around the
caller's MVM and, for a Woodbury preconditioner, its two cuBLAS products
with U:

  cg_dot      partial column sums of p . Ap (with ``scale``: Ap = s K p + noise p, written out);
              also the initial b . b and r . z, and r . z after a preconditioner given as a callable
  cg_step_x   pap; alpha; x += alpha p, r -= alpha Ap; partial sums of r . r
  cg_scale    the Woodbury solve's (k, t) middle, w * (U^T r)
  cg_precond  z = r / noise - U (w * U^T r); partial sums of r . z
  cg_step_p   rz and r . r; beta; p = z + beta p; the best iterate; the stop rules and the record
  cg_init     the state at iteration 0

The state lives on the device (:func:`cg_state`): per column rz, the best
residual, |b|, alpha, pap, done and the record's liveness, with the scalars
best_mean, since, it and the stop flag, so no kernel needs the host and an
iteration can be replayed from a CUDA graph.

Each wrapper takes its plain version for CPU tensors and launches its kernel
for CUDA tensors, raising on a failed build or launch; there is no fallback.
The wrappers update their arguments in place, as the kernels do.  A column
dot sums in a fixed order (``csrc/cg.cu``): the products of rows b rp + rr +
k nb rp in k order per lane (rr, col) of block b, the block's lanes folded in
halves, then the nb block partials folded in halves.  The plain versions add
in that order with the same roundings, so kernel and plain version agree bit
for bit.

K10' (the data-parallel CG, ``linalg/cg.py`` with an ``axis``): the
kernels that reduce a dot (``cg_step_x``, ``cg_step_p``, ``cg_init``) also
take the ranks' partials all-gathered into a ``(P, nb, t)`` buffer (or a
view with a rank stride).  Each rank's nb partials fold in halves as above,
then the P rank sums add in rank order 0 .. P-1, so every rank reduces the
same bytes to the same bits; a ``(nb, t)`` buffer is P = 1, the one-device
arithmetic.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import build

__all__ = [
    "CGRules",
    "cg_layout",
    "cg_state",
    "state_views",
    "cg_dot_plain",
    "cg_dot",
    "cg_step_x_plain",
    "cg_step_x",
    "cg_scale_plain",
    "cg_scale",
    "cg_precond_plain",
    "cg_precond",
    "cg_step_p_plain",
    "cg_step_p",
    "cg_init_plain",
    "cg_init",
]

THREADS = 256  # a block's threads (csrc/cg.cu CG_THREADS)
MAX_BLOCKS = 512  # most blocks of an iteration's grid
TREE = 8192  # most floats of the stage-2 tree in shared memory (CG_TREE)
LANE_ROWS = 16  # rows a lane adds in turn before the tree, where n allows


def cg_layout(n: int, t: int) -> tuple:
    """(rp, nb): lanes per column in a block (the largest power of two with rp t <= 256) and blocks.

    nb is the least power of two with nb rp LANE_ROWS >= n, at most 512 and
    at most TREE / t, so a lane adds about 16 rows in turn (more past 512
    blocks) before the block's tree.  It depends on n and t only, so the
    kernel and the plain version sum in the same order on any card.
    """
    if not 1 <= t <= THREADS:
        raise ValueError(f"K10 takes 1 to {THREADS} columns, got {t}")
    rp = 1
    while 2 * rp * t <= THREADS:
        rp *= 2
    cap = min(MAX_BLOCKS, 1 << ((TREE // t).bit_length() - 1))
    nb = 1
    while nb < cap and nb * rp * LANE_ROWS < n:
        nb *= 2
    return rp, nb


class CGRules(NamedTuple):
    """The stop rules of cg_solve (cg.py:43): tolerance, floor, cap, stall window, mode, record length."""

    tol: float
    floor: int
    max_iters: int
    stall_window: int
    column_mode: bool
    m: int


_F_FIELDS = ("rz", "res_best", "b_norm", "alpha", "pap", "rz_prev", "res_best_prev")
_I_FIELDS = ("done", "done_prev", "t_alive")


def cg_state(t: int, device) -> tuple:
    """(fs, is_): the zeroed float (7 t + 1) and int32 (3 t + 3) state buffers of a t-column solve."""
    return (torch.zeros(7 * t + 1, dtype=torch.float32, device=device),
            torch.zeros(3 * t + 3, dtype=torch.int32, device=device))


class _Views(NamedTuple):
    rz: torch.Tensor
    res_best: torch.Tensor
    b_norm: torch.Tensor
    alpha: torch.Tensor
    pap: torch.Tensor
    rz_prev: torch.Tensor
    res_best_prev: torch.Tensor
    best_mean: torch.Tensor
    done: torch.Tensor
    done_prev: torch.Tensor
    t_alive: torch.Tensor
    since: torch.Tensor
    it: torch.Tensor
    stop: torch.Tensor


def state_views(fs: torch.Tensor, is_: torch.Tensor) -> _Views:
    """Named views into the state buffers, laid out as csrc/cg.cu's CgState."""
    t = (fs.shape[0] - 1) // 7
    f = [fs[i * t:(i + 1) * t] for i in range(len(_F_FIELDS))]
    i = [is_[k * t:(k + 1) * t] for k in range(len(_I_FIELDS))]
    return _Views(*f, fs[7 * t], *i, is_[3 * t], is_[3 * t + 1], is_[3 * t + 2])


# ---- the summation order ------------------------------------------------------

def _fold_rows(prod: torch.Tensor, nb: int, rp: int) -> torch.Tensor:
    """Stage 1: (n, t) products -> (nb, t) block partials, in the kernels' order."""
    n, t = prod.shape
    step = nb * rp
    K = max(1, -(-n // step))
    if K * step != n:
        prod = torch.cat([prod, prod.new_zeros((K * step - n, t))])
    x = prod.reshape(K, nb, rp, t)
    acc = x[0] + 0.0  # a lane starts from +0
    for k in range(1, K):
        acc = acc + x[k]
    h = rp // 2
    while h:
        acc = acc[:, :h] + acc[:, h:2 * h]
        h //= 2
    return acc[:, 0]


def _fold_blocks(part: torch.Tensor) -> torch.Tensor:
    """Stage 2: (nb, t) block partials -> (t,) column sums, folded in halves."""
    h = part.shape[0] // 2
    while h:
        part = part[:h] + part[h:2 * h]
        h //= 2
    return part[0]


def _fold_ranks(part: torch.Tensor) -> torch.Tensor:
    """Stage 2 over the ranks: (P, nb, t) -> (t,), each rank's partials folded, then added in rank order.

    A (nb, t) buffer is one rank's.
    """
    if part.dim() == 2:
        return _fold_blocks(part)
    s = _fold_blocks(part[0])
    for q in range(1, part.shape[0]):
        s = s + _fold_blocks(part[q])
    return s


def _ranks(part: torch.Tensor, nb: int, t: int, what: str) -> tuple:
    """(P, rank stride) of a CUDA float32 partials buffer: (nb, t), or a (P, nb, t) view whose ranks' blocks are
    each contiguous (a slice of a gather need not be contiguous as a whole)."""
    if not part.is_cuda or part.dtype != torch.float32:
        raise ValueError(f"{what}: expected CUDA float32 partials, got {part.dtype} on {part.device}")
    p3 = part[None] if part.dim() == 2 else part
    if p3.dim() != 3 or p3.shape[1:] != (nb, t) or (t > 1 and p3.stride(2) != 1) or (nb > 1 and p3.stride(1) != t):
        raise ValueError(f"{what}: partials {tuple(part.shape)} (strides {part.stride()}) are not (P, {nb}, {t})")
    return p3.shape[0], p3.stride(0)


def _column_mean(v: torch.Tensor) -> torch.Tensor:
    """Mean of a (t,) vector, summed in column order."""
    s = v[0]
    for c in range(1, v.shape[0]):
        s = s + v[c]
    return s / v.shape[0]


def _rows_cols(x: torch.Tensor) -> tuple:
    n, t = x.shape
    return (n, t, *cg_layout(n, t))


# ---- cg_dot ---------------------------------------------------------------------

def cg_dot_plain(u, v, part, scale=None, noise=None, out=None):
    """Plain cg_dot: part (nb, t) = the block partials of u . v (with ``scale``, of u . (scale v + noise u),
    written to ``out``)."""
    if scale is not None:
        out.copy_(scale * v + noise * u)
        v = out
    _, _, rp, nb = _rows_cols(u)
    part.copy_(_fold_rows(u * v, nb, rp))


def cg_dot(u, v, part, scale=None, noise=None, out=None):
    """K10's column dot: the (nb, t) block partials of u . v, u and v (n, t).

    With ``scale`` and ``noise`` (0-d tensors) v is the operator's K p and
    the dot is taken with A p = scale K p + noise p, which is written to
    ``out``.
    """
    if not u.is_cuda:
        return cg_dot_plain(u, v, part, scale, noise, out)
    n, t, rp, nb = _rows_cols(u)
    checks = [(u, torch.float32), (v, torch.float32), (part, torch.float32)]
    if scale is not None:
        checks += [(scale, torch.float32), (noise, torch.float32), (out, torch.float32)]
    build.require("cg_dot", *checks)
    if v.shape != u.shape or part.shape != (nb, t) or (out is not None and out.shape != u.shape):
        raise ValueError(f"cg_dot: u {tuple(u.shape)}, v {tuple(v.shape)}, part {tuple(part.shape)} do not fit")
    ptr = lambda a: None if a is None else a.data_ptr()
    rc = build.library().sgp_cg_dot(u.data_ptr(), v.data_ptr(), ptr(scale), ptr(noise), ptr(out), n, t, rp, nb,
                                    part.data_ptr(), build.stream())
    build.check(rc, "cg_dot")
    cg_dot.launches += 1


cg_dot.launches = 0


# ---- cg_step_x ------------------------------------------------------------------

def cg_step_x_plain(part_pap, x, r, p, ap, fs, is_, part_rr):
    """Plain cg_step_x: pap, alpha, the snapshots, x += alpha p, r -= alpha ap, the partials of r . r."""
    st = state_views(fs, is_)
    pap = _fold_ranks(part_pap)
    done = st.done.bool()
    alpha = torch.where(done | (pap <= 0), 0.0, st.rz / torch.where(pap <= 0, 1.0, pap))
    st.alpha.copy_(alpha)
    st.pap.copy_(pap)
    st.rz_prev.copy_(st.rz)
    st.done_prev.copy_(st.done)
    st.res_best_prev.copy_(st.res_best)
    x.add_(alpha * p)
    r.sub_(alpha * ap)
    _, _, rp, nb = _rows_cols(r)
    part_rr.copy_(_fold_rows(r * r, nb, rp))


def _require_state(what, fs, is_, t):
    build.require(what, (fs, torch.float32), (is_, torch.int32))
    if fs.shape != (7 * t + 1,) or is_.shape != (3 * t + 3,):
        raise ValueError(f"{what}: state buffers {tuple(fs.shape)} / {tuple(is_.shape)} do not fit {t} columns")


def cg_step_x(part_pap, x, r, p, ap, fs, is_, part_rr):
    """K10 (b): alpha from pap's block partials, the x and r updates, the block partials of r . r.

    ``part_pap`` is (nb, t), or (P, nb, t): every rank's, reduced in rank order (K10').  ``part_rr`` is
    this rank's (nb, t).
    """
    if not x.is_cuda:
        return cg_step_x_plain(part_pap, x, r, p, ap, fs, is_, part_rr)
    n, t, rp, nb = _rows_cols(x)
    build.require("cg_step_x", *((a, torch.float32) for a in (x, r, p, ap, part_rr)))
    _require_state("cg_step_x", fs, is_, t)
    if not (r.shape == p.shape == ap.shape == x.shape) or part_rr.shape != (nb, t) or not part_rr.is_contiguous():
        raise ValueError("cg_step_x: the vectors and partials do not fit one (n, t) solve")
    P, pstride = _ranks(part_pap, nb, t, "cg_step_x")
    rc = build.library().sgp_cg_step_x(part_pap.data_ptr(), P, pstride, x.data_ptr(), r.data_ptr(), p.data_ptr(),
                                       ap.data_ptr(), n, t, rp, nb, fs.data_ptr(), is_.data_ptr(), part_rr.data_ptr(),
                                       build.stream())
    build.check(rc, "cg_step_x")
    cg_step_x.launches += 1


cg_step_x.launches = 0


# ---- cg_scale -------------------------------------------------------------------

def cg_scale_plain(g, w, out):
    """Plain cg_scale: out = w[:, None] * g."""
    out.copy_(w[:, None] * g)


def cg_scale(g, w, out):
    """K10's Woodbury middle: out (k, t) = w[:, None] * g."""
    if not g.is_cuda:
        return cg_scale_plain(g, w, out)
    build.require("cg_scale", (g, torch.float32), (w, torch.float32), (out, torch.float32))
    k, t = g.shape
    if w.shape != (k,) or out.shape != g.shape:
        raise ValueError(f"cg_scale: g {tuple(g.shape)}, w {tuple(w.shape)}, out {tuple(out.shape)} do not fit")
    rc = build.library().sgp_cg_scale(g.data_ptr(), w.data_ptr(), k, t, out.data_ptr(), build.stream())
    build.check(rc, "cg_scale")
    cg_scale.launches += 1


cg_scale.launches = 0


# ---- cg_precond -----------------------------------------------------------------

def cg_precond_plain(r, h, noise, z, part):
    """Plain cg_precond: z = r / noise - h and the block partials of r . z."""
    z.copy_(r / noise - h)
    _, _, rp, nb = _rows_cols(r)
    part.copy_(_fold_rows(r * z, nb, rp))


def cg_precond(r, h, noise, z, part):
    """K10 (c): the Woodbury solve's last step z = r / noise - h (h = U (w * U^T r)) and the partials of r . z."""
    if not r.is_cuda:
        return cg_precond_plain(r, h, noise, z, part)
    n, t, rp, nb = _rows_cols(r)
    build.require("cg_precond", (r, torch.float32), (h, torch.float32), (noise, torch.float32), (z, torch.float32),
                  (part, torch.float32))
    if h.shape != r.shape or z.shape != r.shape or part.shape != (nb, t):
        raise ValueError("cg_precond: r, h, z and the partials do not fit one (n, t) solve")
    rc = build.library().sgp_cg_precond(r.data_ptr(), h.data_ptr(), noise.data_ptr(), z.data_ptr(), n, t, rp, nb,
                                        part.data_ptr(), build.stream())
    build.check(rc, "cg_precond")
    cg_precond.launches += 1


cg_precond.launches = 0


# ---- cg_step_p ------------------------------------------------------------------

def cg_step_p_plain(part_rz, part_rr, x, z, p, x_best, fs, is_, A, B, TM, rules: CGRules):
    """Plain cg_step_p, in the kernel's order (cg.py:150-205): beta, p, the best iterate, the state."""
    st = state_views(fs, is_)
    rz_new, rr = _fold_ranks(part_rz), _fold_ranks(part_rr)
    done = st.done_prev.bool()
    pap, rz = st.pap, st.rz_prev
    broken = ~done & ((pap <= 0) | (rz_new < 0))
    beta = torch.where(done | broken | (rz == 0), 0.0, rz_new / torch.where(rz == 0, 1.0, rz))
    res = torch.sqrt(rr) / st.b_norm
    better = res < st.res_best_prev
    p.copy_(z + beta * p)
    x_best.copy_(torch.where(better[None, :], x, x_best))
    res_best = torch.minimum(res, st.res_best_prev)
    st.res_best.copy_(res_best)
    it = int(st.it)
    ok = st.t_alive.bool() & ~done & (pap > 0) & (rz > 0)
    if rules.m > 0:
        rec, k = ok & (it < rules.m), min(it, rules.m - 1)
        A[k] = torch.where(rec, st.alpha, A[k])
        B[k] = torch.where(rec, beta, B[k])
        TM[k] = torch.where(rec, 1, TM[k])
    st.t_alive.copy_(ok)
    m_best = _column_mean(res_best)
    improved = bool(m_best < 0.99 * st.best_mean)
    if improved:
        st.best_mean.copy_(m_best)
    since = 0 if improved else int(st.since) + 1
    st.since.fill_(since)
    past_floor = it + 1 >= rules.floor
    stalled = rules.stall_window > 0 and since >= rules.stall_window and past_floor
    new_done = done | broken | stalled
    if rules.column_mode:
        new_done = new_done | ((res < rules.tol) & past_floor)
    else:
        new_done = new_done | bool(_column_mean(res) < rules.tol and past_floor) | (res < 1e-10)
    st.done.copy_(new_done)
    st.rz.copy_(rz_new)
    st.it.fill_(it + 1)
    st.stop.fill_(int(bool(new_done.all()) or it + 1 >= rules.max_iters))


def cg_step_p(part_rz, part_rr, x, z, p, x_best, fs, is_, A, B, TM, rules: CGRules):
    """K10 (d): beta, p = z + beta p, the best iterate, and the state: the best residual, the record at
    the device's iteration counter, the stall guard, the stop rules, rz, it and the stop flag.

    A, B (f32) and TM (int32) are the (m, t) record, None when ``rules.m`` is 0.  The partials are
    (nb, t), or (P, nb, t) views of every rank's with the same P (K10').
    """
    if not x.is_cuda:
        return cg_step_p_plain(part_rz, part_rr, x, z, p, x_best, fs, is_, A, B, TM, rules)
    n, t, rp, nb = _rows_cols(x)
    build.require("cg_step_p", *((a, torch.float32) for a in (x, z, p, x_best)))
    _require_state("cg_step_p", fs, is_, t)
    if not (z.shape == p.shape == x_best.shape == x.shape):
        raise ValueError("cg_step_p: the vectors do not fit one (n, t) solve")
    (P, rz_stride), (P_rr, rr_stride) = _ranks(part_rz, nb, t, "cg_step_p"), _ranks(part_rr, nb, t, "cg_step_p")
    if P_rr != P:
        raise ValueError(f"cg_step_p: partials of {P} and {P_rr} ranks")
    if rules.m > 0:
        build.require("cg_step_p", (A, torch.float32), (B, torch.float32), (TM, torch.int32))
        if not (A.shape == B.shape == TM.shape == (rules.m, t)):
            raise ValueError(f"cg_step_p: a record of {rules.m} steps needs (m, t) arrays")
    ptr = lambda a: a.data_ptr() if rules.m > 0 else None
    rc = build.library().sgp_cg_step_p(
        part_rz.data_ptr(), part_rr.data_ptr(), P, rz_stride, rr_stride, x.data_ptr(), z.data_ptr(), p.data_ptr(),
        x_best.data_ptr(), n, t, rp, nb, fs.data_ptr(), is_.data_ptr(), ptr(A), ptr(B), ptr(TM), rules.m,
        float(rules.tol), rules.floor, rules.max_iters, rules.stall_window, int(rules.column_mode), build.stream())
    build.check(rc, "cg_step_p")
    cg_step_p.launches += 1


cg_step_p.launches = 0


# ---- cg_init --------------------------------------------------------------------

def cg_init_plain(part_bb, part_rz, fs, is_, max_iters: int):
    """Plain cg_init: |b| (1 for a zero column), rz0, the residual 1 (0 for a zero column), the flags."""
    st = state_views(fs, is_)
    norm = torch.sqrt(_fold_ranks(part_bb))
    b_norm = torch.where(norm == 0, 1.0, norm)
    st.b_norm.copy_(b_norm)
    st.res_best.copy_(norm / b_norm)
    st.rz.copy_(_fold_ranks(part_rz))
    st.done.zero_()
    st.t_alive.fill_(1)
    st.best_mean.fill_(float("inf"))
    st.since.zero_()
    st.it.zero_()
    st.stop.fill_(int(max_iters <= 0))


def cg_init(part_bb, part_rz, fs, is_, max_iters: int):
    """K10's initial state from the block partials of b . b and r0 . z0 (cg.py:110-116, :207-236).

    The partials are (nb, t), or (P, nb, t) views of every rank's (K10').
    """
    if not fs.is_cuda:
        return cg_init_plain(part_bb, part_rz, fs, is_, max_iters)
    nb, t = part_bb.shape[-2:]
    _require_state("cg_init", fs, is_, t)
    if part_rz.shape != part_bb.shape:
        raise ValueError("cg_init: the two partials differ in shape")
    (P, bb_stride), (_, rz_stride) = _ranks(part_bb, nb, t, "cg_init"), _ranks(part_rz, nb, t, "cg_init")
    rc = build.library().sgp_cg_init(part_bb.data_ptr(), part_rz.data_ptr(), P, bb_stride, rz_stride, nb, t,
                                     fs.data_ptr(), is_.data_ptr(), int(max_iters), build.stream())
    build.check(rc, "cg_init")
    cg_init.launches += 1


cg_init.launches = 0
