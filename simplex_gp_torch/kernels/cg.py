"""K10, the CG body: wrappers over ``csrc/cg.cu`` beside their plain versions.

One iteration of batched preconditioned CG (simplex_gp_tpu/linalg/cg.py::
cg_solve, the ``lax.while_loop`` body :133-205) is these kernels around the
caller's MVM; the three in the middle are a Woodbury preconditioner's solve
(pivoted_cholesky.py::precond_solve, :242-253), which read U themselves:

  cg_dot      partial column sums of p . Ap (with ``scale``: Ap = s K p + noise p, written out);
              also the initial b . b, and r . z after a preconditioner given as a callable
  cg_step_x   pap; alpha; x += alpha p, r -= alpha Ap; partial sums of r . r
  cg_utr      block partials of G = U^T r (k, t)
  cg_fold     G2 = w * G from the partials (every rank's, added in rank order)
  cg_precond  z = r / noise - U G2; partial sums of r . z
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
for bit.  The passes over U take their own layout (:func:`u_layout`): nbu
blocks of rb consecutive rows, in tiles of tr rows; cg_utr's lane l of a
block adds its rows l, l + lanes, ... in order, then the lanes and the
blocks fold in halves; cg_precond sums each U[i] G2 over js segments of j
in order, folds the segments in halves, and adds r . z row lane by row lane
(the tile's row rl, tile by tile) before the tr lanes fold in halves.

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
    "ULayout",
    "u_layout",
    "cg_utr_plain",
    "cg_utr",
    "cg_fold_plain",
    "cg_fold",
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


U_ROWS = 128  # rows a block of the passes over U takes, where n allows
U_MAX_BLOCKS = 256  # most blocks of a pass over U


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


class ULayout(NamedTuple):
    """The passes over U (csrc/cg.cu cg_utr, cg_precond): blocks, rows and the threads' shares."""

    nb: int  # blocks (a power of two); block b takes the rows [b rb, b rb + rb)
    rb: int  # rows a block, a multiple of 4 and of ``lanes``
    tr: int  # rows a tile of shared memory (a power of two, 8 .. 64); cg_precond's row rl is r . z's lane rl
    lanes: int  # cg_utr: lanes an output; lane l adds the block's rows l, l + lanes, ... in order
    jb: int  # cg_utr: rows of U^T a thread holds (4 when k is a multiple of 4, read 16 bytes at once)
    tca: int  # cg_utr: columns of r a thread holds (1, 4 or 12)
    js: int  # cg_precond: segments of j a row's U G2 is summed in (js tr = 256), ceil(k / js) j each
    tcb: int  # cg_precond: columns of U G2 a thread holds at a time (1, 4 or 12)


def _pow2_floor(v: int) -> int:
    return 1 << (max(1, v).bit_length() - 1)


def u_layout(n: int, k: int, t: int) -> ULayout:
    """The layout of K10's passes over U (n, k) and r (n, t); it depends on (n, k, t) only.

    nb is the least power of two with nb U_ROWS >= n, at most U_MAX_BLOCKS and TREE / t (r . z's
    partials fold in cg_step_p's shared memory); a tile of tr rows of U and r is at most 8,192 floats.
    cg_utr's 256 threads hold (lanes) x (groups of jb x tca outputs), with lanes the largest power of
    two that fits and at most tr.
    """
    if not (1 <= t <= THREADS and k >= 1):
        raise ValueError(f"K10's passes over U take 1 to {THREADS} columns and k >= 1, got t={t}, k={k}")
    tr = min(64, _pow2_floor(8192 // (k + t)))
    jb = 4 if k % 4 == 0 else 1
    tca = tcb = 1 if t == 1 else 4 if t <= 4 else 12
    groups = -(-k // jb) * -(-t // tca)
    if tr < 8 or groups > THREADS:
        raise ValueError(f"K10's passes over U take k + t <= 1024 and at most {THREADS} output groups; "
                         f"got k={k}, t={t}")
    lanes = min(tr, _pow2_floor(THREADS // groups))
    cap = min(U_MAX_BLOCKS, _pow2_floor(TREE // t))
    nb = 1
    while nb < cap and nb * U_ROWS < n:
        nb *= 2
    q = max(4, lanes)
    rb = -(-(-(-n // nb)) // q) * q
    return ULayout(nb, rb, tr, lanes, jb, tca, THREADS // tr, tcb)


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
    """Mean of a (t,) vector, summed in column order, divided by t as the kernel does (a CUDA tensor divided
    by a Python number is multiplied by its reciprocal, which can differ in the last bit)."""
    s = v[0]
    for c in range(1, v.shape[0]):
        s = s + v[c]
    return s / v.new_tensor(float(v.shape[0]))


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


# ---- the passes over U: cg_utr, cg_fold, cg_precond ----------------------------------

def _blocks_of_rows(x: torch.Tensor, lay: ULayout) -> torch.Tensor:
    """(n, w) -> (nb, rb, w): block b's rows [b rb, b rb + rb), zeros past n."""
    n, wd = x.shape
    pad = lay.nb * lay.rb - n
    if pad:
        x = torch.cat([x, x.new_zeros((pad, wd))])
    return x.reshape(lay.nb, lay.rb, wd)


def _fold_lanes(acc: torch.Tensor) -> torch.Tensor:
    """(nb, L, ...) -> (nb, ...): the L lanes folded in halves."""
    h = acc.shape[1] // 2
    while h:
        acc = acc[:, :h] + acc[:, h:2 * h]
        h //= 2
    return acc[:, 0]


def cg_utr_plain(U, r, part):
    """Plain cg_utr: part (nb, k, t), block b's sum of U[i, :, None] r[i, None, :] over its rows, in the kernel's
    order: lane l adds rows l, l + lanes, ... in turn, then the lanes fold in halves.  (nb, lanes, k, t) adds a
    row of the lanes, never an (n, k, t) product."""
    (n, k), t = U.shape, r.shape[1]
    lay = u_layout(n, k, t)
    steps = lay.rb // lay.lanes
    Ub = _blocks_of_rows(U, lay).reshape(lay.nb, steps, lay.lanes, k)
    rb = _blocks_of_rows(r, lay).reshape(lay.nb, steps, lay.lanes, t)
    acc = U.new_zeros((lay.nb, lay.lanes, k, t))
    for m in range(steps):
        acc = acc + Ub[:, m, :, :, None] * rb[:, m, :, None, :]
    part.copy_(_fold_lanes(acc))


def _aligned(*tensors) -> bool:
    return all(a.data_ptr() % 16 == 0 for a in tensors)


def cg_utr(U, r, part):
    """K10's first pass over U: the (nb, k, t) block partials of G = U^T r (:func:`u_layout`'s blocks)."""
    if not U.is_cuda:
        return cg_utr_plain(U, r, part)
    build.require("cg_utr", (U, torch.float32), (r, torch.float32), (part, torch.float32))
    (n, k), t = U.shape, r.shape[1]
    lay = u_layout(n, k, t)
    if r.shape[0] != n or part.shape != (lay.nb, k, t) or not _aligned(U, r):
        raise ValueError(f"cg_utr: U {tuple(U.shape)}, r {tuple(r.shape)}, part {tuple(part.shape)} do not fit "
                         f"(or U, r are not 16-byte aligned)")
    rc = build.library().sgp_cg_utr(U.data_ptr(), r.data_ptr(), n, k, t, lay.nb, lay.rb, lay.tr, lay.lanes, lay.jb,
                                    lay.tca, part.data_ptr(), build.stream())
    build.check(rc, "cg_utr")
    cg_utr.launches += 1


cg_utr.launches = 0


def cg_fold_plain(part, w, out):
    """Plain cg_fold: out (k, t) = w[:, None] * the sum of part's block partials, each rank's folded in
    halves, the ranks added in rank order."""
    k, t = out.shape
    flat = part.reshape(*part.shape[:-2], k * t)
    out.copy_(w[:, None] * _fold_ranks(flat).reshape(k, t))


def cg_fold(part, w, out):
    """K10's fold of G: out (k, t) = w[:, None] * G, G the sum of part's block partials.

    ``part`` is cg_utr's (nb, k, t), or (P, nb, k, t) with every rank's (its ranks' blocks each contiguous):
    each rank's nb partials fold in halves, then the ranks add in rank order 0 .. P-1.
    """
    if not out.is_cuda:
        return cg_fold_plain(part, w, out)
    build.require("cg_fold", (w, torch.float32), (out, torch.float32))
    k, t = out.shape
    p4 = part[None] if part.dim() == 3 else part
    if (not p4.is_cuda or p4.dtype != torch.float32 or p4.dim() != 4 or p4.shape[2:] != (k, t) or w.shape != (k,)
            or not p4[0].is_contiguous()):
        raise ValueError(f"cg_fold: partials {tuple(part.shape)}, w {tuple(w.shape)}, out {tuple(out.shape)} "
                         "do not fit")
    P, nb = p4.shape[:2]
    rc = build.library().sgp_cg_fold(p4.data_ptr(), P, p4.stride(0), nb, k, t, w.data_ptr(), out.data_ptr(),
                                     build.stream())
    build.check(rc, "cg_fold")
    cg_fold.launches += 1


cg_fold.launches = 0


def cg_precond_plain(U, G2, r, noise, z, part):
    """Plain cg_precond: z = r / noise - h, h[i, c] the sum of U[i, j] G2[j, c] over j (each of js segments of
    ks in order, the segments folded in halves), and the (nb, t) block partials of r . z (a tile's row rl adds
    its rows tile by tile, then the tr row lanes fold in halves)."""
    (n, k), t = U.shape, r.shape[1]
    lay = u_layout(n, k, t)
    ks = -(-k // lay.js)
    segs = []
    for s in range(lay.js):
        h = r.new_zeros((n, t))
        for j in range(min(k, s * ks), min(k, s * ks + ks)):
            h = h + U[:, j:j + 1] * G2[j:j + 1]
        segs.append(h)
    hs = torch.stack(segs)
    half = lay.js // 2
    while half:
        hs = hs[:half] + hs[half:2 * half]
        half //= 2
    z.copy_(r / noise - hs[0])
    prod = _blocks_of_rows(r * z, lay)
    R = -(-lay.rb // lay.tr) * lay.tr
    if R != lay.rb:
        prod = torch.cat([prod, prod.new_zeros((lay.nb, R - lay.rb, t))], dim=1)
    x = prod.reshape(lay.nb, R // lay.tr, lay.tr, t)
    acc = x[:, 0] + 0.0  # a row lane starts from +0
    for m in range(1, R // lay.tr):
        acc = acc + x[:, m]
    part.copy_(_fold_lanes(acc))


def cg_precond(U, G2, r, noise, z, part):
    """K10's second pass over U, the Woodbury solve's end: z = r / noise - U G2 (n, t) and the (nb, t) block
    partials of r . z in :func:`u_layout`'s blocks (nb of them, which cg_step_p and cg_init fold)."""
    if not U.is_cuda:
        return cg_precond_plain(U, G2, r, noise, z, part)
    build.require("cg_precond", (U, torch.float32), (G2, torch.float32), (r, torch.float32), (noise, torch.float32),
                  (z, torch.float32), (part, torch.float32))
    (n, k), t = U.shape, r.shape[1]
    lay = u_layout(n, k, t)
    if r.shape[0] != n or z.shape != r.shape or G2.shape != (k, t) or part.shape != (lay.nb, t) or not _aligned(U, r):
        raise ValueError("cg_precond: U, G2, r, z and the partials do not fit one (n, t) solve (or U, r are not "
                         "16-byte aligned)")
    rc = build.library().sgp_cg_precond(U.data_ptr(), G2.data_ptr(), r.data_ptr(), noise.data_ptr(), z.data_ptr(), n,
                                        k, t, lay.nb, lay.rb, lay.tr, lay.js, lay.tcb, part.data_ptr(),
                                        build.stream())
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
    (nb, t), or (P, nb, t) views of every rank's with the same P (K10'); r . z's may have another power of two
    of blocks (cg_precond's).
    """
    if not x.is_cuda:
        return cg_step_p_plain(part_rz, part_rr, x, z, p, x_best, fs, is_, A, B, TM, rules)
    n, t, rp, nb = _rows_cols(x)
    build.require("cg_step_p", *((a, torch.float32) for a in (x, z, p, x_best)))
    _require_state("cg_step_p", fs, is_, t)
    if not (z.shape == p.shape == x_best.shape == x.shape):
        raise ValueError("cg_step_p: the vectors do not fit one (n, t) solve")
    nb_rz = part_rz.shape[-2]
    (P, rz_stride), (P_rr, rr_stride) = _ranks(part_rz, nb_rz, t, "cg_step_p"), _ranks(part_rr, nb, t, "cg_step_p")
    if P_rr != P:
        raise ValueError(f"cg_step_p: partials of {P} and {P_rr} ranks")
    if rules.m > 0:
        build.require("cg_step_p", (A, torch.float32), (B, torch.float32), (TM, torch.int32))
        if not (A.shape == B.shape == TM.shape == (rules.m, t)):
            raise ValueError(f"cg_step_p: a record of {rules.m} steps needs (m, t) arrays")
    ptr = lambda a: a.data_ptr() if rules.m > 0 else None
    rc = build.library().sgp_cg_step_p(
        part_rz.data_ptr(), part_rr.data_ptr(), P, rz_stride, rr_stride, nb_rz, x.data_ptr(), z.data_ptr(),
        p.data_ptr(), x_best.data_ptr(), n, t, rp, nb, fs.data_ptr(), is_.data_ptr(), ptr(A), ptr(B), ptr(TM), rules.m,
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

    The partials are (nb, t), or (P, nb, t) views of every rank's (K10'); r0 . z0's may have another power of
    two of blocks (cg_precond's).
    """
    if not fs.is_cuda:
        return cg_init_plain(part_bb, part_rz, fs, is_, max_iters)
    nb, t = part_bb.shape[-2:]
    nb_rz = part_rz.shape[-2]
    _require_state("cg_init", fs, is_, t)
    if part_rz.dim() != part_bb.dim() or part_rz.shape[-1] != t:
        raise ValueError("cg_init: the two partials do not fit one solve")
    (P, bb_stride), (P_rz, rz_stride) = _ranks(part_bb, nb, t, "cg_init"), _ranks(part_rz, nb_rz, t, "cg_init")
    if P_rz != P:
        raise ValueError(f"cg_init: partials of {P} and {P_rz} ranks")
    rc = build.library().sgp_cg_init(part_bb.data_ptr(), part_rz.data_ptr(), P, bb_stride, rz_stride, nb, nb_rz, t,
                                     fs.data_ptr(), is_.data_ptr(), int(max_iters), build.stream())
    build.check(rc, "cg_init")
    cg_init.launches += 1


cg_init.launches = 0
