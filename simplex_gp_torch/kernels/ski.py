"""K13, the SKIP root: wrappers over ``csrc/ski.cu``, beside their plain versions, and their autograd bridges.

SKIP's root (models/ski.py) interpolates each dimension's grid eigenfactor
onto the points and multiplies the running rank-r root by it row by row,
truncating the rank-r^2 Khatri-Rao product M = R (.) F back to rank r by a
randomized range finder.  Four kernels carry it:

* K13a ``ski_interp``: Keys cubic weights of each point on the grid and the
  4-tap gather F = sum_t w[:, t] U[idx[:, t]]; ``ski_interp_backward``
  scatter-adds w (x) dF into dU in a fixed order (no atomics), which its
  plain version follows, so the two agree bit for bit;
* K13b ``ski_kr_matmul``: out = M W for W (r^2, k), M never formed;
* K13c ``ski_kr_gram``: out = Q^T M for Q (n, k), M never formed;
* K13d ``ski_kr_adjoint``: (dR, dF) of <G, M W>, i.e. dR[i, a] =
  sum_b F[i, b] (W G^T)[ab, i] and dF[i, b] = sum_a R[i, a] (W G^T)[ab, i].

Each wrapper takes its plain PyTorch version for CPU tensors and launches
the kernel for CUDA tensors, raising on a failed build or launch (no
fallback), and counts its launches in ``launches``.  The kernels take
r <= 64 and k <= 64 (the rank of the round-5 SKIP runs is 64); the plain
versions take any size.  :class:`SkiInterp`, :class:`KhatriRaoMatmul` and
:class:`KhatriRaoGram` are the ``torch.autograd.Function``s through which
``SKIP._root`` differentiates: K13a's backward is its scatter, K13b's is
K13d (and K13c for a W that needs a gradient), K13c's is K13b and K13d.
"""

from __future__ import annotations

import torch

from . import build

__all__ = [
    "interp_taps", "interp_plain", "interp_backward_plain", "kr_matmul_plain", "kr_gram_plain",
    "kr_adjoint_plain", "ski_interp", "ski_interp_backward", "ski_kr_matmul", "ski_kr_gram", "ski_kr_adjoint",
    "SkiInterp", "KhatriRaoMatmul", "KhatriRaoGram",
]

_MAX_R = 64  # SKI_MAX_R in csrc/ski.cu
_MAX_SCATTER = 12288  # floats of a (g, r) slice: K13a's backward keeps _SCATTER_SLICES of them in shared memory
_SCATTER_SLICES = 4  # SKI_SCATTER_SLICES in csrc/ski.cu: point sub-ranges of a K13a backward block
_SCATTER_BLOCKS = 132  # most blocks of K13a's backward (one an SM of an H100)
_SCATTER_MIN_SPAN = 16  # fewest points a sub-range takes
_GRAM_CHUNKS = 64  # most row chunks of K13c's first pass
_GRAM_MIN_ROWS = 1024  # fewest rows a chunk takes


def _cubic_kernel(s: torch.Tensor) -> torch.Tensor:
    """Keys cubic convolution weights (a = -0.5), |s| <= 2 (ski.py:38-43)."""
    s = torch.abs(s)
    w1 = (1.5 * s - 2.5) * s * s + 1.0
    w2 = ((-0.5 * s + 2.5) * s - 4.0) * s + 2.0
    return torch.where(s <= 1.0, w1, torch.where(s <= 2.0, w2, torch.zeros_like(s)))


def interp_taps(x: torch.Tensor, grid_min: torch.Tensor, grid_step: torch.Tensor, grid_size: int):
    """(idx (n, 4) int64, w (n, 4)): the 4-tap cubic interpolation of x onto the grid (ski.py:46-58)."""
    pos = (x - grid_min) / grid_step
    base = torch.floor(pos).to(torch.int32)
    idx = base[:, None] + torch.arange(-1, 3, dtype=torch.int32, device=x.device)[None, :]
    w = _cubic_kernel(pos[:, None] - idx.to(pos.dtype))
    idx = torch.clamp(idx, 0, grid_size - 1).long()
    total = ((w[:, 0] + w[:, 1]) + w[:, 2]) + w[:, 3]  # in order, as the kernels add them
    w = w / torch.clamp(total[:, None], min=1e-12)
    return idx, w


def interp_plain(x, grid_min, grid_step, U):
    """Plain K13a: F (n, r) = sum_t w[:, t] U[idx[:, t]] (ski.py:102, :108)."""
    idx, w = interp_taps(x, grid_min, grid_step, U.shape[0])
    return (w[:, :, None] * U[idx]).sum(dim=1)


def _scatter_split(n: int) -> tuple[int, int]:
    """(blocks, span) of K13a's backward: at most _SCATTER_BLOCKS blocks of _SCATTER_SLICES sub-ranges of span
    points each (at least _SCATTER_MIN_SPAN), sub-range q holding the points [q span, (q + 1) span)."""
    blocks = max(1, min(_SCATTER_BLOCKS, -(-n // (_SCATTER_SLICES * _SCATTER_MIN_SPAN))))
    span = max(1, -(-n // (blocks * _SCATTER_SLICES)))
    return max(1, -(-n // (_SCATTER_SLICES * span))), span


def interp_backward_plain(x, grid_min, grid_step, dF, grid_size: int):
    """Plain K13a backward: dU (g, r), the scatter-add of w[:, t] dF into the rows idx[:, t].

    In the kernel's order: each sub-range of points (:func:`_scatter_split`)
    adds its points in index order, each point's taps t = 0..3 in turn, into
    a (g, r) slice of its own; each block adds its _SCATTER_SLICES slices in
    order, and dU is the blocks' sums added in block order.
    """
    idx, w = interp_taps(x, grid_min, grid_step, grid_size)
    n, r = dF.shape
    blocks, span = _scatter_split(n)
    slices = torch.zeros((blocks * _SCATTER_SLICES, grid_size, r), dtype=dF.dtype, device=dF.device)
    sub = torch.arange(blocks * _SCATTER_SLICES, device=dF.device)
    for i in range(span):
        p = sub * span + i
        live = p < n
        q, p = sub[live], p[live]
        for t in range(4):
            rows = idx[p, t]
            slices[q, rows] = slices[q, rows] + w[p, t, None] * dF[p]
    parts = slices.reshape(blocks, _SCATTER_SLICES, grid_size, r)
    acc = parts[:, 0]
    for k in range(1, _SCATTER_SLICES):
        acc = acc + parts[:, k]
    out = torch.zeros((grid_size, r), dtype=dF.dtype, device=dF.device)
    for b in range(blocks):
        out = out + acc[b]
    return out


def kr_matmul_plain(R, F, W):
    """Plain K13b: M W for M = R (.) F (n, r^2), one (n, r) block of M at a time: sum_a R[:, a] (F W_a)."""
    r = R.shape[1]
    out = torch.zeros((R.shape[0], W.shape[1]), dtype=R.dtype, device=R.device)
    for a in range(r):
        out = out + R[:, a : a + 1] * (F @ W[a * r : (a + 1) * r])
    return out


def kr_gram_plain(Q, R, F):
    """Plain K13c: Q^T M (k, r^2) for M = R (.) F, one (n, r) block of M at a time."""
    return torch.cat([Q.T @ (R[:, a : a + 1] * F) for a in range(R.shape[1])], dim=1)


def kr_adjoint_plain(R, F, W, G):
    """Plain K13d: (dR, dF) of <G, M W> in R and F, with T_a = G W_a^T (n, r) one block at a time."""
    r = R.shape[1]
    dR = torch.empty_like(R)
    dF = torch.zeros_like(F)
    for a in range(r):
        T = G @ W[a * r : (a + 1) * r].T
        dR[:, a] = (F * T).sum(dim=1)
        dF = dF + R[:, a : a + 1] * T
    return dR, dF


def _check_rank(what: str, r: int, k: int):
    if r > _MAX_R or k > _MAX_R:
        raise ValueError(f"{what}: rank {r} and width {k} must each be at most {_MAX_R} for the kernel")


def ski_interp(x, grid_min, grid_step, U):
    """K13a: F (n, r) from the (n,) positions and the (g, r) grid factor; the grid's origin and step are
    0-d device tensors, read on the device."""
    if not x.is_cuda:
        return interp_plain(x, grid_min, grid_step, U)
    build.require("ski_interp", (x, torch.float32), (grid_min, torch.float32), (grid_step, torch.float32),
                  (U, torch.float32))
    n, (g, r) = x.shape[0], U.shape
    out = torch.empty((n, r), dtype=torch.float32, device=x.device)
    lib = build.library()
    build.check(lib.sgp_ski_interp(x.data_ptr(), grid_min.data_ptr(), grid_step.data_ptr(), U.data_ptr(), n, g, r,
                                   out.data_ptr(), build.stream()), "ski_interp")
    ski_interp.launches += 1
    return out


def ski_interp_backward(x, grid_min, grid_step, dF, grid_size: int):
    """K13a's backward: dU (g, r) += w[:, t] dF into the rows idx[:, t], in a fixed order with no atomics
    (:func:`interp_backward_plain`'s), so two calls give the same bits."""
    if not x.is_cuda:
        return interp_backward_plain(x, grid_min, grid_step, dF, grid_size)
    build.require("ski_interp_backward", (x, torch.float32), (grid_min, torch.float32),
                  (grid_step, torch.float32), (dF, torch.float32))
    n, r = dF.shape
    if grid_size * r > _MAX_SCATTER or r > _MAX_R:
        raise ValueError(f"ski_interp_backward: a ({grid_size}, {r}) slice exceeds {_MAX_SCATTER} floats or rank "
                         f"{_MAX_R}")
    blocks, span = _scatter_split(n)
    dU = torch.empty((grid_size, r), dtype=torch.float32, device=x.device)
    partial = dU if blocks == 1 else torch.empty((blocks, grid_size, r), dtype=torch.float32, device=x.device)
    lib = build.library()
    build.check(lib.sgp_ski_interp_scatter(x.data_ptr(), grid_min.data_ptr(), grid_step.data_ptr(), dF.data_ptr(),
                                           n, grid_size, r, span, blocks, partial.data_ptr(), dU.data_ptr(),
                                           build.stream()), "ski_interp_backward")
    ski_interp_backward.launches += 1
    return dU


def ski_kr_matmul(R, F, W):
    """K13b: (R (.) F) W, (n, k) for R, F (n, r) and W (r^2, k)."""
    if not R.is_cuda:
        return kr_matmul_plain(R, F, W)
    build.require("ski_kr_matmul", (R, torch.float32), (F, torch.float32), (W, torch.float32))
    n, r = R.shape
    k = W.shape[1]
    if F.shape != R.shape or W.shape[0] != r * r:
        raise ValueError(f"ski_kr_matmul: R {tuple(R.shape)}, F {tuple(F.shape)}, W {tuple(W.shape)}")
    _check_rank("ski_kr_matmul", r, k)
    out = torch.empty((n, k), dtype=torch.float32, device=R.device)
    lib = build.library()
    build.check(lib.sgp_ski_kr_matmul(R.data_ptr(), F.data_ptr(), W.data_ptr(), n, r, k, out.data_ptr(),
                                      build.stream()), "ski_kr_matmul")
    ski_kr_matmul.launches += 1
    return out


def _gram_chunks(n: int) -> tuple[int, int]:
    """(chunks, rows a chunk) of K13c's first pass: at most 64 chunks of at least 1,024 rows, a multiple of 32."""
    chunks = max(1, min(_GRAM_CHUNKS, -(-n // _GRAM_MIN_ROWS)))
    rows = -(-n // chunks)
    return chunks, -(-rows // 32) * 32


def ski_kr_gram(Q, R, F):
    """K13c: Q^T (R (.) F), (k, r^2) for Q (n, k) and R, F (n, r).

    Two passes, no atomics: each block sums one column block of the output
    over one row chunk into its own partial, then one thread per output
    entry adds the chunks' partials in chunk order, so the result repeats
    bit for bit.
    """
    if not R.is_cuda:
        return kr_gram_plain(Q, R, F)
    build.require("ski_kr_gram", (Q, torch.float32), (R, torch.float32), (F, torch.float32))
    n, r = R.shape
    k = Q.shape[1]
    if F.shape != R.shape or Q.shape[0] != n:
        raise ValueError(f"ski_kr_gram: Q {tuple(Q.shape)}, R {tuple(R.shape)}, F {tuple(F.shape)}")
    _check_rank("ski_kr_gram", r, k)
    chunks, rows = _gram_chunks(n)
    out = torch.empty((k, r * r), dtype=torch.float32, device=R.device)
    partial = out if chunks == 1 else torch.empty((chunks, k, r * r), dtype=torch.float32, device=R.device)
    lib = build.library()
    build.check(lib.sgp_ski_kr_gram(Q.data_ptr(), R.data_ptr(), F.data_ptr(), n, r, k, chunks, rows,
                                    partial.data_ptr(), out.data_ptr(), build.stream()), "ski_kr_gram")
    ski_kr_gram.launches += 1
    return out


def ski_kr_adjoint(R, F, W, G):
    """K13d: (dR, dF), each (n, r), of <G, (R (.) F) W> for W (r^2, k) and G (n, k); W G^T is never formed."""
    if not R.is_cuda:
        return kr_adjoint_plain(R, F, W, G)
    build.require("ski_kr_adjoint", (R, torch.float32), (F, torch.float32), (W, torch.float32), (G, torch.float32))
    n, r = R.shape
    k = W.shape[1]
    if F.shape != R.shape or W.shape[0] != r * r or G.shape != (n, k):
        raise ValueError(f"ski_kr_adjoint: R {tuple(R.shape)}, F {tuple(F.shape)}, W {tuple(W.shape)}, "
                         f"G {tuple(G.shape)}")
    _check_rank("ski_kr_adjoint", r, k)
    dR = torch.empty((n, r), dtype=torch.float32, device=R.device)
    dF = torch.empty((n, r), dtype=torch.float32, device=R.device)
    lib = build.library()
    build.check(lib.sgp_ski_kr_adjoint(R.data_ptr(), F.data_ptr(), W.data_ptr(), G.data_ptr(), n, r, k,
                                       dR.data_ptr(), dF.data_ptr(), build.stream()), "ski_kr_adjoint")
    ski_kr_adjoint.launches += 1
    return dR, dF


for _fn in (ski_interp, ski_interp_backward, ski_kr_matmul, ski_kr_gram, ski_kr_adjoint):
    _fn.launches = 0


class SkiInterp(torch.autograd.Function):
    """F = K13a(x, grid_min, grid_step, U), differentiable in U (the positions are data)."""

    @staticmethod
    def forward(ctx, x, grid_min, grid_step, U):
        ctx.save_for_backward(x, grid_min, grid_step)
        ctx.grid_size = U.shape[0]
        return ski_interp(x, grid_min, grid_step, U.contiguous())

    @staticmethod
    def backward(ctx, dF):
        x, grid_min, grid_step = ctx.saved_tensors
        return None, None, None, ski_interp_backward(x, grid_min, grid_step, dF.contiguous(), ctx.grid_size)


class KhatriRaoMatmul(torch.autograd.Function):
    """(R (.) F) W through K13b; the backward is K13d in R and F, and K13c for W."""

    @staticmethod
    def forward(ctx, R, F, W):
        R, F, W = R.contiguous(), F.contiguous(), W.contiguous()
        ctx.save_for_backward(R, F, W)
        return ski_kr_matmul(R, F, W)

    @staticmethod
    def backward(ctx, dout):
        R, F, W = ctx.saved_tensors
        dout = dout.contiguous()
        dR = dF = dW = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            dR, dF = ski_kr_adjoint(R, F, W, dout)
        if ctx.needs_input_grad[2]:
            dW = ski_kr_gram(dout, R, F).T
        return dR, dF, dW


class KhatriRaoGram(torch.autograd.Function):
    """Q^T (R (.) F) through K13c; the backward is K13b (dQ) and K13d (dR, dF) with W = dB^T."""

    @staticmethod
    def forward(ctx, Q, R, F):
        Q, R, F = Q.contiguous(), R.contiguous(), F.contiguous()
        ctx.save_for_backward(Q, R, F)
        return ski_kr_gram(Q, R, F)

    @staticmethod
    def backward(ctx, dB):
        Q, R, F = ctx.saved_tensors
        W = dB.T.contiguous()  # (r^2, k): W[ab, p] = dB[p, ab]
        dQ = ski_kr_matmul(R, F, W) if ctx.needs_input_grad[0] else None
        dR = dF = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dR, dF = ski_kr_adjoint(R, F, W, Q)
        return dQ, dR, dF
