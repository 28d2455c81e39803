"""The permutohedral lattice filter in plain PyTorch: the benchmark's own reference operator.

out = SLICE_NORM * S^T B_d ... B_0 S v over the lattice vertices that the
positions touch (the join formulation).  Vertices are found by their exact
integer keys: a random 64-bit linear hash sorts them, and every hash match
is checked key against key, so no two vertices ever merge.  The splat, the
d+1 axis blurs and the slice are index_add, gathers and sums; the weights
stay differentiable in the positions, so autograd gives the operator's
exact position gradient.

Frozen copies, each with its source:
- ``rotation``, ``canonical taps``: simplex_gp_torch/ops/lattice.py:119-148
  (SLICE_NORM, build_rotation) and ops/coeffs.py:78-110 (get_coeffs,
  tap_variance), with the Matern-nu value of ops/kernels.py:43-54;
- ``_elevate``, ``_simplex_rank``, ``simplex``: the plain K1 geometry,
  simplex_gp_torch/kernels/lattice.py:75-136, so that each point lands in
  the same simplex as in the program;
- the neighbour offsets: simplex_gp_torch/ops/lattice.py:166-181.

``q`` rounds the operands of every product: the identity for the
reference, :func:`tf32` for the control (products of operands rounded to
TF32, sums in float32, as tensor cores run float32 work in TF32).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["tf32", "ident", "slice_norm", "rotation", "matern_taps", "Lattice", "filter_rect", "vertex_hashes",
           "vertex_count"]


def ident(t: torch.Tensor) -> torch.Tensor:
    return t


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10 mantissa bits, to nearest, ties away from zero; the gradient
    passes through unrounded."""
    i = t.detach().contiguous().view(torch.int32)
    r = ((i + 0x1000) & -0x2000).view(torch.float32)
    return t + (r - t).detach() if t.requires_grad else r


def slice_norm(d: int) -> float:
    """1 / (1 + 2^-d) (ops/lattice.py:119-121)."""
    return 1.0 / (1.0 + 2.0 ** (-d))


def rotation(d: int, blur_variance: float) -> np.ndarray:
    """(d+1, d) elevation with the calibrated scale folded in (ops/lattice.py:124-147)."""
    scale = np.array([(d + 1) * math.sqrt(blur_variance + 1.0 / 6.0) / math.sqrt((i + 1) * (i + 2))
                      for i in range(d)], dtype=np.float64)
    E = np.zeros((d + 1, d), dtype=np.float64)
    for j in range(d):
        sx = np.zeros(d)
        sx[j] = scale[j]
        elevated = np.zeros(d + 1)
        elevated[d] = -d * sx[d - 1]
        for i in range(d - 1, 0, -1):
            elevated[i] = elevated[i + 1] - i * sx[i - 1] + (i + 2) * sx[i]
        elevated[0] = elevated[1] + 2 * sx[0]
        E[:, j] = elevated
    return E.astype(np.float32)


def _matern(tau: np.ndarray, nu: float) -> np.ndarray:
    """Matern-nu of distance (ops/kernels.py:43-54 at d2 = tau^2)."""
    d = np.abs(tau)
    e = np.exp(-np.sqrt(2 * nu) * d)
    poly = {0.5: 1.0, 1.5: np.sqrt(3) * d + 1.0, 2.5: np.sqrt(5) * d + 1.0 + (5.0 / 3.0) * d ** 2}[nu]
    return poly * e


def matern_taps(nu: float, order: int) -> tuple:
    """(taps (2r+1,) float32, their variance): the coverage-balanced sampling of ops/coeffs.py:31-110."""
    n, half = 10 ** 4, 30.0
    x = np.linspace(-half, half, n)
    fn_values = np.asarray(_matern(x, nu), dtype=np.float64)
    w = 2 * np.pi * np.fft.fftfreq(n, 2 * half / n)
    fft_values = np.absolute(np.fft.fft(fn_values) / (2 * np.pi * np.sqrt(n)))

    def coverage(s: float) -> float:
        a = s * (2 * order + 1) / 2.0
        spatial = fn_values[(-a <= x) & (x <= a)].sum() / fn_values.sum()
        spectral = fft_values[(-np.pi / s <= w) & (w <= np.pi / s)].sum() / fft_values.sum()
        return spatial - spectral

    lb, ub = 0.1, 9.0
    while ub - lb > 1e-4:
        guess = 0.5 * (ub + lb)
        lb, ub = (guess, ub) if coverage(guess) < 0.0 else (lb, guess)
    s = 0.5 * (ub + lb)
    taps = np.asarray(_matern(s * np.arange(-order, order + 1, dtype=np.float64), nu))
    taps = (taps / taps[order]).astype(np.float32)
    c = taps.astype(np.float64)
    i = np.arange(c.shape[0], dtype=np.float64)
    mean = (i * c).sum() / c.sum()
    return tuple(float(t) for t in taps), float((i * i * c).sum() / c.sum() - mean * mean)


def _elevate(x: torch.Tensor, E: torch.Tensor, q: Callable) -> torch.Tensor:
    """x @ E.T summed over the input dims in order (kernels/lattice.py:75-80)."""
    x, E = q(x), q(E)
    acc = x[:, 0:1] * E[:, 0]
    for k in range(1, x.shape[1]):
        acc = acc + x[:, k:k + 1] * E[:, k]
    return acc


def _simplex_rank(elevated: torch.Tensor, d: int):
    """The nearest remainder-0 point and each differential's rank (kernels/lattice.py:83-108)."""
    dp1 = d + 1
    v = elevated * (1.0 / dp1)
    up, down = torch.ceil(v), torch.floor(v)
    pick_up = (up * dp1 - elevated) < (elevated - down * dp1)
    greedy_div = torch.where(pick_up, up, down).to(torch.int32)
    coord_sum = greedy_div.sum(dim=-1, dtype=torch.int32)
    diff = elevated - greedy_div.to(elevated.dtype) * dp1
    di, dj = diff[:, :, None], diff[:, None, :]
    idx = torch.arange(dp1, device=elevated.device)
    rank = ((dj > di) | ((dj == di) & (idx[None, :] < idx[:, None]))).sum(dim=-1, dtype=torch.int32)
    r2 = rank + coord_sum[:, None]
    too_hi, too_lo = (r2 > d).to(torch.int32), (r2 < 0).to(torch.int32)
    return greedy_div - too_hi + too_lo, r2 - dp1 * too_hi + dp1 * too_lo


def simplex(x: torch.Tensor, E: torch.Tensor, q: Callable = ident):
    """(keys (n, d+1, d) int32, weights (n, d+1)): each point's simplex and barycentric weights
    (kernels/lattice.py:111-136); differentiable in x through the weights."""
    n, d = x.shape
    dp1 = d + 1
    elevated = _elevate(x, E, q)
    greedy_div, rank = _simplex_rank(elevated.detach(), d)
    greedy = greedy_div * dp1
    t = (elevated - greedy.to(elevated.dtype)) * (1.0 / dp1)
    zeros = torch.zeros((n, d + 2), dtype=t.dtype, device=x.device)
    bary = zeros.scatter(1, (d - rank).long(), t) - zeros.scatter(1, (d + 1 - rank).long(), t)
    weights = torch.cat([bary[:, :1] + (1.0 + bary[:, d + 1:]), bary[:, 1:dp1]], dim=1)
    rem = torch.arange(dp1, device=x.device, dtype=torch.int32)[None, :, None]
    keys = greedy[:, None, :d] + torch.where(rank[:, None, :d] < dp1 - rem, rem, rem - dp1)
    return keys, weights


def _offsets(d: int, order: int) -> np.ndarray:
    """(d+1, 2r, d) key offsets of the neighbours at taps -r..-1, 1..r along each axis (ops/lattice.py:166-181)."""
    taps = [t for t in range(-order, order + 1) if t != 0]
    off = np.zeros((d + 1, len(taps), d), dtype=np.int64)
    for j in range(d + 1):
        for ti, t in enumerate(taps):
            off[j, ti, :] = -t
            if j < d:
                off[j, ti, j] = t * d
    return off


def _multipliers(d: int, device) -> torch.Tensor:
    """Odd random 63-bit hash multipliers, one a coordinate (the benchmark's own constants)."""
    a = np.random.default_rng(0x6B).integers(1, 2 ** 62, size=d, dtype=np.int64) | 1
    return torch.from_numpy(a).to(device)


class Lattice:
    """The lattice of the vertices that ``pos`` (n, d) touches, with its neighbour lists.

    ``seg`` (n, d+1) are the vertex rows of each point's simplex, ``weights``
    its barycentric weights (differentiable in ``pos``), ``nbr`` (d+1, nl, 2r)
    the neighbour rows along each axis (nl where a neighbour is absent:
    the table's zero row).  ``n_lattice`` is the number of vertices.
    """

    def __init__(self, pos: torch.Tensor, taps: tuple, variance: float, q: Callable = ident):
        n, d = pos.shape
        dev = pos.device
        self.q, self.d, self.order = q, d, (len(taps) - 1) // 2
        self.taps = torch.tensor(taps, dtype=torch.float32, device=dev)
        self.variance = variance
        self.E = torch.from_numpy(rotation(d, variance)).to(dev)
        keys, self.weights = simplex(pos.to(torch.float32), self.E, q)
        flat = keys.reshape(n * (d + 1), d).long()
        a = _multipliers(d, dev)
        h = (flat * a).sum(-1)
        uniq, inv = torch.unique(h, return_inverse=True)
        nl = uniq.shape[0]
        rep = torch.empty(nl, dtype=torch.long, device=dev).scatter_(0, inv, torch.arange(n * (d + 1), device=dev))
        if not torch.equal(flat[rep][inv], flat):
            raise RuntimeError("two lattice keys share a 64-bit hash")
        self.seg, self.n_lattice = inv.reshape(n, d + 1), nl
        off = torch.from_numpy(_offsets(d, self.order)).to(dev)  # (d+1, 2r, d)
        nk = flat[rep][None, :, None, :] + off[:, None, :, :]  # (d+1, nl, 2r, d)
        nh = (nk * a).sum(-1)
        pos_ = torch.searchsorted(uniq, nh).clamp(max=nl - 1)
        hit = uniq[pos_] == nh
        if hit.any() and not torch.equal(flat[rep][pos_[hit]], nk[hit]):
            raise RuntimeError("a neighbour key shares a 64-bit hash with another vertex")
        self.nbr = torch.where(hit, pos_, nl)

    def live_weights(self, pos: torch.Tensor) -> torch.Tensor:
        """The barycentric weights of ``pos``, the plan's own positions, with their autograd graph."""
        return simplex(pos, self.E, self.q)[1]

    def apply(self, v: torch.Tensor, weights: Optional[torch.Tensor] = None, src_rows: Optional[int] = None,
              dst: Optional[slice] = None) -> torch.Tensor:
        """K v for v (rows, c): splat v's rows (the first ``src_rows`` points, all by default), blur, slice at the
        points ``dst`` (all by default).  ``weights`` overrides the plan's (the autograd path passes live ones)."""
        q, d = self.q, self.d
        w = self.weights if weights is None else weights
        n_src = v.shape[0] if src_rows is None else src_rows
        c = v.shape[1]
        contrib = (q(v[:n_src])[:, None, :] * q(w[:n_src])[:, :, None]).reshape(-1, c)
        table = torch.zeros((self.n_lattice + 1, c), dtype=torch.float32, device=v.device)
        table = table.index_add(0, self.seg[:n_src].reshape(-1), contrib)
        qt = q(self.taps)
        for j in range(d + 1):
            acc = qt[self.order] * q(table[:-1])
            for ti, t in enumerate([t for t in range(-self.order, self.order + 1) if t != 0]):
                acc = acc + qt[t + self.order] * q(table[self.nbr[j, :, ti]])
            table = torch.cat([acc, table[-1:]])
        seg, wd = (self.seg, w) if dst is None else (self.seg[dst], w[dst])
        return (q(table[seg]) * q(wd)[:, :, None]).sum(dim=1) * slice_norm(d)

    def apply_blocks(self, v: torch.Tensor, cols: int = 16, **kw) -> torch.Tensor:
        """:meth:`apply` a block of ``cols`` columns at a time (columns do not interact), with no graph."""
        with torch.no_grad():
            return torch.cat([self.apply(v[:, c0:c0 + cols], **kw) for c0 in range(0, v.shape[1], cols)], dim=1)


def filter_rect(src: torch.Tensor, x_from: torch.Tensor, x_to: torch.Tensor, taps: tuple, variance: float,
                q: Callable = ident, cols: int = 16) -> torch.Tensor:
    """K(x_to, x_from) @ src: one lattice over [x_from; x_to], src splatted from the first rows, sliced at the rest."""
    lat = Lattice(torch.cat([x_from, x_to]), taps, variance, q)
    n = x_from.shape[0]
    return lat.apply_blocks(src, cols, src_rows=n, dst=slice(n, None))


def vertex_hashes(pos: torch.Tensor, variance: float) -> torch.Tensor:
    """The sorted distinct 64-bit hashes of the vertices that ``pos`` touches (the benchmark's own count)."""
    n, d = pos.shape
    E = torch.from_numpy(rotation(d, variance)).to(pos.device)
    with torch.no_grad():
        keys, _ = simplex(pos.to(torch.float32), E)
        return torch.unique((keys.reshape(-1, d).long() * _multipliers(d, pos.device)).sum(-1))


def vertex_count(pos: torch.Tensor, variance: float) -> int:
    """n_lattice: the number of vertices that ``pos`` touches."""
    return int(vertex_hashes(pos, variance).shape[0])
