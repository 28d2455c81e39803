"""Time the plan and apply kernels at the elevators shapes, for an A/B between two trees.

    PYTHONPATH=<tree> python simplex_gp_torch/kernel_times.py
    PYTHONPATH=<tree> python simplex_gp_torch/kernel_times.py --count-splat
    python simplex_gp_torch/kernel_times.py --sharded-f64

The second form times K8 ``lattice_count`` and K3'b ``chain_splat``
instead (:func:`count_splat`); the third measures how far K11b and K3's
float32 atomic splats land from the float64 operator (:func:`sharded_f64`).

Run as a file, it imports ``simplex_gp_torch`` from ``PYTHONPATH``, so one
copy of this script times any tree whose kernels keep these entry points
(K1 ``lattice_geometry``, K2 ``lattice_dedup_neighbors``, K3
``lattice_apply``, K4 ``lattice_filter_once``, K6 ``pivot_column``: one
step at j = 99 after 99 pivots, as the rank-100 preconditioner's last).  Inputs are seeded normal
positions of the elevators training shape (10,623 x 18) scaled to the
median-init lengthscale, and, for K3 at c = 1 with the device busy, 200,000
seeded points in 11 dims; times are CUDA events over repeated launches after
a warm-up.  Prints one JSON line with the card, the tree and the times in ms.
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch


def _ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(fn, reps: int) -> float:
    """Device time of ``fn``: ``reps`` calls captured in one CUDA graph, replayed after a warm-up."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def count_splat() -> dict:
    """K8 and K3'b at the shapes of the main paths, beside their PyTorch yardsticks.

    K8 on all rows of the seeded houseelectric stand-in (2,049,280 x 11,
    rbf order 1) and on as many copies of its first row (one key set, the
    hot-key case), against K1 and one ``torch.unique`` of K1's packed keys,
    and the wrapper's table fill alone; the counts against ``count_plain``.
    K3'b on the sort-chain plans of the elevators training rows at the
    median-init lengthscales (tests/fixtures/elevators_train_golden.npz), of
    the precipitation training rows (1.6M contributions) and the first
    350,000 houseelectric training rows (4.2M), each over its median
    lengthscale, untrimmed, and of all houseelectric training rows at
    capacity 32,768 and untrimmed: CUDA-graph replay times at c = 1, 8, 9
    and 11 and a ``torch.sparse`` CSR product of the same splat matrix at
    c = 1 and 11, the table against ``chain_splat_plain`` over the live rows
    (where that fits in memory: a tree whose plain splat sums over every
    table row skips the untrimmed plan).  Prints one JSON line.
    """
    import pathlib

    import simplex_gp_torch
    from simplex_gp_torch import train as trainer
    from simplex_gp_torch.kernels import chain as KC
    from simplex_gp_torch.kernels import lattice as K
    from simplex_gp_torch.models.components import softplus
    from simplex_gp_torch.ops import kernels, lattice as L
    from simplex_gp_torch.utils import data

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device")
    dev = torch.device("cuda:0")
    root = pathlib.Path(__file__).resolve().parents[1]
    out = {"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                  capture_output=True, text=True).stdout.strip(),
           "tree": simplex_gp_torch.__file__}
    rbf = kernels.rbf_kernel(1)
    s = data.load_dataset("houseelectric")
    x = torch.from_numpy(np.concatenate([s.train_x, s.val_x, s.test_x])).to(dev)
    E, a, _, _ = L._lattice_constants(x.shape[1], rbf.coeffs, rbf.variance, dev)
    hot = x[:1].expand(x.shape[0], -1).contiguous()
    h1, h2, _ = K.lattice_geometry(x, E, a)
    slots = K._table_slots(x.shape[0] * (x.shape[1] + 1))
    out["k8"] = dict(count=int(K.lattice_count(x, E, a)), plain=int(K.count_plain(x, E, a)),
                     ms=_ms(lambda: K.lattice_count(x, E, a), 10),
                     hot_count=int(K.lattice_count(hot, E, a)), hot_plain=int(K.count_plain(hot, E, a)),
                     hot_ms=_ms(lambda: K.lattice_count(hot, E, a), 10),
                     k1_ms=_ms(lambda: K.lattice_geometry(x, E, a), 10),
                     unique_ms=_ms(lambda: torch.unique(K._pack(h1, h2)).numel(), 5),
                     fill_ms=_ms(lambda: torch.full((slots,), -2, dtype=torch.int64, device=dev), 10))
    del x, hot, h1, h2
    dk = kernels.matern_kernel(1.5, 1)
    tg = np.load(root / "tests" / "fixtures" / "elevators_train_golden.npz")
    inv_ell = 1.0 / softplus(torch.from_numpy(tg["init_raw_lengthscale"]).to(dev))
    xe = torch.from_numpy(data.prepare_dataset(data._synthetic_uci("elevators"), "elevators").train_x).to(dev)
    xh = torch.from_numpy(s.train_x).to(dev) / trainer.median_lengthscale(s.train_x)
    xp = data.load_dataset("precipitation").train_x
    xp = torch.from_numpy(xp).to(dev) / trainer.median_lengthscale(xp)
    gen = torch.Generator(device=dev).manual_seed(3)
    for case, pts, cap in (("elevators", xe * inv_ell, None), ("precipitation", xp, None),
                           ("houseelectric_350k", xh[:350_000], None), ("houseelectric", xh, 32768),
                           ("houseelectric_untrimmed", xh, None)):
        pts = pts.contiguous()
        plan = L.build_plan_chain(pts, dk.coeffs, dk.variance, cap)
        live = min(int(plan.n_lattice), plan.cnt.shape[0])
        crow = torch.cat([plan.cnt.new_zeros(1), plan.cnt]).long()
        csr = torch.sparse_csr_tensor(crow, plan.splat_points.long(), plan.splat_weights,
                                      size=(plan.cnt.shape[0], pts.shape[0]))
        rec = dict(N=plan.splat_points.shape[0], Mc=plan.cnt.shape[0], n_lattice=int(plan.n_lattice))
        for c in (1, 8, 9, 11):
            v = torch.randn((pts.shape[0], c), generator=gen, device=dev)
            r = dict(graph_ms=_graph_ms(lambda: KC.chain_splat(plan, v), 20))
            if cap is not None or hasattr(KC, "run_lists"):
                r["bit_equal"] = bool(torch.equal(KC.chain_splat(plan, v)[:live], KC.chain_splat_plain(plan, v)[:live]))
            if c in (1, 11):
                r["csr_graph_ms"] = _graph_ms(lambda: csr @ v, 20)
            rec[f"c{c}"] = r
        out[f"k3b_{case}"] = rec
        del plan, csr
    print(json.dumps(out), flush=True)
    return out


def sharded_f64(repeats: int = 150) -> dict:
    """Errors of K11b (on one rank), its plain version and K3 against the operator in float64.

    The widest case of tests/test_torch_kernels_cuda.py's sharded-apply test:
    16,599 seeded normal points in 17 dims scaled by 0.3, rbf order 1, c = 1
    and 11, forward and transposed, outputs and the read rows of the
    blurred tables, ``repeats`` applies each (the atomic order changes from
    run to run).  Prints one JSON line of each column count's median, 99th
    percentile and largest relative error, and the largest between K11b and
    K3 themselves.
    """
    from simplex_gp_torch.kernels import lattice as K
    from simplex_gp_torch.ops import kernels, lattice as L

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device")
    dev = torch.device("cuda:0")

    class OneRank:  # the data axis of one rank: the collectives are identities
        rank, size = 0, 1

        def psum_scatter(self, blocks):
            return blocks[0]

        def all_gather_blocks(self, t):
            return t[None]

    n, d = 16599, 17
    x = (torch.from_numpy(np.random.default_rng(11).normal(size=(n, d)).astype(np.float32)) * 0.3).to(dev)
    dk = kernels.rbf_kernel(1)
    E, a, oh1, oh2 = L._lattice_constants(d, dk.coeffs, dk.variance, dev)
    h1, h2, w = K.lattice_geometry(x, E, a)
    seg, nb, nl = K.lattice_dedup_ordered(h1, h2, oh1, oh2)
    seg = seg.reshape(n, d + 1)
    rows, norm = seg.long(), L.SLICE_NORM(d)
    rel = lambda got, want: float((got.double() - want).norm() / want.norm())
    out = {"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                  capture_output=True, text=True).stdout.strip(), "repeats": repeats}
    for c in (1, 11):
        v = torch.randn((n, c), generator=torch.Generator(device=dev).manual_seed(c), device=dev)
        errs, pair = [], 0.0
        for transpose in (False, True):
            exact, etab = K.apply_plain(seg, w, nb, v.double(), dk.coeffs, norm, transpose, True)
            for _ in range(repeats):
                kout, ktab = K.lattice_apply_sharded(seg, w, nb, nl, v, dk.coeffs, norm, OneRank(), transpose, True)
                pout, ptab = K.apply_sharded_plain(seg, w, nb, v, dk.coeffs, norm, OneRank(), transpose, True)
                whole, wtab = K.lattice_apply(seg, w, nb, nl, v, dk.coeffs, norm, transpose, True)
                errs += [rel(kout, exact), rel(pout, exact), rel(whole, exact), rel(ktab[rows], etab[rows]),
                         rel(ptab[rows], etab[rows]), rel(wtab[rows], etab[rows])]
                pair = max(pair, float((kout - whole).norm() / whole.norm()))
        e = np.sort(np.array(errs))
        out[f"c{c}"] = dict(comparisons=len(e), median=float(np.median(e)), p99=float(e[int(0.99 * len(e))]),
                            max=float(e[-1]), k11b_vs_k3_max=pair)
    print(json.dumps(out), flush=True)
    return out


def main() -> dict:
    import simplex_gp_torch
    from simplex_gp_torch.kernels import lattice as K
    from simplex_gp_torch.kernels.pivot import pivot_column
    from simplex_gp_torch.ops import kernels, lattice as L

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device")
    dev = torch.device("cuda:0")
    n, d = 10623, 18
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(n, d)).astype(np.float32) / 4.2).to(dev)
    dk = kernels.matern_kernel(1.5, 1)
    E, a, oh1, oh2 = L._lattice_constants(d, dk.coeffs, dk.variance, dev)
    taps, norm, N = list(dk.coeffs), L.SLICE_NORM(d), n * (d + 1)
    h1, h2, w = K.lattice_geometry(x, E, a)
    seg, nb, nl = K.lattice_dedup_neighbors(h1, h2, oh1, oh2)
    seg = seg.reshape(n, d + 1)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                  capture_output=True, text=True).stdout.strip(),
           "tree": simplex_gp_torch.__file__, "n_lattice": int(nl),
           "k1": _ms(lambda: K.lattice_geometry(x, E, a), 50),
           "k2": _ms(lambda: K.lattice_dedup_neighbors(h1, h2, oh1, oh2), 50)}
    k, s = 100, torch.tensor(1.0, device=dev)
    diag, Lf = torch.ones(n, device=dev), torch.zeros((n, k), device=dev)
    piv, d0 = torch.zeros(k, dtype=torch.int64, device=dev), diag.max()
    for j in range(k - 1):
        diag = pivot_column(x, Lf, diag, torch.argmax(diag), j, s, d0, dk.nu, piv)
    p = torch.argmax(diag)
    out["k6"] = _ms(lambda: pivot_column(x, Lf, diag, p, k - 1, s, d0, dk.nu, piv), 200)
    for c in (1, 11, 100):
        v = torch.randn((n, c), generator=gen, device=dev)
        out[f"k3_c{c}"] = _ms(lambda: K.lattice_apply(seg, w, nb, nl, v, taps, norm), 50)
        if c <= 11:
            out[f"k4_c{c}"] = _ms(lambda: K.lattice_filter_once(x, E, a, oh1, oh2, v, taps, norm, N), 50)
    # K3 at c = 1 where the device, not the launches, takes the time: 200,000 points in 11 dims.
    xb = torch.from_numpy(np.random.default_rng(1).normal(size=(200_000, 11)).astype(np.float32) / 3.2).to(dev)
    plan = L.build_plan_join(xb, dk.coeffs, dk.variance)
    vb = torch.randn((200_000, 1), generator=gen, device=dev)
    out["k3_c1_n200k_d11"] = _ms(lambda: K.lattice_apply(*plan, vb, taps, L.SLICE_NORM(11)), 50)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    import sys

    if "--count-splat" in sys.argv[1:]:
        count_splat()
    elif "--sharded-f64" in sys.argv[1:]:
        sharded_f64()
    else:
        main()
