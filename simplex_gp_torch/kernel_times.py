"""Time the plan and apply kernels at the elevators shapes, for an A/B between two trees.

    PYTHONPATH=<tree> python simplex_gp_torch/kernel_times.py
    PYTHONPATH=<tree> python simplex_gp_torch/kernel_times.py --count-splat
    PYTHONPATH=<tree> python simplex_gp_torch/kernel_times.py --wide-deriv
    python simplex_gp_torch/kernel_times.py --sharded-f64
    PYTHONPATH=<tree> python simplex_gp_torch/kernel_times.py --cg
    PYTHONPATH=<tree> python simplex_gp_torch/kernel_times.py --eval-stop PARAMS.json [--rows N]
    PYTHONPATH=<tree> python simplex_gp_torch/kernel_times.py --factor [--save DIR]
    python simplex_gp_torch/kernel_times.py --compare-factors DIR DIR
    PYTHONPATH=<tree> python simplex_gp_torch/kernel_times.py --axes
    PYTHONPATH=<tree> python simplex_gp_torch/kernel_times.py --dp-step
    PYTHONPATH=<tree> python simplex_gp_torch/kernel_times.py --mixture-sketch
    PYTHONPATH=<tree> python simplex_gp_torch/kernel_times.py --build-grad [--save DIR]
    python simplex_gp_torch/kernel_times.py --compare-build-grad DIR DIR
    PYTHONPATH=<tree> python simplex_gp_torch/kernel_times.py --step-grad DIR [--ulp K] [--tol T]
    python simplex_gp_torch/kernel_times.py --compare-step-grad DIR DIR
    PYTHONPATH=<tree> python simplex_gp_torch/kernel_times.py --once-sharded
    PYTHONPATH=<tree> python simplex_gp_torch/kernel_times.py --join-build

The second form times K8 ``lattice_count`` and K3'b ``chain_splat``
instead (:func:`count_splat`); the third K9 ``lattice_apply_cols`` and K7
``lattice_deriv_grad`` at the shapes of chip_smoke.py's phases 6.2 and 5.3
(:func:`wide_deriv`); the fourth measures how far K11b (a fixed order)
and K3's float32 atomic splat land from the float64 operator
(:func:`sharded_f64`); the
fifth one CG iteration at the elevators and houseelectric training shapes
and the houseelectric eval shape, K10 host-launched and replayed, or an
older tree's eager loop
(:func:`cg_iterations`), and with ``--eval-stop`` the houseelectric eval CG
at raw parameters read from a JSON file (chip_smoke.py 6.5 prints them), on
all training rows or the first N: its count, best residual and stop rule
(:func:`eval_stop`); the sixth K6's rank-100 factor, the preconditioner
stage and a warm training step at the elevators and houseelectric training
shapes (:func:`factor_steps`), with ``--save`` writing each factor's L and
pivots for the seventh form to compare two trees' bit for bit
(:func:`compare_factors`); the eighth K3'c's d+1 axis stencils, fused and
per axis (:func:`axes_times`); the ninth the data-parallel NLML step on two
gloo ranks sharing the card, its CG stage and its collectives, for one
Matern kernel and a J = 8 mixture (:func:`dp_step`); the tenth K12 at c =
1, 11 and 100, the mixture step, the elevators range sketch's apply (K3 and
K9 at two windows) and posterior_cache (:func:`mixture_sketch`); the
eleventh K3'a's build and K5 at the elevators and houseelectric shapes and
the houseelectric training step by stage (:func:`build_grad`), with
``--save`` writing each plan and gradient for the twelfth form to compare
two trees' bit for bit (:func:`compare_build_grad`); the thirteenth the
houseelectric step's raw gradients on the data and on K copies with every
entry of x moved by one ulp, at a CG tolerance T (:func:`step_grad`),
which the fourteenth compares within and across two trees
(:func:`compare_step_grad`); the fifteenth K4 at the elevators shape (c =
1 and 11), K11b on one NCCL rank at that shape (c =
1 and 11, beside K3 on the same plan, with the bytes per collective) and
the houseelectric one-shot MVM of ``mvm_err`` (:func:`once_sharded`); the
sixteenth K2 and the join plan's row build by kernel, launched and
replayed (:func:`join_build`).

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
import os
import subprocess
import time

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


def wide_deriv() -> dict:
    """K9 and K7 at the shapes of the main paths, as the path calls them, for an A/B of two trees.

    K9 at c = 100 on the join plans of all houseelectric training rows over
    their median lengthscale (Matern-1.5, order 1): untrimmed (chip_smoke.py
    6.2), at capacity = occupancy, and at the autotrimmed capacity 32,768
    (the range sketch's plan); at c = 101 on the untrimmed plan of [train;
    val] (the val predict's).  Each at windows of 8, 16 and 32 columns, with
    the peak memory of the call; a tree with row lists (``join_rows``) is
    timed with them built inside the call, as the predict calls K9, and
    given them, as the sketch's two MVMs share one build, and the build
    alone.  K7 at elevators (median-init positions of
    tests/fixtures/elevators_train_golden.npz, L = 11, 418 stacked columns)
    as the deriv-mode backward calls it, and its bit-equality to its plain
    version and to a second run.  Last, the device time of each kernel in
    one K9 call (untrimmed training plan, 32-column window, row lists
    given) and one K7 call, by ``torch.profiler``.  Prints one JSON line.
    """
    import pathlib

    import simplex_gp_torch
    from simplex_gp_torch import train as trainer
    from simplex_gp_torch.kernels import lattice as K
    from simplex_gp_torch.models.components import softplus
    from simplex_gp_torch.ops import kernels, lattice as L
    from simplex_gp_torch.utils import data

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device")
    dev = torch.device("cuda:0")
    root = pathlib.Path(__file__).resolve().parents[1]
    rows_of = getattr(K, "join_rows", None)
    out = {"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                  capture_output=True, text=True).stdout.strip(),
           "tree": simplex_gp_torch.__file__}
    dk = kernels.matern_kernel(1.5, 1)
    taps = list(dk.coeffs)
    gen = torch.Generator(device=dev).manual_seed(6)
    s = data.load_dataset("houseelectric")
    ell = trainer.median_lengthscale(s.train_x)
    xt = torch.from_numpy(s.train_x).to(dev) / ell
    xr = torch.cat([xt, torch.from_numpy(s.val_x).to(dev) / ell]).contiguous()
    d = xt.shape[1]
    norm = L.SLICE_NORM(d)
    E, a, _, _ = L._lattice_constants(d, dk.coeffs, dk.variance, dev)
    occ = int(K.lattice_count(xt, E, a))

    def peak(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 1e9

    def by_kernel(fn, reps):
        """Device ms a call of each kernel that ``fn`` launches."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return {e.key[:60]: e.device_time_total / 1e3 / reps for e in prof.key_averages() if e.device_time_total > 0}

    for case, pts, cap, c in (("train_untrimmed", xt, None, 100), ("train_occupancy", xt, occ, 100),
                              ("train_capacity_32768", xt, 32768, 100), ("rect_untrimmed", xr, None, 101)):
        plan = L.build_plan_join(pts, dk.coeffs, dk.variance, cap)
        v = torch.randn((pts.shape[0], c), generator=gen, device=dev)
        rec = dict(N=plan.seg_ids.numel(), M=plan.neighbors.shape[1], n_lattice=int(plan.n_lattice), c=c)
        rows = rows_of(*plan) if rows_of is not None else None
        if rows is not None:
            rec["join_rows_ms"] = _ms(lambda: rows_of(*plan), 5)
        for chunk in (8, 16, 32):
            r = dict(ms=_ms(lambda: K.lattice_apply_cols(*plan, v, taps, norm, chunk), 3),
                     peak_gb=peak(lambda: K.lattice_apply_cols(*plan, v, taps, norm, chunk)))
            if rows is not None:
                r["given_rows_ms"] = _ms(lambda: K.lattice_apply_cols(*plan, v, taps, norm, chunk, rows), 3)
            rec[f"w{chunk}"] = r
        if case == "train_untrimmed":
            rec["kernels_w32"] = by_kernel(lambda: K.lattice_apply_cols(*plan, v, taps, norm, 32,
                                                                        *(() if rows is None else (rows,))), 3)
            if rows is not None:
                rec["join_rows_kernels"] = by_kernel(lambda: rows_of(*plan), 3)
        out[f"k9_{case}"] = rec
        del plan, rows, v
    del xt, xr
    tg = np.load(root / "tests" / "fixtures" / "elevators_train_golden.npz")
    inv_ell = 1.0 / softplus(torch.from_numpy(tg["init_raw_lengthscale"]).to(dev))
    xe = torch.from_numpy(data.prepare_dataset(data._synthetic_uci("elevators"), "elevators").train_x).to(dev)
    ref = (xe * inv_ell).contiguous()
    n, d = ref.shape
    src = torch.randn((n, 11), generator=gen, device=dev)
    g = torch.randn((n, 11), generator=gen, device=dev)
    dplan = L.build_plan_join(ref, dk.deriv_coeffs, dk.deriv_variance)
    args = (ref, src, g, list(dk.deriv_coeffs), L.SLICE_NORM(d), 2.0 * dk.dk0)
    gk, gk2 = K.lattice_deriv_grad(*dplan, *args), K.lattice_deriv_grad(*dplan, *args)
    gp = K.deriv_grad_plain(dplan.seg_ids, dplan.weights, dplan.neighbors, *args)
    out["k7_elevators"] = dict(N=dplan.seg_ids.numel(), n_lattice=int(dplan.n_lattice), C=2 * 11 * (1 + d),
                               ms=_ms(lambda: K.lattice_deriv_grad(*dplan, *args), 10),
                               rel_to_plain=float((gk - gp).norm() / gp.norm()),
                               bit_equal=bool(torch.equal(gk, gp)), repeats=bool(torch.equal(gk, gk2)),
                               kernels=by_kernel(lambda: K.lattice_deriv_grad(*dplan, *args), 5))
    print(json.dumps(out), flush=True)
    return out


def sharded_f64(repeats: int = 150) -> dict:
    """Errors of K11b (on one rank), its plain version and K3 against the operator in float64.

    The widest case of tests/test_torch_kernels_cuda.py's sharded-apply test:
    16,599 seeded normal points in 17 dims scaled by 0.3, rbf order 1, c = 1
    and 11, forward and transposed, outputs and the read rows of the
    blurred tables, ``repeats`` applies each (K3's atomic order changes from
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
                pout, ptab = K.apply_sharded_plain(seg, w, nb, nl, v, dk.coeffs, norm, OneRank(), transpose, True)
                whole, wtab = K.lattice_apply(seg, w, nb, nl, v, dk.coeffs, norm, transpose, True)
                errs += [rel(kout, exact), rel(pout, exact), rel(whole, exact), rel(ktab[rows], etab[rows]),
                         rel(ptab[rows], etab[rows]), rel(wtab[rows], etab[rows])]
                pair = max(pair, float((kout - whole).norm() / whole.norm()))
        e = np.sort(np.array(errs))
        out[f"c{c}"] = dict(comparisons=len(e), median=float(np.median(e)), p99=float(e[int(0.99 * len(e))]),
                            max=float(e[-1]), k11b_vs_k3_max=pair)
    print(json.dumps(out), flush=True)
    return out


def cg_iterations(repeats: int = 2) -> dict:
    """K10: one CG iteration, the MVM included, at the elevators and houseelectric training shapes and the
    houseelectric eval shape, as ``_solve_system`` and ``posterior_cache`` pose them.

    Seeded synthetic stand-ins at their median-init lengthscales (elevators 10,623 x 18 with 10 probes,
    c = 11 and the 100-step record; houseelectric 1,311,539 x 11, capacity 32,768, with the same probes
    and record, or c = 1), the chain plan,
    the rank-100 preconditioner.  A tree whose cg_solve takes ``shift`` runs K10 host-launched (eager)
    and replayed from a CUDA graph; an older tree runs its eager torch-op loop.  Host clock around each
    solve, synchronised; ms per iteration = ms / iterations.  Then one more solve (the first mode) under
    ``torch.profiler``: the device time of each kernel (or op) over the whole solve, the largest ten, and any
    cuBLAS GEMM or GEMV among them; and the Woodbury solve's passes over U at the solve's width beside
    cuBLAS's U^T r and U G2 (:func:`_u_passes`).
    """
    import inspect

    import simplex_gp_torch
    from simplex_gp_torch import train as trainer
    from simplex_gp_torch.linalg import cg as CG
    from simplex_gp_torch.linalg import mll
    from simplex_gp_torch.linalg.pivoted_cholesky import precond_solve, precond_sqrt
    from simplex_gp_torch.models.components import init_raw_params
    from simplex_gp_torch.ops.filter import apply_plan_any, build_plan_any
    from simplex_gp_torch.utils import data

    dev = torch.device("cuda:0")
    fused = "shift" in inspect.signature(CG.cg_solve).parameters
    out = {"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                  capture_output=True, text=True).stdout.strip(),
           "tree": simplex_gp_torch.__file__, "k10": fused}
    elev = data.prepare_dataset(data._synthetic_uci("elevators"), "elevators")
    house = data.load_dataset("houseelectric")
    for tag, xs, ys, probes, cap, tol, m in (
            ("elevators training CG, c=11", elev.train_x, elev.train_y, 10, None, 1.0, 100),
            ("houseelectric training CG, c=11", house.train_x, house.train_y, 10, 32768, 1.0, 100),
            ("houseelectric eval CG, c=1", house.train_x, house.train_y, 0, 32768, 0.01, 0)):
        d = xs.shape[1]
        cfg = mll.BBMMConfig(precond_rank=100, num_probes=10, plan_capacity=cap)
        model = simplex_gp_torch.SimplexGP(num_dims=d, kernel="matern", nu=1.5, order=1, min_noise=0.1, bbmm=cfg,
                                           device=dev)
        model.load_raw(init_raw_params(d, lengthscale=trainer.median_lengthscale(xs)))
        x, y = torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev)
        with torch.no_grad():
            params = model.constrained()
            ref = (x * params["inv_ell"]).contiguous()
            plan = build_plan_any(ref, model.dk, cap)
            P = mll.build_precond(model.dk, cfg, params, ref, x.shape[0])
            rhs = (y - params["mean"])[:, None]
            if probes:
                z = torch.from_numpy(np.random.default_rng(1).choice([-1.0, 1.0], size=(x.shape[0], probes))
                                     .astype(np.float32)).to(dev)
                rhs = torch.cat([rhs, precond_sqrt(P, z)], dim=-1)
            s, noise = params["outputscale"], params["noise"]
            if fused:
                modes = {"eager": dict(graph=False), "graph": dict(graph=True)}
                solve = lambda kw: CG.cg_solve(lambda V: apply_plan_any(plan, V, model.dk), rhs, tol=tol,
                                               max_iters=500, precond=P, tridiag_m=m, shift=(s, noise), **kw)
            else:
                modes = {"eager": {}}
                solve = lambda kw: CG.cg_solve(lambda V: s * apply_plan_any(plan, V, model.dk) + noise * V, rhs,
                                               tol=tol, max_iters=500, precond=lambda V: precond_solve(P, V),
                                               tridiag_m=m)
            solve(next(iter(modes.values())))  # warm-up
            runs = []
            for _ in range(repeats):
                for name, kw in modes.items():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = solve(kw)
                    torch.cuda.synchronize()
                    ms = 1e3 * (time.perf_counter() - t0)
                    runs.append(dict(mode=name, ms=ms, iterations=int(res.iterations), ms_per_iteration=ms /
                                     int(res.iterations)))
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                solve(next(iter(modes.values())))
                torch.cuda.synchronize()
            by_kernel = sorted(((e.key[:60], e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                                if e.self_device_time_total > 0), key=lambda r: -r[1])
            blas = [r for r in by_kernel if any(w in r[0].lower() for w in ("gemm", "gemv", "cublas", "cutlass"))]
            u_passes = _u_passes(P, rhs)
        out[tag] = dict(solves=runs, profiled_device_ms=sum(r[1] for r in by_kernel), top_kernels_ms=by_kernel[:10],
                        blas_kernels_ms=blas, u_passes_graph_ms=u_passes)
        del plan, P, rhs, model, x, y
    print(json.dumps(out), flush=True)
    return out


def eval_stop(path: str, repeats: int = 2, rows: int = 0) -> dict:
    """The houseelectric eval CG (posterior_cache's solve: the chain plan of capacity 32,768, the rank-100
    preconditioner, tolerance 0.01, at most 500 iterations, replayed from a CUDA graph) at the raw parameters
    in ``path``, on the first ``rows`` training rows (0: all): its iterations, best residual and the rule that
    stopped it, ``repeats`` times, and the ms an iteration (tests/eval_stop_jax.py runs the same solve through
    JAX and the port on the CPU).  Any tree whose ``cg_solve`` takes ``shift`` and ``graph`` runs it."""
    import simplex_gp_torch
    from simplex_gp_torch.linalg import cg as CG
    from simplex_gp_torch.linalg import mll
    from simplex_gp_torch.ops.filter import apply_plan_any, build_plan_any
    from simplex_gp_torch.utils import data

    raw = json.load(open(path))
    dev = torch.device("cuda:0")
    house = data.load_dataset("houseelectric")
    cfg = mll.BBMMConfig(cg_tolerance=1.0, max_cg_iterations=500, max_lanczos_iterations=100, precond_rank=100,
                         num_probes=10, plan_capacity=32768)
    model = simplex_gp_torch.SimplexGP(num_dims=11, kernel="matern", nu=1.5, order=1, min_noise=0.1, bbmm=cfg,
                                       eval_cg_tolerance=0.01, device=dev)
    model.load_raw({k: np.asarray(v, dtype=np.float32) for k, v in raw.items()})
    cut = slice(0, rows or None)
    x = torch.from_numpy(np.ascontiguousarray(house.train_x[cut])).to(dev)
    y = torch.from_numpy(np.ascontiguousarray(house.train_y[cut])).to(dev)
    out = {"card": _card(), "tree": simplex_gp_torch.__file__, "params": path, "rows": x.shape[0], "solves": []}
    with torch.no_grad():
        params = model.constrained()
        ref = x * params["inv_ell"]
        plan = build_plan_any(ref, model.dk, cfg.plan_capacity)
        P = mll.build_precond(model.dk, cfg, params, ref, x.shape[0])
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sol = CG.cg_solve(lambda V: apply_plan_any(plan, V, model.dk), (y - params["mean"])[:, None],
                              tol=model.eval_cg_tolerance, max_iters=500, precond=P,
                              shift=(params["outputscale"], params["noise"]), graph=True)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            res = float(sol.residual_norm.mean())
            rule = ("max_iters" if sol.iterations >= 500 else "tolerance" if res < model.eval_cg_tolerance
                    else "stall guard")
            out["solves"].append(dict(iterations=sol.iterations, best_residual=res, stop=rule, ms=ms,
                                      ms_per_iteration=ms / max(1, sol.iterations)))
    print(json.dumps(out), flush=True)
    return out


def _u_passes(P, r) -> dict:
    """The Woodbury solve's two passes over U at r's width, CUDA-graph replays: K10's own (cg_utr, cg_fold,
    cg_precond, where the tree has them; the fold beside its one einsum) and cuBLAS's U^T r and U G2 of the same
    shapes, with the passes' byte bound (U and r read, the outputs written, over 3.35 TB/s)."""
    from simplex_gp_torch.kernels import cg as K10

    U = P.U.contiguous()
    (n, k), t = U.shape, r.shape[1]
    w = (P.s2 / (P.noise * (P.noise + P.s2)) / P.gamma).contiguous()
    G, H = torch.empty((k, t), device=r.device), torch.empty_like(r)
    torch.mm(U.T, r, out=G)
    out = {"mm_utr": _graph_ms(lambda: torch.mm(U.T, r, out=G), 10),
           "mm_ug": _graph_ms(lambda: torch.mm(U, G, out=H), 10),
           "utr_bound_ms": 1e3 * 4 * (n * k + n * t) / 3.35e12,
           "precond_bound_ms": 1e3 * 4 * (n * k + 2 * n * t) / 3.35e12}
    if hasattr(K10, "cg_utr"):
        lay = K10.u_layout(n, k, t)
        noise = P.noise.reshape(()).contiguous()
        part_g, G2 = torch.empty((lay.nb, k, t), device=r.device), torch.empty((k, t), device=r.device)
        z, part = torch.empty_like(r), torch.empty((lay.nb, t), device=r.device)
        out.update(cg_utr=_graph_ms(lambda: K10.cg_utr(U, r, part_g), 10),
                   cg_fold=_graph_ms(lambda: K10.cg_fold(part_g, w, G2), 10),
                   einsum_fold=_graph_ms(lambda: torch.einsum("j,bjc->jc", w, part_g), 10),
                   cg_precond=_graph_ms(lambda: K10.cg_precond(U, G2, r, noise, z, part), 10))
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
           # The first K1, a thread a point, where the tree keeps it beside the team kernel.
           "k1_per_thread": (_ms(lambda: K._geometry_per_thread(x, E, a), 50)
                             if hasattr(K, "_geometry_per_thread") else None),
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


def factor_steps(repeats: int = 5, save: str | None = None) -> dict:
    """K6's rank-100 factor and the training step around it, at the elevators and houseelectric training
    shapes (seeded synthetic stand-ins at their median-init lengthscales; houseelectric with capacity
    32,768), through entry points every tree has: ``pivoted_cholesky_features``, ``make_preconditioner``,
    ``mll.build_precond`` (the step's preconditioner stage) and one warm training step (zero_grad, NLML,
    backward, Adam).  CUDA events over ``repeats`` calls after a warm-up; the factor once more under
    ``torch.profiler``: its device time and its kernel launches.  With ``save``, each factor's L (n, 100)
    and pivots go to ``<save>/<shape>_L.npy`` and ``<save>/<shape>_pivots.npy``.
    """
    import simplex_gp_torch
    from simplex_gp_torch import train as trainer
    from simplex_gp_torch.linalg import mll
    from simplex_gp_torch.linalg.pivoted_cholesky import make_preconditioner, pivoted_cholesky_features
    from simplex_gp_torch.models.components import init_raw_params
    from simplex_gp_torch.utils import data
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda:0")
    out = {"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                  capture_output=True, text=True).stdout.strip(),
           "tree": simplex_gp_torch.__file__}
    elev = data.prepare_dataset(data._synthetic_uci("elevators"), "elevators")
    house = data.load_dataset("houseelectric")
    for tag, xs, ys, cap in (("elevators", elev.train_x, elev.train_y, None),
                             ("houseelectric", house.train_x, house.train_y, 32768)):
        d = xs.shape[1]
        cfg = mll.BBMMConfig(cg_tolerance=1.0, max_cg_iterations=500, max_lanczos_iterations=100, precond_rank=100,
                             num_probes=10, plan_capacity=cap)
        model = simplex_gp_torch.SimplexGP(num_dims=d, kernel="matern", nu=1.5, order=1, min_noise=0.1, bbmm=cfg,
                                           device=dev)
        raw = init_raw_params(d, lengthscale=trainer.median_lengthscale(xs))
        model.load_raw(raw)
        x, y = torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev)
        n = x.shape[0]
        with torch.no_grad():
            params = model.constrained()
            ref = (x * params["inv_ell"]).contiguous()
            s, noise = params["outputscale"], params["noise"]
            diag = s * torch.ones(n, device=dev)
            factor = lambda: pivoted_cholesky_features(ref, diag, model.dk.nu, s, 100)
            pc = factor()
            if save is not None:
                os.makedirs(save, exist_ok=True)
                np.save(os.path.join(save, f"{tag}_L.npy"), pc.L.cpu().numpy())
                np.save(os.path.join(save, f"{tag}_pivots.npy"), pc.pivots.cpu().numpy())
            rec = dict(factor_ms=_ms(factor, repeats),
                       make_preconditioner_ms=_ms(lambda: make_preconditioner(pc.L, noise, n), repeats),
                       build_precond_ms=_ms(lambda: mll.build_precond(model.dk, cfg, params, ref, n), repeats))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                factor()
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
            rec.update(factor_device_ms=sum(e.self_device_time_total for e in events) / 1e3,
                       factor_launches=sum(e.count for e in events))
        z = torch.from_numpy(np.random.default_rng(1).choice([-1.0, 1.0], size=(n, 10)).astype(np.float32)).to(dev)
        opt = torch.optim.Adam(model.parameters(), lr=0.1)

        def step():
            model.load_raw(raw)
            opt.zero_grad(set_to_none=True)
            model.nlml(x, y, probes=z).backward()
            opt.step()

        rec["step_ms"] = _ms(step, repeats)
        out[tag] = rec
        del model, x, y, ref, pc, z
    print(json.dumps(out), flush=True)
    return out


def compare_factors(a: str, b: str) -> dict:
    """Whether the factors that two ``--factor --save`` runs wrote are equal bit for bit, L and pivots, at
    each shape.  Prints one JSON line."""
    out = {}
    for tag in ("elevators", "houseelectric"):
        La, Lb = (np.load(os.path.join(t, f"{tag}_L.npy")) for t in (a, b))
        pa, pb = (np.load(os.path.join(t, f"{tag}_pivots.npy")) for t in (a, b))
        out[tag] = dict(L_bit_equal=La.shape == Lb.shape and La.tobytes() == Lb.tobytes(),
                        pivots_equal=bool(np.array_equal(pa, pb)), max_abs_diff=float(np.abs(La - Lb).max()))
    print(json.dumps(out), flush=True)
    return out


def axes_times(reps: int = 50) -> dict:
    """K3'c, the d+1 axis stencils of one chain apply, on the sort-chain plans of the elevators training
    rows at the median-init lengthscales (tests/fixtures/elevators_train_golden.npz) and of all
    houseelectric training rows over their median lengthscale at capacity 32,768, matern-1.5 order 1, at
    c = 1 and 11: the fused launch (``chain_axes``) and the d+1 per-axis launches (``chain_axis``) on the
    same splatted table, launched (CUDA events over ``reps`` calls) and replayed from a CUDA graph, and
    whether the two agree bit for bit over the live rows.  Prints one JSON line.
    """
    import pathlib

    import simplex_gp_torch
    from simplex_gp_torch import train as trainer
    from simplex_gp_torch.kernels import chain as KC
    from simplex_gp_torch.models.components import softplus
    from simplex_gp_torch.ops import kernels, lattice as L
    from simplex_gp_torch.utils import data

    dev = torch.device("cuda:0")
    root = pathlib.Path(__file__).resolve().parents[1]
    out = {"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                  capture_output=True, text=True).stdout.strip(),
           "tree": simplex_gp_torch.__file__}
    dk = kernels.matern_kernel(1.5, 1)
    taps = [float(t) for t in dk.coeffs]
    tg = np.load(root / "tests" / "fixtures" / "elevators_train_golden.npz")
    inv_ell = 1.0 / softplus(torch.from_numpy(tg["init_raw_lengthscale"]).to(dev))
    xe = torch.from_numpy(data.prepare_dataset(data._synthetic_uci("elevators"), "elevators").train_x).to(dev)
    s = data.load_dataset("houseelectric")
    xh = torch.from_numpy(s.train_x).to(dev) / trainer.median_lengthscale(s.train_x)
    gen = torch.Generator(device=dev).manual_seed(12)
    for tag, pts, cap in (("elevators", xe * inv_ell, None), ("houseelectric", xh, 32768)):
        plan = L.build_plan_chain(pts.contiguous(), dk.coeffs, dk.variance, cap)
        d = plan.gather.shape[0]
        live = min(int(plan.n_lattice), plan.cnt.shape[0])

        def loop(t):
            for j in range(d + 1):
                t = KC.chain_axis(t, plan.tapw[j], plan.gather[j] if j < d else None, plan.n_lattice, taps)
            return t

        for c in (1, 11):
            table = KC.chain_splat(plan, torch.randn((pts.shape[0], c), generator=gen, device=dev))
            work = table.clone()
            equal = torch.equal(KC.chain_axes(table.clone(), plan, taps)[:live], loop(table)[:live])
            out[f"{tag}_c{c}"] = dict(
                n_lattice=int(plan.n_lattice), capacity=plan.cnt.shape[0], bit_equal=equal,
                fused_ms=_ms(lambda: KC.chain_axes(work, plan, taps), reps),
                fused_graph_ms=_graph_ms(lambda: KC.chain_axes(work, plan, taps), 20),
                per_axis_ms=_ms(lambda: loop(table), reps // 2),
                per_axis_graph_ms=_graph_ms(lambda: loop(table), 10))
            del table, work
        del plan
    print(json.dumps(out), flush=True)
    return out


def mixture_sketch(reps: int = 20) -> dict:
    """K12 and the elevators range sketch, for an A/B of two trees (any tree with these entry points).

    K12: the J = 8 mixture plan of the elevators training rows at the median init of
    tests/fixtures/elevators_mixture_golden.npz (JAX's alphas and weights), its build
    (``build_plan_mixture``; with the row lists where the tree builds them, and the row build alone), the
    apply (``apply_plan_mixture``) at c = 1, 11 and 100 launched (CUDA events over ``reps`` calls) and
    replayed from a CUDA graph, its device time by kernel at c = 11 (``torch.profiler``), whether two applies
    and two NLML gradients repeat bit for bit, and a warm mixture training step (zero_grad, NLML, backward,
    Adam).  The sketch: the join plan of the elevators training rows at
    runs/r5/simplexgp_elevators_s0/model_best.pkl, c = 100: ``make_wide_filter``'s apply (the tree's
    route), K3 (``lattice_apply``) and K9 (``lattice_apply_cols`` with its row lists given) at windows of
    32 and 100, the row build; then ``posterior_cache`` at those parameters (host clock, synchronised),
    twice bit for bit.  Prints one JSON line.
    """
    import pathlib

    import simplex_gp_torch
    from simplex_gp_torch import convert
    from simplex_gp_torch.kernels import lattice as K
    from simplex_gp_torch.kernels import mixture as KM
    from simplex_gp_torch.linalg.mll import BBMMConfig
    from simplex_gp_torch.ops import filter as F, lattice as L
    from simplex_gp_torch.utils import data

    dev = torch.device("cuda:0")
    root = pathlib.Path(__file__).resolve().parents[1]
    out = {"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                  capture_output=True, text=True).stdout.strip(),
           "tree": simplex_gp_torch.__file__, "mixture_rows": hasattr(KM, "mixture_rows")}
    ds = data.prepare_dataset(data._synthetic_uci("elevators"), "elevators")
    x, y = torch.from_numpy(ds.train_x).to(dev), torch.from_numpy(ds.train_y).to(dev)
    n, d = x.shape
    golden = np.load(root / "tests" / "fixtures" / "elevators_mixture_golden.npz")
    init = {k: golden[f"init_{k}"] for k in ("raw_lengthscale", "raw_outputscale", "raw_noise", "mean")}
    cfg = BBMMConfig(cg_tolerance=1.0, max_cg_iterations=500, max_lanczos_iterations=100, precond_rank=100,
                     num_probes=10)
    model = convert.mixture_model_from_jax(init, golden["weights"], nu=1.5, order=1, min_noise=0.1, bbmm=cfg,
                                           device=dev)
    dk = model.dk
    gen = torch.Generator(device=dev).manual_seed(8)
    with torch.no_grad():
        ref = (x * model.constrained()["inv_ell"]).contiguous()
        build = lambda: L.build_plan_mixture(ref, dk.alphas, dk.base.coeffs, dk.base.variance)
        plan = build()
        k12 = dict(live=plan.live.tolist(), build_ms=_ms(build, 10))
        if out["mixture_rows"]:
            k12["row_build_ms"] = _ms(lambda: KM.mixture_rows(*plan[:4]), reps)
        for c in (1, 11, 100):
            v = torch.randn((n, c), generator=gen, device=dev)
            apply = lambda: L.apply_plan_mixture(plan, v, dk.base.coeffs, dk.weights)
            k12[f"c{c}"] = dict(ms=_ms(apply, reps), graph_ms=_graph_ms(apply, 10),
                                repeats=bool(torch.equal(apply(), apply())))
            if c == 11:
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        apply()
                    torch.cuda.synchronize()
                k12["c11_device_ms_by_kernel"] = sorted(
                    ((e.key[:50], e.self_device_time_total / 5e3, e.count / 5) for e in prof.key_averages()
                     if e.self_device_time_total > 0), key=lambda r: -r[1])[:8]
        del plan
    z = torch.from_numpy(np.random.default_rng(int(golden["seed_init"])).choice(
        [-1.0, 1.0], size=(n, cfg.num_probes)).astype(np.float32)).to(dev)
    grads = []
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        loss = model.nlml(x, y, probes=z)
        loss.backward()
        grads.append([loss.detach().clone()] + [p.grad.detach().clone() for p in model.parameters()])
    k12["nlml_gradients_repeat"] = all(torch.equal(a, b) for a, b in zip(*grads))
    opt = torch.optim.Adam(model.parameters(), lr=0.1)

    def step():
        opt.zero_grad(set_to_none=True)
        model.nlml(x, y, probes=z).backward()
        opt.step()

    k12["warm_step_ms"] = [_ms(step, 3) for _ in range(2)]
    out["k12"] = k12

    serve = simplex_gp_torch.SimplexGP(num_dims=d, kernel="matern", nu=1.5, order=1, min_noise=0.1, bbmm=cfg,
                                       eval_cg_tolerance=0.01, device=dev)
    serve.load_raw(convert.raw_params_from_numpy(convert.load_jax_params(
        root / "runs" / "r5" / "simplexgp_elevators_s0" / "model_best.pkl"), device=dev))
    sk = {}
    with torch.no_grad():
        ref = (x * serve.constrained()["inv_ell"]).contiguous()
        dk = serve.dk
        omega = torch.randn((n, 100), generator=gen, device=dev)
        kmv = F.make_wide_filter(ref, dk)
        plan = L.build_plan_join(ref, dk.coeffs, dk.variance)
        rows = K.join_rows(*plan)
        args = (*plan, omega, list(dk.coeffs), L.SLICE_NORM(d))
        sk.update(n_lattice=int(plan.n_lattice), make_wide_filter_ms=_ms(lambda: kmv(omega), reps),
                  k3_ms=_ms(lambda: K.lattice_apply(*args), reps), row_build_ms=_ms(lambda: K.join_rows(*plan), reps))
        for w in (32, 100):
            sk[f"k9_window_{w}_ms"] = _ms(lambda: K.lattice_apply_cols(*args, w, rows), reps)
            sk[f"k9_window_{w}_graph_ms"] = _graph_ms(lambda: K.lattice_apply_cols(*args, w, rows), 10)
        del plan, rows, kmv
    caches, times = [], []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        caches.append(serve.posterior_cache(x, y, generator=torch.Generator(device=dev).manual_seed(0)))
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    sk.update(posterior_cache_ms=times[1:], posterior_cache_repeats=all(
        torch.equal(caches[1][k], caches[2][k]) for k in ("alpha", "root_inv")))
    out["sketch"] = sk
    print(json.dumps(out), flush=True)
    return out


def _dp_rank(axis, case: dict) -> dict:
    """:func:`dp_step`'s rank body: the warm data-parallel NLML and gradient (``data_parallel_loss_fn``, no
    optimizer step) by CUDA events, the CG stage inside it (``mll.cg_solve`` wrapped: CUDA events around the
    solve), and from one more step with the axis's timed collectives its transport, its collectives, the
    CG's own and those between one MVM's end and the next one's start (an iteration's)."""
    import simplex_gp_torch
    from simplex_gp_torch.linalg import mll
    from simplex_gp_torch.parallel import data_parallel_loss_fn, replicate, shard_batch

    x, y, z = shard_batch(axis, case["x"], case["y"], case["z"])
    dev = x.device
    solve, cg = mll.cg_solve, {}

    def timed_solve(matmul, b, **kw):
        marks = []

        def mv(V):
            c0 = axis.stats["calls"]
            out_ = matmul(V)
            marks.append((c0, axis.stats["calls"]))
            return out_

        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        c0 = axis.stats["calls"]
        ev[0].record()
        res = solve(mv, b, **kw)
        ev[1].record()
        cg.update(events=ev, iterations=int(res.iterations),
                  collectives=axis.stats["calls"] - c0 - sum(b_ - a_ for a_, b_ in marks),
                  an_iteration=sorted({b0 - a1 for (_, a1), (b0, _) in zip(marks, marks[1:])}))
        return res

    mll.cg_solve = timed_solve
    out = {}
    for kind in ("matern", "mixture"):
        model = simplex_gp_torch.SimplexGP(num_dims=x.shape[1], kernel=kind, nu=1.5, order=1, min_noise=0.1,
                                           bbmm=mll.BBMMConfig(**case["cfg"]), device=dev,
                                           **(dict(mix_components=8) if kind == "mixture" else {}))
        model.load_raw(case["raw"])
        replicate(axis, model)
        step = data_parallel_loss_fn(model, axis)
        try:
            step(x, y, probes=z)  # warm-up
        except NotImplementedError as e:  # a tree whose sharded engine refuses a mixture (on every rank alike)
            out[kind] = {"error": str(e)}
            continue
        steps = []
        for _ in range(case["reps"]):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            step(x, y, probes=z)
            ev[1].record()
            torch.cuda.synchronize()
            steps.append(dict(step_ms=ev[0].elapsed_time(ev[1]), cg_ms=cg["events"][0].elapsed_time(cg["events"][1]),
                              cg_iters=cg["iterations"]))
        axis.timing = True
        axis.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(x, y, probes=z)
        torch.cuda.synchronize()
        timed_ms = 1e3 * (time.perf_counter() - t0)
        axis.timing = False
        out[kind] = dict(steps=steps, timed_step_ms=timed_ms, transport_ms=1e3 * axis.stats["seconds"],
                         transport_share=axis.stats["seconds"] * 1e3 / timed_ms, collectives_step=axis.stats["calls"],
                         transport_bytes=axis.stats["bytes"], cg_collectives=cg["collectives"],
                         cg_collectives_an_iteration=cg["an_iteration"], cg_iters=cg["iterations"])
    return out


def dp_step(nprocs: int = 2, reps: int = 3) -> dict:
    """The data-parallel NLML step at elevators' width on ``nprocs`` gloo ranks sharing card 0.

    The seeded stand-in's 10,622 training rows (a multiple of the ranks) x 18, the median-init
    lengthscale, Matern-1.5 order 1, rank-100 preconditioner, 10 seeded probes, training CG tol 1.0; then
    the same with a J = 8 mixture (its profile-fit weights).  Each rank's numbers from :func:`_dp_rank`;
    one JSON line with the card and the tree.  Any tree with ``data_parallel_loss_fn`` and a
    ``cg_solve`` that takes ``shift`` runs it (a tree without the sharded mixture records its refusal).
    """
    import simplex_gp_torch
    from simplex_gp_torch import train as trainer
    from simplex_gp_torch.models.components import init_raw_params
    from simplex_gp_torch.parallel import launch
    from simplex_gp_torch.utils import data

    elev = data.prepare_dataset(data._synthetic_uci("elevators"), "elevators")
    n = (elev.train_x.shape[0] // nprocs) * nprocs
    xs, ys = elev.train_x[:n], elev.train_y[:n]
    case = dict(x=xs, y=ys, reps=reps,
                z=np.random.default_rng(1).choice([-1.0, 1.0], size=(n, 10)).astype(np.float32),
                raw={k: np.asarray(v.cpu()) for k, v in
                     init_raw_params(xs.shape[1], lengthscale=trainer.median_lengthscale(xs)).items()},
                cfg=dict(cg_tolerance=1.0, max_cg_iterations=500, max_lanczos_iterations=100, precond_rank=100,
                         num_probes=10))
    t0 = time.perf_counter()
    ranks = launch(_dp_rank, nprocs, (case,), backend="gloo", device="cuda", timeout=900)
    out = {"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                  capture_output=True, text=True).stdout.strip(),
           "tree": simplex_gp_torch.__file__, "rows": n, "ranks": nprocs, "launch_s": time.perf_counter() - t0,
           "per_rank": ranks}
    print(json.dumps(out), flush=True)
    return out


def once_sharded(reps: int = 20) -> dict:
    """K4 and K11b at the elevators shape, the houseelectric ``mvm_err`` one-shot MVM; any tree with the sharded engine.

    K4 ``lattice_filter_once`` at c = 1 and 11 on kernel_times.py's seeded
    elevators positions (and whether two calls give the same bits); K11b, ``apply_plan_join(..., axis=...)``
    on one NCCL rank at the same positions (c = 1 and 11), beside K3 on the
    same plan, with the bytes each collective moves; then
    ``mvm_err.main`` at houseelectric (2,049,280 x 11, c = 1), its
    ts/lattice.
    """
    import shutil
    import tempfile

    import torch.distributed as dist

    import simplex_gp_torch
    from simplex_gp_torch import mvm_err
    from simplex_gp_torch.kernels import lattice as K
    from simplex_gp_torch.ops import kernels, lattice as L
    from simplex_gp_torch.parallel import build_plan_sharded_join, initialize_distributed, make_mesh

    dev = torch.device("cuda:0")
    n, d = 10623, 18
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(n, d)).astype(np.float32) / 4.2).to(dev)
    dk = kernels.matern_kernel(1.5, 1)
    E, a, oh1, oh2 = L._lattice_constants(d, dk.coeffs, dk.variance, dev)
    taps, norm, N = list(dk.coeffs), L.SLICE_NORM(d), n * (d + 1)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"card": _card(), "tree": simplex_gp_torch.__file__}
    for c in (1, 11):
        v = torch.randn((n, c), generator=gen, device=dev)
        k4 = lambda: K.lattice_filter_once(x, E, a, oh1, oh2, v, taps, norm, N)[0]
        first = k4()
        out[f"k4_c{c}"] = _ms(k4, reps)
        out[f"k4_repeat_c{c}"] = bool(torch.equal(k4(), first))
    tmp = tempfile.mkdtemp(prefix="kernel_times_nccl_")
    initialize_distributed(backend="nccl", init_method="file://" + os.path.join(tmp, "store"), rank=0, world_size=1,
                           device="cuda")
    try:
        axis = make_mesh()
        plan = build_plan_sharded_join(x, dk.coeffs, dk.variance, axis)
        out["n_lattice"], out["plan_rows"] = int(plan.n_lattice), int(plan.neighbors.shape[1])
        for c in (1, 11):
            v = torch.randn((n, c), generator=gen, device=dev)
            k11b = lambda: L.apply_plan_join(plan, v, dk.coeffs, axis=axis)
            first = k11b()
            out[f"k11b_c{c}"] = _ms(k11b, reps)
            out[f"k11b_repeat_c{c}"] = bool(torch.equal(k11b(), first))
            out[f"k3_same_plan_c{c}"] = _ms(lambda: K.lattice_apply(*plan[:4], v, taps, norm), reps)
            axis.timing = True
            axis.reset_stats()
            k11b()
            axis.timing = False
            out[f"k11b_bytes_per_collective_c{c}"] = axis.stats["bytes"] / max(1, axis.stats["calls"])
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    m = mvm_err.main(["--dataset", "houseelectric", "--order", "1", "--device", "cuda"])
    out["mvm_houseelectric_ts_lattice_s"] = m["ts/lattice"]
    print(json.dumps(out), flush=True)
    return out


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def _device_by_kernel(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: device ms and launches by kernel name, the device total,
    and the call's host wall time (synchronised) beside it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    by = {}
    for e in events:  # names cut to 90 characters; instantiations that share a prefix add up
        ms, count = by.get(e.key[:90], (0.0, 0))
        by[e.key[:90]] = (ms + e.self_device_time_total / 1e3, count + e.count)
    return dict(wall_ms=wall, device_ms=sum(e.self_device_time_total for e in events) / 1e3,
                launches=sum(e.count for e in events), by_kernel=dict(sorted(by.items(), key=lambda kv: -kv[1][0])))


def build_grad(repeats: int = 10, save: str | None = None) -> dict:
    """K3'a's plan build and K5's position gradient at the elevators and houseelectric shapes, and the
    houseelectric training step by stage, through entry points every tree with the sort-chain build has.

    Shapes: the seeded elevators stand-in's training rows at the median-init lengthscales
    (tests/fixtures/elevators_train_golden.npz), untrimmed, and the houseelectric stand-in's 1,311,539
    training rows over their median lengthscale at capacity 32,768 (the autotrimmed capacity).  K3'a
    (``chain_build`` given K1's outputs) and ``build_plan_chain`` (K1 + K3'a) by CUDA events, beside K1 and
    K1 + K2 (``build_plan_join``), and once under ``torch.profiler`` (device ms by kernel, launches, the
    host wall time), and by stage where the tree marks them (``chain_build_stage_times``).  K5 at c = 11 on the backward's trimmed join plan and its two K9 tables, random V
    and U.  The join plan's build by its parts (:func:`_join_build`).  The houseelectric step (zero_grad,
    NLML, backward, Adam) by CUDA events with its peak memory,
    and its plan stage (``build_plan_any``) and backward parts (join plan, row lists, K9, K9ᵀ, K5) one by
    one.  With ``save``, every plan field, K5's outputs and the step's raw gradients go to
    ``<save>/<shape>.npz``.  Prints one JSON line.
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
    out = {"card": _card(), "tree": simplex_gp_torch.__file__}
    dk = kernels.matern_kernel(1.5, 1)
    taps = [float(t) for t in dk.coeffs]
    tg = np.load(root / "tests" / "fixtures" / "elevators_train_golden.npz")
    inv_ell = 1.0 / softplus(torch.from_numpy(tg["init_raw_lengthscale"]).to(dev))
    elev = data.prepare_dataset(data._synthetic_uci("elevators"), "elevators")
    house = data.load_dataset("houseelectric")
    ell_h = trainer.median_lengthscale(house.train_x)
    for tag, xs, scale, cap in (("elevators", elev.train_x, inv_ell, None),
                                ("houseelectric", house.train_x, 1.0 / ell_h, 32768)):
        ref = (torch.from_numpy(xs).to(dev) * scale).contiguous()
        n, d = ref.shape
        E = torch.from_numpy(L.build_rotation(d, dk.variance)).to(dev)
        a = torch.from_numpy(L._hash_vectors(d)).to(dev)
        consts = torch.from_numpy(L._chain_consts(d)).to(dev)
        h1, h2, w, s = K.lattice_geometry(ref, E, a, with_s=True)
        build = lambda: KC.chain_build(h1, h2, s, w, consts, taps, cap)
        plan = build()
        rec = dict(N=h1.shape[0], Mc=plan.cnt.shape[0], n_lattice=int(plan.n_lattice),
                   k3a_ms=_ms(build, repeats),
                   k1_k3a_ms=_ms(lambda: L.build_plan_chain(ref, dk.coeffs, dk.variance, cap), repeats),
                   k1_ms=_ms(lambda: K.lattice_geometry(ref, E, a, with_s=True), repeats),
                   k1_k2_ms=_ms(lambda: L.build_plan_join(ref, dk.coeffs, dk.variance, cap), repeats))
        rec.update(_join_build(ref, dk, cap, repeats))
        rec["k3a_profile"] = _device_by_kernel(build)
        if hasattr(KC, "chain_build_stage_times"):  # a tree whose build marks its stages
            build()
            rec["k3a_stages"] = KC.chain_build_stage_times(build)
        # K5 on the backward's plan: the trimmed join plan with its row lists and K9's two tables.
        gen = torch.Generator(device=dev).manual_seed(9)
        V, U = (torch.randn((n, 11), generator=gen, device=dev) for _ in range(2))
        wp = L.wide_plan(L.build_plan_join(ref, dk.coeffs, dk.variance, cap))
        _, tf = L.apply_plan_rows(wp, V, dk.coeffs, return_table=True)
        _, tb = L.apply_plan_rows(wp, U, dk.coeffs, transpose=True, return_table=True)
        k5 = lambda: K.lattice_filter_grad(ref, E, wp.seg_ids, V, U, tf, tb, L.SLICE_NORM(d))
        grad = k5()
        rec.update(k5_ms=_ms(k5, 5 * repeats), k5_graph_ms=_graph_ms(k5, 20), k5_bit_repeat=bool(torch.equal(grad, k5())),
                   k5_n_lattice=int(wp.n_lattice), k5_table_rows=tf.shape[0])
        saved = {f"plan_{f}": getattr(plan, f).cpu().numpy() for f in KC.ChainPlan._fields}
        saved["k5_grad"] = grad.cpu().numpy()
        del plan, wp, tf, tb, V, U, h1, h2, w, s
        if tag == "houseelectric":
            rec.update(_house_step(ref, house, dk, cap, ell_h, repeats, saved))
        out[tag] = rec
        if save is not None:
            os.makedirs(save, exist_ok=True)
            np.savez(os.path.join(save, f"{tag}.npz"), **saved)
        del ref, saved
    print(json.dumps(out), flush=True)
    return out


def _join_build(ref, dk, cap, repeats) -> dict:
    """The join plan's build at one shape, by CUDA events: K2 alone (``lattice_dedup_neighbors``, bounded
    when ``cap`` is set), the row lists (``join_rows``) on its plan, K1 + K2 + rows through
    ``wide_plan(build_plan_join(...))``, and, in a tree that has it, the one-call ``build_wide_plan_join``;
    at a capacity also ``join_rows`` on the untrimmed plan.  Every tree with ``join_rows`` has the first three."""
    from simplex_gp_torch.kernels import lattice as K
    from simplex_gp_torch.ops import lattice as L

    d = ref.shape[1]
    E, a, oh1, oh2 = L._lattice_constants(d, dk.coeffs, dk.variance, ref.device)
    h1, h2, w = K.lattice_geometry(ref, E, a)
    seg, nb, nl = K.lattice_dedup_neighbors(h1, h2, oh1, oh2, cap)
    plan = L.LatticePlan(seg.reshape(-1, d + 1), w, nb, nl)
    rec = dict(join_M=nb.shape[1], join_n_lattice=int(nl),
               k2_ms=_ms(lambda: K.lattice_dedup_neighbors(h1, h2, oh1, oh2, cap), repeats),
               join_rows_ms=_ms(lambda: K.join_rows(*plan), repeats),
               k1_k2_rows_ms=_ms(lambda: L.wide_plan(L.build_plan_join(ref, dk.coeffs, dk.variance, cap)), repeats))
    if hasattr(L, "build_wide_plan_join"):
        rec["wide_plan_one_call_ms"] = _ms(lambda: L.build_wide_plan_join(ref, dk.coeffs, dk.variance, cap), repeats)
    del seg, nb, plan
    if cap is not None:
        full = L.build_plan_join(ref, dk.coeffs, dk.variance)
        rec.update(untrimmed_M=full.neighbors.shape[1], join_rows_untrimmed_ms=_ms(lambda: K.join_rows(*full), repeats))
    return rec


def join_build(repeats: int = 10) -> dict:
    """K2 and the join plan's row build by kernel, at the shapes of :func:`build_grad` (elevators untrimmed,
    with K11a on the same hashes; houseelectric at capacity 32,768, and ``join_rows`` on the untrimmed
    houseelectric plan): each call by
    CUDA events launched and by CUDA-graph replay (its device time without the host's), and one call under
    ``torch.profiler`` (device ms and launches by kernel).  Any tree with ``join_rows`` runs it; K2 with its rows
    from one call (``lattice_plan_rows``) where the tree has it.  Prints one JSON line."""
    import pathlib

    import simplex_gp_torch
    from simplex_gp_torch import train as trainer
    from simplex_gp_torch.kernels import lattice as K
    from simplex_gp_torch.models.components import softplus
    from simplex_gp_torch.ops import kernels, lattice as L
    from simplex_gp_torch.utils import data

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device")
    dev = torch.device("cuda:0")
    root = pathlib.Path(__file__).resolve().parents[1]
    out = {"card": _card(), "tree": simplex_gp_torch.__file__}
    dk = kernels.matern_kernel(1.5, 1)
    tg = np.load(root / "tests" / "fixtures" / "elevators_train_golden.npz")
    inv_ell = 1.0 / softplus(torch.from_numpy(tg["init_raw_lengthscale"]).to(dev))
    elev = data.prepare_dataset(data._synthetic_uci("elevators"), "elevators")
    house = data.load_dataset("houseelectric")
    for tag, xs, scale, cap in (("elevators", elev.train_x, inv_ell, None),
                                ("houseelectric", house.train_x, 1.0 / trainer.median_lengthscale(house.train_x),
                                 32768)):
        ref = (torch.from_numpy(xs).to(dev) * scale).contiguous()
        d = ref.shape[1]
        E, a, oh1, oh2 = L._lattice_constants(d, dk.coeffs, dk.variance, dev)
        h1, h2, w = K.lattice_geometry(ref, E, a)
        seg, nb, nl = K.lattice_dedup_neighbors(h1, h2, oh1, oh2, cap)
        plan = L.LatticePlan(seg.reshape(-1, d + 1), w, nb, nl)
        calls = {"k2": lambda: K.lattice_dedup_neighbors(h1, h2, oh1, oh2, cap),
                 "join_rows": lambda: K.join_rows(*plan)}
        if hasattr(K, "lattice_plan_rows"):
            calls["plan_rows_one_call"] = lambda: K.lattice_plan_rows(h1, h2, w, oh1, oh2, cap)
        if cap is None:  # K11a on the same hashes, as one rank holding every rank's would run it
            calls["k11a"] = lambda: K.lattice_dedup_ordered(h1, h2, oh1, oh2)
        else:
            full = L.build_plan_join(ref, dk.coeffs, dk.variance)
            calls["join_rows_untrimmed"] = lambda: K.join_rows(*full)
        rec = dict(N=h1.shape[0], M=nb.shape[1], n_lattice=int(nl))
        for name, fn in calls.items():
            rec[name] = dict(ms=_ms(fn, repeats), graph_ms=_graph_ms(fn, repeats), profile=_device_by_kernel(fn))
        out[tag] = rec
        del ref, h1, h2, w, seg, nb, plan, calls
    print(json.dumps(out), flush=True)
    return out


def _house_step(ref, house, dk, cap, ell, repeats, saved) -> dict:
    """The houseelectric training step (median init, capacity ``cap``): a warm step by CUDA events, its peak
    memory, its plan stage and the exact backward's parts one by one; the step's raw gradients into
    ``saved``."""
    import simplex_gp_torch
    from simplex_gp_torch.kernels import lattice as K
    from simplex_gp_torch.linalg import mll
    from simplex_gp_torch.models.components import init_raw_params
    from simplex_gp_torch.ops import lattice as L
    from simplex_gp_torch.ops.filter import build_plan_any

    dev = ref.device
    n, d = ref.shape
    cfg = mll.BBMMConfig(cg_tolerance=1.0, max_cg_iterations=500, max_lanczos_iterations=100, precond_rank=100,
                         num_probes=10, plan_capacity=cap)
    model = simplex_gp_torch.SimplexGP(num_dims=d, kernel="matern", nu=1.5, order=1, min_noise=0.1, bbmm=cfg,
                                       device=dev)
    raw = init_raw_params(d, lengthscale=ell)
    x, y = torch.from_numpy(house.train_x).to(dev), torch.from_numpy(house.train_y).to(dev)
    z = torch.from_numpy(np.random.default_rng(1).choice([-1.0, 1.0], size=(n, 10)).astype(np.float32)).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=0.1)

    def step():
        model.load_raw(raw)
        opt.zero_grad(set_to_none=True)
        model.nlml(x, y, probes=z).backward()
        opt.step()

    step()
    model.load_raw(raw)
    opt.zero_grad(set_to_none=True)
    model.nlml(x, y, probes=z).backward()
    for name, p in model.named_parameters():
        saved[f"step_grad_{name}"] = p.grad.cpu().numpy()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = dict(step_ms=_ms(step, max(2, repeats // 3)))
    rec["step_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["plan_stage_ms"] = _ms(lambda: build_plan_any(ref, dk, cap), repeats)
    gen = torch.Generator(device=dev).manual_seed(9)
    V, U = (torch.randn((n, 11), generator=gen, device=dev) for _ in range(2))
    E = torch.from_numpy(L.build_rotation(d, dk.variance)).to(dev)
    parts = {}
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        wp = L.build_plan_join(ref, dk.coeffs, dk.variance, cap)
        ev[1].record()
        wp = L.wide_plan(wp)
        ev[2].record()
        _, tf = L.apply_plan_rows(wp, V, dk.coeffs, return_table=True)
        ev[3].record()
        _, tb = L.apply_plan_rows(wp, U, dk.coeffs, transpose=True, return_table=True)
        ev[4].record()
        K.lattice_filter_grad(ref, E, wp.seg_ids, V, U, tf, tb, L.SLICE_NORM(d))
        ev[5].record()
        torch.cuda.synchronize()
        for i, nm in enumerate(("join_plan", "join_rows", "k9", "k9t", "k5")):
            parts.setdefault(f"backward_{nm}_ms", []).append(ev[i].elapsed_time(ev[i + 1]))
        if hasattr(L, "build_wide_plan_join"):  # the backward's route in a tree that has the one-call build
            parts.setdefault("backward_wide_plan_ms", []).append(
                _ms(lambda: L.build_wide_plan_join(ref, dk.coeffs, dk.variance, cap), 1))
    rec.update(parts)
    return rec


def compare_build_grad(a: str, b: str) -> dict:
    """Whether two ``--build-grad --save`` runs wrote the same bits: every plan field, K5's gradient and the
    houseelectric step's raw gradients, at each shape; each field that differs with its relative difference.
    Prints one JSON line."""
    out = {}
    for tag in ("elevators", "houseelectric"):
        A, B = np.load(os.path.join(a, f"{tag}.npz")), np.load(os.path.join(b, f"{tag}.npz"))
        differ = {}
        for k in sorted(set(A.files) | set(B.files)):
            if k not in A.files or k not in B.files or A[k].shape != B[k].shape:
                differ[k] = "missing or reshaped"
            elif A[k].tobytes() != B[k].tobytes():  # the relative difference, for a float field
                x, y = A[k].astype(np.float64), B[k].astype(np.float64)
                differ[k] = float(np.linalg.norm(x - y) / max(np.linalg.norm(y), 1e-300))
        out[tag] = dict(fields=len(A.files), differ=differ)
    print(json.dumps(out), flush=True)
    return out


def step_grad(save: str, ulps: int = 3, tol: float = 1.0) -> dict:
    """The houseelectric training step's raw gradients (median init, capacity 32,768, the probes and model of
    :func:`_house_step`, CG tolerance ``tol``) on the data and on ``ulps`` copies with every entry of x moved
    by one ulp, up in odd copies and down in even ones: how far float32 rounding alone moves them in this
    tree (x reaches the operator, so every column of the solve).  Writes
    ``<save>/step_grad.npz`` (copy i's gradient of each parameter under ``<i>_<name>``, copy 0 the data) and
    prints one JSON line with each copy's relative difference from copy 0, by parameter."""
    import simplex_gp_torch
    from simplex_gp_torch import train as trainer
    from simplex_gp_torch.linalg import mll
    from simplex_gp_torch.models.components import init_raw_params
    from simplex_gp_torch.utils import data

    dev = torch.device("cuda:0")
    house = data.load_dataset("houseelectric")
    n, d = house.train_x.shape
    cfg = mll.BBMMConfig(cg_tolerance=tol, max_cg_iterations=500, max_lanczos_iterations=100, precond_rank=100,
                         num_probes=10, plan_capacity=32768)
    model = simplex_gp_torch.SimplexGP(num_dims=d, kernel="matern", nu=1.5, order=1, min_noise=0.1, bbmm=cfg,
                                       device=dev)
    raw = init_raw_params(d, lengthscale=trainer.median_lengthscale(house.train_x))
    z = torch.from_numpy(np.random.default_rng(1).choice([-1.0, 1.0], size=(n, 10)).astype(np.float32)).to(dev)
    saved = {}
    out = {"card": _card(), "tree": simplex_gp_torch.__file__, "tol": tol, "rel_to_copy0": [], "cg_iters": []}
    y = torch.from_numpy(house.train_y).to(dev)
    for i in range(1 + ulps):
        xx = house.train_x if i == 0 else np.nextafter(house.train_x, np.float32(np.inf if i % 2 else -np.inf))
        model.load_raw(raw)
        model.zero_grad(set_to_none=True)
        stats = {}
        model.nlml(torch.from_numpy(np.ascontiguousarray(xx)).to(dev), y, probes=z, stats=stats).backward()
        out["cg_iters"].append(stats.get("cg_iters"))
        for name, p in model.named_parameters():
            saved[f"{i}_{name}"] = p.grad.cpu().numpy()
    names = [nm for nm, _ in model.named_parameters()]
    for i in range(1, 1 + ulps):
        out["rel_to_copy0"].append({nm: _rel(saved[f"{i}_{nm}"], saved[f"0_{nm}"]) for nm in names})
    os.makedirs(save, exist_ok=True)
    np.savez(os.path.join(save, "step_grad.npz"), **saved)
    print(json.dumps(out), flush=True)
    return out


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a.astype(np.float64), b.astype(np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def compare_step_grad(a: str, b: str) -> dict:
    """Two ``--step-grad`` runs (two trees): each parameter's gradient on the data in ``a`` against ``b``'s,
    beside the largest move that one ulp makes within each tree.  Prints one JSON line."""
    A, B = np.load(os.path.join(a, "step_grad.npz")), np.load(os.path.join(b, "step_grad.npz"))
    names = sorted({k.split("_", 1)[1] for k in A.files})
    out = {}
    for nm in names:
        within = lambda F: max((_rel(F[k], F[f"0_{nm}"]) for k in F.files if k.endswith(f"_{nm}") and
                                not k.startswith("0_")), default=None)
        out[nm] = dict(across=_rel(A[f"0_{nm}"], B[f"0_{nm}"]), within_a=within(A), within_b=within(B))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    import sys

    if "--count-splat" in sys.argv[1:]:
        count_splat()
    elif "--cg" in sys.argv[1:]:
        cg_iterations()
    elif "--eval-stop" in sys.argv[1:]:
        eval_stop(sys.argv[sys.argv.index("--eval-stop") + 1],
                  rows=int(sys.argv[sys.argv.index("--rows") + 1]) if "--rows" in sys.argv else 0)
    elif "--factor" in sys.argv[1:]:
        factor_steps(save=sys.argv[sys.argv.index("--save") + 1] if "--save" in sys.argv else None)
    elif "--compare-factors" in sys.argv[1:]:
        compare_factors(*sys.argv[sys.argv.index("--compare-factors") + 1:][:2])
    elif "--axes" in sys.argv[1:]:
        axes_times()
    elif "--wide-deriv" in sys.argv[1:]:
        wide_deriv()
    elif "--sharded-f64" in sys.argv[1:]:
        sharded_f64()
    elif "--dp-step" in sys.argv[1:]:
        dp_step()
    elif "--mixture-sketch" in sys.argv[1:]:
        mixture_sketch()
    elif "--join-build" in sys.argv[1:]:
        join_build()
    elif "--build-grad" in sys.argv[1:]:
        build_grad(save=sys.argv[sys.argv.index("--save") + 1] if "--save" in sys.argv else None)
    elif "--compare-build-grad" in sys.argv[1:]:
        compare_build_grad(*sys.argv[sys.argv.index("--compare-build-grad") + 1:][:2])
    elif "--step-grad" in sys.argv[1:]:
        step_grad(sys.argv[sys.argv.index("--step-grad") + 1],
                  ulps=int(sys.argv[sys.argv.index("--ulp") + 1]) if "--ulp" in sys.argv else 3,
                  tol=float(sys.argv[sys.argv.index("--tol") + 1]) if "--tol" in sys.argv else 1.0)
    elif "--compare-step-grad" in sys.argv[1:]:
        compare_step_grad(*sys.argv[sys.argv.index("--compare-step-grad") + 1:][:2])
    elif "--once-sharded" in sys.argv[1:]:
        once_sharded()
    else:
        main()
