#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one CUDA card, and check them.

    python3 chip_smoke.py

Phases, each printed as it runs:
  1. the card (nvidia-smi name and power limit) and the kernel build time;
  2. each hand-written kernel against its plain PyTorch version at the shapes
     of the elevators serving path: K1 lattice_geometry, K2
     lattice_dedup_neighbors, K3 lattice_apply at c = 1, 100 and 101, K6
     pivot_column at rank 100;
  3. the slice: SimplexGP.posterior_cache on the 10,623 elevators training
     rows and predict_from_cache on the 3,320 test rows, with the trained
     parameters of runs/r5/simplexgp_elevators_s0/model_best.pkl, held
     against the JAX-on-CPU golden file tests/fixtures/elevators_golden.npz;
  4. training at elevators, against the JAX-on-CPU golden file
     tests/fixtures/elevators_train_golden.npz: K3 transposed and K5
     lattice_filter_grad against their plain versions at the median-init
     lengthscales (c = 11); SimplexGP.nlml and its raw gradients at the
     median init and at model_best.pkl; three Adam steps (fit_adam, lr 0.1);
     the trainer entry point ``simplex_gp_torch.train.main`` for two epochs
     on the card; one warm training step and its stages by CUDA events.

The line before the last is the card; the one before it a JSON object of
the kernels (launches on the slice -- for K5, on the trainer run --,
errors, times).  The last line is
{"ok": true, "device": {...}} only if every phase passed; otherwise the
script exits 1.  It exits 2 when no CUDA device is present.  It never
imports jax.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
PARAMS = ROOT / "runs" / "r5" / "simplexgp_elevators_s0" / "model_best.pkl"
GOLDEN = ROOT / "tests" / "fixtures" / "elevators_golden.npz"
TRAIN_GOLDEN = ROOT / "tests" / "fixtures" / "elevators_train_golden.npz"
RAW_NAMES = ("raw_lengthscale", "raw_outputscale", "raw_noise", "mean")

# Tolerances, each with its reason.
# K1: kernel and plain version run the same IEEE operations in the same order.
K1_MAX_MISMATCHED_POINTS = 0
K1_WEIGHT_ATOL = 1e-6
# K3: the splat's atomicAdd order varies from run to run (f32 sums).
K3_REL = 1e-5
# K6 single step from one state: summation order of d2 and L.l_piv differs.
K6_STEP_REL = 1e-5
# K6 rank-100 factor: a near-tie in argmax can swap late pivots; compare the
# low-rank operator L L^T on a probe, which such a swap barely moves.
K6_LLT_REL = 1e-3
# Slice against JAX on the CPU.  At the trained parameters the eval CG does
# not reach its tolerance: it stops on the stall guard near residual 0.11
# after ~240 f32 iterations, so alpha is the best iterate of a trajectory that
# two correct implementations follow only statistically.  Measured on the
# card's host CPU, the port's plain version and JAX differ by rms 0.121 in
# the predictive mean (max 0.70) with RMSE and NLL still within the limits.
#   * predict_from_cache fed JAX's own alpha: one filter apply, f32 roundoff
#     of the summation orders (values are O(1)): max |diff| <= 1e-3;
#   * the whole slice: rms of the mean difference <= 0.2, above that spread
#     and well below the ~0.8 rms of a mean that ignored alpha;
#   * test RMSE within 0.01 and NLL within 0.05 of JAX's; omega differs
#     (torch Generator vs jax PRNGKey), which moves the variances, hence
#     NLL's looser bound.
PREDICT_MEAN_ATOL = 1e-3
MEAN_RMS_ATOL = 0.2
RMSE_ATOL = 1e-2
NLL_ATOL = 5e-2
# Training (phase 4).
# K5 fed the same tables as its plain version: the same ranks (shared device
# code with K1), f32 dots of width c and the E product summed in another
# order, with cancellation in the differences gw[d-r] - gw[d+1-r]
# (measured 1.6e-7 on the H100).
K5_REL = 1e-4
# NLML and raw gradients against JAX on the CPU, same probes: JAX runs the
# sort-chain operator, the port the join operator with an atomic splat.
# Measured on the H100 (PR 2): |dNLML| <= 7.6e-6, gradient rel <= 2.3e-3
# (the mean's, a small sum of alpha), cos 1.000000; five repeats spread the
# NLML by 1.4e-6.  At model_best.pkl the training CG stops after 11
# iterations, not at the floor of 10; one iteration fewer moves the NLML by
# 3.7e-4 (my CPU run), so the bound leaves room for that flip.
NLML_ATOL = 1e-3
GRAD_COS = 0.999
GRAD_REL = 2e-2
# Three Adam steps: per-step loss as the NLML (measured 1.1e-5); the raw
# parameters move by about lr = 0.1 per step whatever the gradient's size,
# so a small error in the gradients stays small in them (measured 1.3e-4).
ADAM_LOSS_ATOL = 1e-3
ADAM_PARAM_ATOL = 2e-3
# The trainer after two epochs from the median init: finite, and better than
# the prior mean (RMSE 1 on the standardized targets).
ENTRY_RMSE_MAX = 1.0

KERNEL_ROWS = {
    "lattice_geometry": ("simplex_gp_torch/csrc/geometry.cu", "simplex_gp_tpu/ops/lattice.py:141"),
    "lattice_dedup_neighbors": ("simplex_gp_torch/csrc/dedup.cu", "simplex_gp_tpu/ops/lattice.py:387"),
    "lattice_apply": ("simplex_gp_torch/csrc/apply.cu", "simplex_gp_tpu/ops/lattice.py:470"),
    "pivot_column": ("simplex_gp_torch/csrc/pivot.cu", "simplex_gp_tpu/linalg/pivoted_cholesky.py:106"),
    "lattice_filter_grad": ("simplex_gp_torch/csrc/grad.cu", "simplex_gp_tpu/ops/filter.py:143"),
}


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` in ms by CUDA events, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def cosine(a, b) -> float:
    return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def training_phase(dev, ds, expect, timer):
    """Phase 4: the training path at elevators.  Returns (K5's kernel row, the record)."""
    import torch

    import simplex_gp_torch
    from simplex_gp_torch import train as trainer
    from simplex_gp_torch.kernels import lattice as K
    from simplex_gp_torch.kernels.pivot import pivot_column
    from simplex_gp_torch.linalg import mll
    from simplex_gp_torch.linalg.cg import cg_solve
    from simplex_gp_torch.linalg.lanczos import logdet_from_cg_tridiag
    from simplex_gp_torch.linalg.pivoted_cholesky import precond_solve, precond_sqrt
    from simplex_gp_torch.ops import lattice as L
    from simplex_gp_torch.ops.filter import build_plan_any

    golden = np.load(TRAIN_GOLDEN)
    x = torch.from_numpy(ds.train_x).to(dev)
    y = torch.from_numpy(ds.train_y).to(dev)
    n, d = x.shape
    cfg = mll.BBMMConfig(cg_tolerance=1.0, max_cg_iterations=500, max_lanczos_iterations=100,
                         precond_rank=100, num_probes=10, slq_mode="cg", grad_mode="exact")
    model = simplex_gp_torch.SimplexGP(num_dims=d, kernel="matern", nu=1.5, order=1, min_noise=0.1,
                                       bbmm=cfg, device=dev)
    dk = model.dk

    def point(tag):
        return {k: golden[f"{tag}_{k}"] for k in RAW_NAMES}

    def probes(seed):
        z = np.random.default_rng(int(seed)).choice([-1.0, 1.0], size=(n, cfg.num_probes))
        return torch.from_numpy(z.astype(np.float32)).to(dev)

    record = {}
    print("training 4.1: K3 transposed and K5 lattice_filter_grad vs plain (median init, c=11)")
    model.load_raw(point("init"))
    with torch.no_grad():
        ref = (x * model.constrained()["inv_ell"]).contiguous()
        seg, w, nb, nl = build_plan_any(ref, dk)
        gen = torch.Generator(device=dev).manual_seed(4)
        v = torch.randn((n, 11), generator=gen, device=dev)
        g = torch.randn((n, 11), generator=gen, device=dev)
        taps, norm = list(dk.coeffs), L.SLICE_NORM(d)
        E = torch.from_numpy(L.build_rotation(d, dk.variance)).to(dev)
        _, tf_k = K.lattice_apply(seg, w, nb, nl, v, taps, norm, return_table=True)
        gs_k, tb_k = K.lattice_apply(seg, w, nb, nl, g, taps, norm, transpose=True, return_table=True)
        _, tf_p = K.apply_plain(seg, w, nb, v, taps, norm, return_table=True)
        gs_p, tb_p = K.apply_plain(seg, w, nb, g, taps, norm, transpose=True, return_table=True)
        rows = seg.long()  # the rows the slice and K5 read (rows past n_lattice are undefined)
        r3 = max(rel(tb_k[rows], tb_p[rows]), rel(tf_k[rows], tf_p[rows]), rel(gs_k, gs_p))
        expect(r3 <= K3_REL, f"K3 transposed: table and output rel error {r3:.3e} (limit {K3_REL})")
        gr_k = K.lattice_filter_grad(ref, E, seg, v, g, tf_k, tb_k, norm)
        gr_p = K.lattice_filter_grad_plain(ref, E, seg, v, g, tf_k, tb_k, norm)
        r5 = rel(gr_k, gr_p)
        expect(bool(torch.isfinite(gr_k).all()) and r5 <= K5_REL,
               f"K5 vs plain on the same tables: rel error {r5:.3e} (limit {K5_REL})")
        r5_route = rel(gr_k, K.lattice_filter_grad_plain(ref, E, seg, v, g, tf_p, tb_p, norm))
        print(f"    K5 vs the all-plain route (plain tables too): rel {r5_route:.3e}")
        k5 = dict(max_abs_err=float((gr_k - gr_p).abs().max()),
                  ms=timer(lambda: K.lattice_filter_grad(ref, E, seg, v, g, tf_k, tb_k, norm), 50),
                  plain_ms=timer(lambda: K.lattice_filter_grad_plain(ref, E, seg, v, g, tf_k, tb_k, norm), 10),
                  shape=f"n={n}, d={d}, c=11")
        k3t = (timer(lambda: K.lattice_apply(seg, w, nb, nl, g, taps, norm, transpose=True,
                                             return_table=True), 20),
               timer(lambda: K.apply_plain(seg, w, nb, g, taps, norm, transpose=True, return_table=True), 5))
    print(f"    K5 {k5['ms']:.4f} ms, plain {k5['plain_ms']:.4f} ms; "
          f"K3 transposed c=11 {k3t[0]:.4f} ms, plain {k3t[1]:.4f} ms")
    record.update(k5_rel=r5, k5_route_rel=r5_route, k3_transposed_rel=r3, k3_transposed_ms=k3t[0],
                  k3_transposed_plain_ms=k3t[1])

    print("training 4.2: NLML and raw gradients vs JAX on the CPU (same probes)")
    for tag in ("init", "best"):
        model.load_raw(point(tag))
        model.zero_grad(set_to_none=True)
        stats = {}
        loss = model.nlml(x, y, probes=probes(golden[f"seed_{tag}"]), stats=stats)
        loss.backward()
        dl = abs(float(loss.detach()) - float(golden[f"loss_{tag}"]))
        expect(dl <= NLML_ATOL, f"{tag}: NLML {float(loss.detach()):.6f} vs JAX {float(golden[f'loss_{tag}']):.6f}"
               f" (|diff| {dl:.2e}, limit {NLML_ATOL}); CG iterations {stats['cg_iters']}")
        for k in RAW_NAMES:
            a = getattr(model, k).grad.detach().cpu().numpy().astype(np.float64).ravel()
            b = golden[f"grad_{tag}_{k}"].astype(np.float64).ravel()
            c, r = cosine(a, b), float(np.linalg.norm(a - b) / np.linalg.norm(b))
            expect(c >= GRAD_COS and r <= GRAD_REL,
                   f"{tag}: d/d{k} cos {c:.6f} (limit {GRAD_COS}), rel {r:.2e} (limit {GRAD_REL})")
            record[f"{tag}_grad_rel_{k}"] = r
        record[f"{tag}_nlml_diff"] = dl
    # Run to run: K3's atomic splat changes the last bits of every apply.
    losses, grads = [], []
    model.load_raw(point("init"))
    for _ in range(5):
        model.zero_grad(set_to_none=True)
        loss = model.nlml(x, y, probes=probes(golden["seed_init"]))
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append(torch.cat([getattr(model, k).grad.reshape(-1) for k in RAW_NAMES]).cpu().numpy())
    spread = max(losses) - min(losses)
    gspread = max(float(np.linalg.norm(gr - grads[0]) / np.linalg.norm(grads[0])) for gr in grads)
    print(f"    5 repeats at the init point: NLML spread {spread:.3e}, gradient rel spread {gspread:.3e}")
    record.update(repeat_nlml_spread=spread, repeat_grad_rel_spread=gspread)

    print("training 4.3: three Adam steps (fit_adam, lr 0.1) vs the JAX trajectory")
    model.load_raw(point("init"))
    steps = iter([probes(golden["seed_adam"] + e) for e in range(3)])
    cg_iters = []

    def loss_fn(_gen):
        stats = {}
        loss = model.nlml(x, y, probes=next(steps), stats=stats)
        cg_iters.append(stats["cg_iters"])
        return loss

    hist = simplex_gp_torch.fit_adam(loss_fn, model.parameters(), epochs=3, lr=0.1)
    dl = float(np.abs(np.array(hist["loss"]) - golden["adam_loss"]).max())
    expect(dl <= ADAM_LOSS_ATOL, f"Adam losses {hist['loss']} vs JAX {golden['adam_loss'].tolist()} "
           f"(max |diff| {dl:.2e}, limit {ADAM_LOSS_ATOL}); CG iterations {cg_iters}")
    dp = max(float(np.abs(getattr(model, k).detach().cpu().numpy() - golden[f"adam_{k}"][-1]).max())
             for k in RAW_NAMES)
    expect(dp <= ADAM_PARAM_ATOL, f"raw parameters after 3 steps: max |diff| {dp:.2e} (limit {ADAM_PARAM_ATOL})")
    record.update(adam_loss_diff=dl, adam_param_diff=dp, adam_step_ms=hist["step_ms"], adam_cg_iters=cg_iters)

    print("training 4.4: python -m simplex_gp_torch.train, two epochs at elevators")
    kernels = (K.lattice_geometry, K.lattice_dedup_neighbors, K.lattice_apply, pivot_column,
               K.lattice_filter_grad)
    for fn in kernels:
        fn.launches = 0
    final = trainer.main(["--dataset", "elevators", "--kernel", "matern", "--nu", "1.5", "--order", "1",
                          "--min-noise", "0.1", "--ls-init", "median", "--cg-tol", "1.0", "--cg-iter", "500",
                          "--lanc-iter", "100", "--pre-size", "100", "--num-probes", "10", "--epochs", "2",
                          "--device", dev.type])
    launches = {fn.__name__: fn.launches for fn in kernels}
    print(f"    launches on the trainer run: {launches}")
    expect(all(v > 0 for v in launches.values()), "every kernel launched on the trainer run")
    expect(all(np.isfinite(final["train/loss"])) and np.isfinite(final["test/nll"])
           and final["test/rmse"] < ENTRY_RMSE_MAX,
           f"trainer: losses {final['train/loss']}, test RMSE {final['test/rmse']:.4f} (limit "
           f"{ENTRY_RMSE_MAX}), NLL {final['test/nll']:.4f}")
    record.update(trainer=final, trainer_launches=launches)

    print("training 4.5: one warm step and its stages")
    model.load_raw(point("init"))
    opt = torch.optim.Adam(model.parameters(), lr=0.1)
    z = probes(golden["seed_init"])
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)] if dev.type == "cuda" else None

    def mark(i):
        if ev is not None:
            ev[i].record()

    opt.zero_grad(set_to_none=True)
    with torch.no_grad():  # the forward's stages, one by one, as mll._solve_system runs them
        mark(0)
        params = model.constrained()
        ref = x * params["inv_ell"]
        plan = build_plan_any(ref, dk)
        mark(1)
        P = mll.build_precond(dk, cfg, params, ref, n)
        mark(2)
        s, noise = params["outputscale"], params["noise"]
        b = precond_sqrt(P, z)
        res = cg_solve(lambda V: s * L.apply_plan_join(plan, V, dk.coeffs) + noise * V,
                       torch.cat([(y - params["mean"])[:, None], b], dim=-1), tol=cfg.cg_tolerance,
                       max_iters=cfg.max_cg_iterations, precond=lambda V: precond_solve(P, V), tridiag_m=100)
        mark(3)
        logdet_from_cg_tridiag(res.alphas[:, 1:], res.betas[:, 1:], res.tmask[:, 1:], (z * z).sum(0))
        mark(4)
    loss = model.nlml(x, y, probes=z)
    mark(5)
    loss.backward()
    mark(6)
    if ev is not None:
        torch.cuda.synchronize()
        names = ("plan", "preconditioner", "cg", "slq_eigh", "forward", "backward")
        stages = {nm: ev[i].elapsed_time(ev[i + 1]) for i, nm in enumerate(names)}
        a0, a1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a0.record()
        opt.step()
        a1.record()
        torch.cuda.synchronize()
        stages["adam"] = a0.elapsed_time(a1)
        stages["cg_iters"] = res.iterations
        warm = timer(lambda: train_step(model, opt, x, y, z), 5)
        print(f"    warm training step {warm:.2f} ms (CUDA events); stages (ms): "
              + json.dumps({k: round(v, 3) for k, v in stages.items()}))
        record.update(step_ms=warm, stages=stages)
    return k5, record


def train_step(model, opt, x, y, z):
    opt.zero_grad(set_to_none=True)
    model.nlml(x, y, probes=z).backward()
    opt.step()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import simplex_gp_torch
    from simplex_gp_torch import convert
    from simplex_gp_torch.kernels import build, lattice as K
    from simplex_gp_torch.kernels.pivot import pivot_column, pivot_column_plain
    from simplex_gp_torch.linalg.mll import BBMMConfig
    from simplex_gp_torch.ops import lattice as L
    from simplex_gp_torch.utils import data

    dev = torch.device("cuda:0")
    failures = []

    def expect(ok: bool, what: str):
        print(f"  [{'ok' if ok else 'FAIL'}] {what}")
        if not ok:
            failures.append(what)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    t0 = time.perf_counter()
    build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {'ran' if build.build_seconds is not None else 'skipped: cached library'})")

    # ---- the elevators serving problem ------------------------------------
    # The golden file was made from the seeded synthetic stand-in of
    # elevators (no DATADIR), so take it directly.
    ds = data.prepare_dataset(data._synthetic_uci("elevators"), "elevators")
    golden = np.load(GOLDEN)
    model = simplex_gp_torch.SimplexGP(
        num_dims=18, kernel="matern", nu=1.5, order=1, min_noise=0.1,
        bbmm=BBMMConfig(cg_tolerance=1.0, max_cg_iterations=500, max_lanczos_iterations=100,
                        precond_rank=100, num_probes=10),
        eval_cg_tolerance=0.01, device=dev,
    )
    model.load_raw(convert.raw_params_from_numpy(convert.load_jax_params(PARAMS), device=dev))
    x = torch.from_numpy(ds.train_x).to(dev)
    y = torch.from_numpy(ds.train_y).to(dev)
    xt = torch.from_numpy(ds.test_x).to(dev)
    dk = model.dk
    with torch.no_grad():
        params = model.constrained()
        ref = (x * params["inv_ell"]).contiguous()
        joint = torch.cat([ref, xt * params["inv_ell"]]).contiguous()
    n, d = ref.shape
    print(f"elevators: n_train={n} n_test={xt.shape[0]} d={d}; "
          f"M train={n * (d + 1)} joint={joint.shape[0] * (d + 1)}")

    rows = {}

    # ---- K1 ------------------------------------------------------------------
    print("K1 lattice_geometry vs plain")
    a = torch.from_numpy(L._hash_vectors(d)).to(dev)
    E = torch.from_numpy(L.build_rotation(d, dk.variance)).to(dev)
    errs = []
    for name, pts in (("train", ref), ("joint", joint)):
        kh1, kh2, kw = K.lattice_geometry(pts, E, a)
        ph1, ph2, pw = K.geometry_plain(pts, E, a)
        bad = ((kh1 != ph1) | (kh2 != ph2)).reshape(-1, d + 1).any(dim=1)
        werr = float((kw - pw).abs()[~bad].max())
        errs.append(werr)
        expect(int(bad.sum()) <= K1_MAX_MISMATCHED_POINTS,
               f"{name}: {int(bad.sum())} of {pts.shape[0]} points with another simplex "
               f"(limit {K1_MAX_MISMATCHED_POINTS})")
        expect(werr <= K1_WEIGHT_ATOL, f"{name}: max weight error {werr:.3e} (limit {K1_WEIGHT_ATOL})")
    rows["lattice_geometry"] = dict(
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: K.lattice_geometry(ref, E, a), 20),
        plain_ms=cuda_ms(lambda: K.geometry_plain(ref, E, a), 5),
        shape=f"x ({n}, {d})",
    )

    # ---- K2 + K3 -------------------------------------------------------------
    print("K2 lattice_dedup_neighbors + K3 lattice_apply vs plain")
    order = dk.order
    oh1, oh2 = (torch.from_numpy(o).to(dev) for o in L._offset_hashes(d, order, L._hash_vectors(d)))
    gen = torch.Generator(device=dev).manual_seed(1)
    k3_err, k3_ms, k3_plain_ms, k2_case, k2_err = 0.0, {}, {}, None, 0
    for name, pts, widths in (("train", ref, (1, 100)), ("joint", joint, (101,))):
        h1, h2, w = K.lattice_geometry(pts, E, a)
        kseg, knb, knl = K.lattice_dedup_neighbors(h1, h2, oh1, oh2)
        pseg, pnb, pnl = K.dedup_neighbors_plain(h1, h2, oh1, oh2)
        k2_err = max(k2_err, abs(int(knl) - int(pnl)))
        expect(int(knl) == int(pnl), f"{name}: n_lattice kernel {int(knl)} plain {int(pnl)}")
        golden_nl = int(golden[f"n_lattice_{name}"])
        expect(int(knl) == golden_nl, f"{name}: n_lattice {int(knl)} vs JAX join plan {golden_nl}")
        if name == "train":
            k2_case = (h1, h2)
        kseg, pseg = kseg.reshape(-1, d + 1), pseg.reshape(-1, d + 1)
        for c in widths:
            v = torch.randn((pts.shape[0], c), generator=gen, device=dev)
            taps = list(dk.coeffs)
            norm = L.SLICE_NORM(d)
            kout = K.lattice_apply(kseg, w, knb, knl, v, taps, norm)
            pout = K.apply_plain(pseg, w, pnb, v, taps, norm)
            r = rel(kout, pout)
            k3_err = max(k3_err, float((kout - pout).abs().max()))
            expect(r <= K3_REL, f"{name} c={c}: rel error {r:.3e} (limit {K3_REL})")
            k3_ms[c] = cuda_ms(lambda: K.lattice_apply(kseg, w, knb, knl, v, taps, norm), 10)
            k3_plain_ms[c] = cuda_ms(lambda: K.apply_plain(pseg, w, pnb, v, taps, norm), 3)
            print(f"    c={c}: kernel {k3_ms[c]:.3f} ms, plain {k3_plain_ms[c]:.3f} ms")
    h1, h2 = k2_case
    rows["lattice_dedup_neighbors"] = dict(
        max_abs_err=k2_err,  # |n_lattice kernel - plain|; the operator is checked through K3
        ms=cuda_ms(lambda: K.lattice_dedup_neighbors(h1, h2, oh1, oh2), 20),
        plain_ms=cuda_ms(lambda: K.dedup_neighbors_plain(h1, h2, oh1, oh2), 5),
        shape=f"N={h1.shape[0]} hash pairs",
    )
    rows["lattice_apply"] = dict(
        max_abs_err=k3_err, ms=k3_ms[1], plain_ms=k3_plain_ms[1], shape="train, c=1",
        ms_by_c=k3_ms, plain_ms_by_c=k3_plain_ms,
    )

    # ---- K6 ------------------------------------------------------------------
    print("K6 pivot_column vs plain (rank 100)")
    s = params["outputscale"].reshape(()).contiguous()
    k = 100

    def factor(step, steps):
        Lk = torch.zeros((n, k), device=dev)
        piv = torch.zeros(k, dtype=torch.int64, device=dev)
        dg = s * torch.ones(n, device=dev)
        d0 = dg.max()
        for j in range(steps):
            dg = step(ref, Lk, dg, torch.argmax(dg), j, s, d0, dk.nu, piv)
        return Lk, piv, dg, d0

    Lk, pk, _, _ = factor(pivot_column, k)
    Lp, pp, _, d0 = factor(pivot_column_plain, k)
    same = int((pk == pp).sum())
    z = torch.randn((n, 4), generator=gen, device=dev)
    r_llt = rel(Lk @ (Lk.T @ z), Lp @ (Lp.T @ z))
    expect(r_llt <= K6_LLT_REL, f"L L^T z rel error {r_llt:.3e} (limit {K6_LLT_REL}); "
           f"{same} of {k} pivots equal; L rel error {rel(Lk, Lp):.3e}")
    # One step from one state: the last pivot (j = 99, the widest dot).
    L0, _, dg0, _ = factor(pivot_column_plain, k - 1)
    piv0 = torch.argmax(dg0)
    La, Lb = L0.clone(), L0.clone()
    pa, pb = (torch.zeros(k, dtype=torch.int64, device=dev) for _ in range(2))
    da = pivot_column(ref, La, dg0, piv0, k - 1, s, d0, dk.nu, pa)
    db = pivot_column_plain(ref, Lb, dg0, piv0, k - 1, s, d0, dk.nu, pb)
    r_step = max(rel(La[:, k - 1], Lb[:, k - 1]), rel(da, db))
    expect(r_step <= K6_STEP_REL, f"single step j={k - 1}: rel error {r_step:.3e} (limit {K6_STEP_REL})")
    rows["pivot_column"] = dict(
        max_abs_err=float((La[:, k - 1] - Lb[:, k - 1]).abs().max()),
        ms=cuda_ms(lambda: pivot_column(ref, La, dg0, piv0, k - 1, s, d0, dk.nu, pa), 50),
        plain_ms=cuda_ms(lambda: pivot_column_plain(ref, Lb, dg0, piv0, k - 1, s, d0, dk.nu, pb), 20),
        shape=f"n={n}, dim={d}, k={k}, j={k - 1}",
        factor_ms=cuda_ms(lambda: factor(pivot_column, k), 2),
        plain_factor_ms=cuda_ms(lambda: factor(pivot_column_plain, k), 2),
    )

    # ---- the slice -------------------------------------------------------------
    print("slice: posterior_cache + predict_from_cache (elevators, trained parameters)")
    # One untimed pass first, so the timed one finds cuSOLVER and the
    # allocator warm; the launch counts are those of the timed pass alone.
    model.predict_from_cache(model.posterior_cache(x, y, generator=torch.Generator(device=dev)), x, xt)
    for fn in (K.lattice_geometry, K.lattice_dedup_neighbors, K.lattice_apply, pivot_column):
        fn.launches = 0
    torch.cuda.synchronize()
    g = torch.Generator(device=dev).manual_seed(0)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    cache = model.posterior_cache(x, y, generator=g)
    ev[1].record()
    mean, var = model.predict_from_cache(cache, x, xt)
    ev[2].record()
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in
                (K.lattice_geometry, K.lattice_dedup_neighbors, K.lattice_apply, pivot_column)}
    cache_ms, predict_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])

    mean_np, var_np = mean.cpu().numpy(), var.cpu().numpy()
    err = mean_np - ds.test_y
    rmse = float(np.sqrt((err**2).mean()))
    nll = float(0.5 * (np.log(2 * np.pi * var_np) + err**2 / var_np).mean())
    dmean = mean_np - golden["mean"]
    alpha_jax = torch.from_numpy(golden["alpha"]).to(dev)
    mean_j, _ = model.predict_from_cache(dict(cache, alpha=alpha_jax), x, xt)
    dpred = float(np.abs(mean_j.cpu().numpy() - golden["mean"]).max())
    print(f"  posterior_cache {cache_ms:.1f} ms, predict_from_cache {predict_ms:.1f} ms (CUDA events)")
    print(f"  CG iterations {cache['cg_iters']} (JAX {int(golden['cg_iters'])}), final residual "
          f"{float(cache['cg_res']):.3e} (JAX {float(golden['cg_res']):.3e})")
    print(f"  launches on the slice: {launches}")
    expect(all(v > 0 for v in launches.values()), "every kernel launched on the slice")
    expect(bool(np.isfinite(mean_np).all() and np.isfinite(var_np).all() and (var_np > 0).all())
           and mean_np.shape == ds.test_y.shape, "finite mean and positive variance, one per test row")
    expect(abs(rmse - float(golden["rmse"])) <= RMSE_ATOL,
           f"test RMSE {rmse:.4f} vs JAX {float(golden['rmse']):.4f} (limit {RMSE_ATOL})")
    expect(abs(nll - float(golden["nll"])) <= NLL_ATOL,
           f"test NLL {nll:.4f} vs JAX {float(golden['nll']):.4f} (limit {NLL_ATOL})")
    expect(dpred <= PREDICT_MEAN_ATOL, f"predict_from_cache with JAX's alpha vs JAX mean, row by row: "
           f"max |diff| {dpred:.3e} (limit {PREDICT_MEAN_ATOL})")
    mean_rms = float(np.sqrt((dmean**2).mean()))
    expect(mean_rms <= MEAN_RMS_ATOL, f"slice mean vs JAX row by row: rms diff {mean_rms:.3e} "
           f"(limit {MEAN_RMS_ATOL}), max {float(np.abs(dmean).max()):.3e}")
    print(f"  variance vs JAX (other omega): median rel diff "
          f"{float(np.median(np.abs(var_np - golden['var']) / golden['var'])):.3e}")

    t_train = time.perf_counter()
    rows["lattice_filter_grad"], training = training_phase(dev, ds, expect, cuda_ms)
    launches["lattice_filter_grad"] = training["trainer_launches"]["lattice_filter_grad"]
    print(f"training phase: {time.perf_counter() - t_train:.1f} s")
    print("training: " + json.dumps(training))

    kernels = []
    for name, (source, replaces) in KERNEL_ROWS.items():
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=launches[name], **rows[name]))
    print("slice: " + json.dumps(dict(
        posterior_cache_ms=cache_ms, predict_ms=predict_ms, cg_iters=cache["cg_iters"],
        cg_res=float(cache["cg_res"]), rmse=rmse, nll=nll, mean_rms_diff=mean_rms,
        predict_max_abs_diff=dpred)))
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed:", *failures, sep="\n  ", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
