#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one CUDA card, and check it.

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
     against the JAX-on-CPU golden file tests/fixtures/elevators_golden.npz.

The line before the last is the card; the one before it a JSON object of
the kernels (launches on the slice, errors, times).  The last line is
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

ROOT = pathlib.Path(__file__).resolve().parent
PARAMS = ROOT / "runs" / "r5" / "simplexgp_elevators_s0" / "model_best.pkl"
GOLDEN = ROOT / "tests" / "fixtures" / "elevators_golden.npz"

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

KERNEL_ROWS = {
    "lattice_geometry": ("simplex_gp_torch/csrc/geometry.cu", "simplex_gp_tpu/ops/lattice.py:141"),
    "lattice_dedup_neighbors": ("simplex_gp_torch/csrc/dedup.cu", "simplex_gp_tpu/ops/lattice.py:387"),
    "lattice_apply": ("simplex_gp_torch/csrc/apply.cu", "simplex_gp_tpu/ops/lattice.py:470"),
    "pivot_column": ("simplex_gp_torch/csrc/pivot.cu", "simplex_gp_tpu/linalg/pivoted_cholesky.py:106"),
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

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
