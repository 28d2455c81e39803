#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, large-n, data-parallel, mixture, baseline, sort-chain, CG, factor, screening and chain-backward paths and its entry-point scripts on one CUDA card, and check them.

    python3 chip_smoke.py

Phases, each printed as it runs:
  1. the card (nvidia-smi name and power limit) and the kernel build time;
  2. each hand-written kernel against its plain PyTorch version at the shapes
     of the elevators serving path: K1 lattice_geometry (its team of lanes a
     point torch.equal to the plain twin and to the first kernel, a thread a
     point, both timed), K2
     lattice_dedup_neighbors, K3 lattice_apply at c = 1, 100 and 101, K6
     pivot_column at rank 100;
  3. the slice: SimplexGP.posterior_cache on the 10,623 elevators training
     rows and predict_from_cache on the 3,320 test rows, with the trained
     parameters of runs/r5/simplexgp_elevators_s0/model_best.pkl, held
     against the JAX-on-CPU golden file tests/fixtures/elevators_golden.npz;
     the kernels' launches on the slice (the range sketch's route: K9 twice
     by windows of 32 on its join plan's row lists, one row build, K3
     never); a second posterior_cache bit for bit (alpha and root_inv); the
     sketch's apply at c = 100 against its plain version, K9 in one window
     and a second run (bit for bit) and K3 (rel), with the times of each,
     of the row build and the bound;
  4. training at elevators, against the JAX-on-CPU golden file
     tests/fixtures/elevators_train_golden.npz: K3 transposed and K5
     lattice_filter_grad against their plain versions at the median-init
     lengthscales (c = 11; K5 bit for bit, and a second run); SimplexGP.nlml and its raw gradients at the
     median init and at model_best.pkl; three Adam steps (fit_adam, lr 0.1);
     the trainer entry point ``simplex_gp_torch.train.main`` for two epochs
     on the card; one warm training step and its stages by CUDA events;
  5. the reference's filter entry points, against the JAX-on-CPU golden file
     tests/fixtures/elevators_deriv_golden.npz: K4 lattice_filter_once
     against its plain version at the median-init training positions (c = 1
     and 11; bit for bit, and a second call), with its capacity guard
     (capacity = occupancy gives the same output, occupancy - 1 all NaN); K8 lattice_count against its plain
     version at elevators, precipitation, houseelectric and houseelectric's
     size with one point repeated, timed beside K1 + torch.unique of its
     keys, and the guard at houseelectric; K7 lattice_deriv_grad against its plain version (c = 11,
     418 stacked columns; bit for bit, and a second run), its row lists (join_rows) against their
     plain build and timed; grad_mode="deriv_filter": NLML and raw gradients
     at the median init and at model_best.pkl (each twice, bit for bit),
     three Adam steps (K3 never launched), one warm step and its stages; ``simplex_gp_torch.mvm_err.main`` for rbf order 1
     at elevators, precipitation and houseelectric (seeded synthetic
     stand-ins, full n); at each, K4 against its plain version at the
     capacity mvm_err used (bit for bit), and the trimmed filter against the
     untrimmed one;
  6. the large-n path at houseelectric (the seeded stand-in, 1,311,539
     training rows), against the JAX-on-CPU golden file
     tests/fixtures/houseelectric_golden.npz: K9 lattice_apply_cols against
     its plain version at --max-n 360,000 (c = 100 on the trimmed training
     plan, c = 101 on the untrimmed [train; val] plan) and at full n (bit
     for bit, and a second run), and against the unchunked K3 at full n
     (times and peak memories of both; K9's time with its row lists built
     inside and given, by CUDA-graph replay and on the plan of capacity =
     occupancy; the row lists against their plain build, and the time of
     their build and of its sort); K8's count and
     the autotrimmed capacity against JAX's; the bounded K2 at capacity =
     occupancy (the untrimmed output) and occupancy - 1 (all NaN), and
     against its plain version at 360,000; at the autotrimmed capacity the
     row lists of the bounded plan against their plain build bit for bit,
     and the one-call wide plan (K2 and its rows from one host call,
     lattice_plan_rows) against the plain plan and rows, each timed beside
     K2 + join_rows and its bound; the NLML and raw gradients at
     360,000 with that run's capacity, and five Adam steps from there (the
     first held to JAX's, the rest printed); then ``simplex_gp_torch.train.main``
     with the round-5 houseelectric flags for two epochs, one validation
     eval and the test predict on the chunked chain (no K2, join rows, K9 or
     K3 launched), the training steps' backward on the CG's chain plan;
     K5 at the training step's shape (c = 11 on the CG's trimmed chain plan
     and its two final-order tables) against its plain version and a second
     run, bit for bit, with its time and bound; one warm step by stage (the
     backward's parts on both routes, the chain plan's and a join plan's),
     and its backward under torch.profiler (the chain backward's kernels, no
     join plan's, no torch.sort or torch.cumsum); one eval by stage with its
     peak memory, its range sketch and val predict on the chunked chain and
     then K9's route on the same inputs (times and peak beside them): the
     sketch's K_hat Omega and the rect filter of the same columns within the
     chain-vs-join bound, the predictions under the serving gates;
  7. the data-parallel training path at elevators' width (the 10,622 rows
     shard_batch keeps at P = 2, median init, 10 probes), whose plan is the
     sharded sort chain (JAX's build_plan_sharded): K11a
     lattice_dedup_ordered against its plain version (bit-equal) and K2
     (occupancy, time); K11b lattice_apply_sharded (bit for bit, and a second
     call; timed beside K3 on the same plan, with its row build and the bytes
     a collective), the sharded join's kernels, and K6' (pivot_column given
     the pivot's rows) against their plain versions on one NCCL rank; there
     too the sharded chain: its plan torch.equal to the one-device untrimmed
     plan, its apply (forward and transposed, output and final-order table)
     bit for bit against its plain version, a second call and the one-device
     chain apply, timed with its collectives apart beside its bound, the
     one-device apply and K11b; two gloo ranks sharing the card
     (``simplex_gp_torch.parallel.launch``): K11b (bit for bit), the sharded
     chain apply and its unblock (bit for bit, and a second call; timed with
     the transport apart) and one K6'
     step against their plain versions on each rank, the chain's global
     plan the same bits on both ranks and in one process, the
     rank-100 sharded factor against one process's, the sharded filters
     against K3 and the chain apply on one process, K10' (the sharded CG's cg_step_x, cg_step_p
     and cg_init given both ranks' gathered partials) against their plain
     twins bit for bit from a state three iterations into the step's CG, and
     cg_fold given both ranks' U^T r likewise, the
     NLML and raw gradients of ``data_parallel_loss_fn`` against one process
     with the same probes (and a second run of the step, bit for bit; K3
     never launched), the CG iteration counts, best residuals and SLQ
     record the same bits on both ranks, the CG's collectives an iteration
     (3), one Adam step (parameters bit-equal on both ranks), the step's
     stages with the transport apart and the bytes a collective, its
     launches (the sharded chain's kernels; K11a, K11b and K3 none), the
     J = 8 mixture's data-parallel NLML (one sharded chain a component)
     and gradients against one process's (one chain plan a component);
     ``simplex_gp_torch.scaling``'s records on one NCCL rank and on the two
     gloo ranks; and (7.5) the houseelectric stand-in's first 360,000 rows
     over the two gloo ranks (houseelectric_golden.npz's probes and median
     init, its fixed CG iteration count): NLML and raw gradients against one
     process on the untrimmed chain under phase 6's gates.  Then one line of
     K10 (the CG iteration) times;
  8. the Gaussian-mixture kernel path at elevators' width (J = 8 RBF
     components of order 1 targeting Matern-1.5, the configuration of
     runs/r5/simplexgp_elevators_s0 with --kernel mixture), against the
     JAX-on-CPU golden file tests/fixtures/elevators_mixture_golden.npz:
     the stacked plan's row lists (mixture_rows) against their plain build
     bit for bit, and their build time; K12 lattice_mixture_apply against
     its plain version at the median-init positions with JAX's weights
     (c = 1, 11 and 100, forward and transposed, outputs and stacked
     tables, bit for bit, and a second apply), against the J-fold K3 loop on
     the same plans (times of both, K12's also replayed from a CUDA graph,
     and the bound at each width) and against JAX's mixture MVM; the mixture
     position gradient (K5 on the stacked problem) against its plain
     version; the port's subset fit against JAX's weights through the
     operator; the NLML and raw gradients at the median init on the J chain
     plans, one a component (and a second evaluation, bit for bit), beside
     K12's stacked route on the same inputs (the NLML difference, the raw
     gradients), three Adam steps, one warm step and its stages (no K2, row
     build or K12 launched), the CG's MVM at c = 11 on both routes (within
     the chain-vs-join bound, graph-replayed times) and the warm step on
     both; posterior_cache +
     predict_from_cache at model_best.pkl (with JAX's weights refit at its
     lengthscales) on the test rows;
     ``simplex_gp_torch.train.main --kernel mixture`` for two epochs and
     one eval; ``simplex_gp_torch.mvm_err.main --kernel mixture`` at
     elevators;
  9. the baselines at precipitation (the seeded stand-in: 402,223 training
     rows, the first 65,536 as the round-5 runs' --max-n, 125,695 test
     rows; Matern-1.5, min_noise 0.1, the median-init lengthscale), against
     the JAX-on-CPU golden file tests/fixtures/precipitation_baselines_golden.npz:
     K13 (SKIP's root: ski_interp and its backward scatter, ski_kr_matmul,
     ski_kr_gram, ski_kr_adjoint) against its plain versions at the training
     root and the joint [train; test] root, g = 100, r = 64, with JAX's
     Omega (the backward scatter bit for bit, and a second call; K13b-d a
     second call bit for bit), beside one einsum each for K13b and K13c and,
     for K13b, torch.mm of the materialised (n, r^2) M (cuBLAS's f32 rate, a
     yardstick the port never calls); SKIP's NLML, raw gradients (twice, bit
     for bit) and R R^T at the median init and at
     runs/r5/skip_precipitation_s0/model_best.pkl, and its serving there;
     SGPR's NLML, raw gradients (the 512 inducing rows' too) and serving at
     runs/r5/sgpr_precipitation_s0/model_best.pkl; one warm SKIP step and
     one warm SGPR step by stage; SKIP's NLML and backward at all 402,223
     training rows through K13 and through JAX's materialised (n, r^2)
     product, with their peak memories; then
     ``simplex_gp_torch.train_{skip,sgpr,exact}`` for two epochs and one
     eval each with the round-5 flags;
 10. the sort-chain plan K3' (csrc/chain.cu), the single-device CG plan that
     phases 3, 4 and 6 already ran through SimplexGP.nlml and
     posterior_cache: K3'a chain_build and K3'b-d chain_splat, chain_axis,
     chain_slice against their plain versions (the plan field by field, the
     splat and the apply at c = 1 and 11, bit for bit) and against the join
     plan on the same positions, at elevators' median-init and trained
     positions and at houseelectric with its autotrimmed capacity 32,768,
     untrimmed, and elevators (median init) and houseelectric one row short
     of their occupancy (the apply all NaN); two builds and two applies bit
     for bit; K3'a's time by stage (CUDA events and the host clock between
     them) and beside its bound; the build and apply times beside K1 + K2
     and K3;
     K3'b's time beside one torch.sparse CSR product at c = 1 and 11 in
     each of the first three cases; each kernel's time, plain time, bound
     and one CSR product of the same function; the kernels' launches in one
     elevators training step; that two NLML evaluations and two
     posterior_cache calls repeat bit for bit (and which stage differs if
     not); the elevators training CG and the
     houseelectric eval CG on the chain plan and on the join plan of the
     same positions, in turns; the stage times of phases 3, 4.5 and 6.5;
 11. K10, the CG body (csrc/cg.cu), which every single-device CG of the
     phases above ran: each of cg_dot, cg_step_x, cg_utr, cg_fold,
     cg_precond, cg_step_p and cg_init against its plain twin bit for bit
     from one saved iteration state, at the elevators training shape (median
     init, c = 11, the 100-step record) and the houseelectric eval shape
     (capacity 32,768, c = 1), each timed launched and replayed beside its
     twin and its bound, the passes over U (cg_utr, cg_precond) beside
     cuBLAS's U^T r and U G2 of the same shapes; the CUDA-graph solve against
     the launched kernel loop (iteration counts and x bit for bit) in turns,
     with ms an iteration, the capture's cost, the MVM's and the passes over
     U's times (graph replays, beside cuBLAS's and the bound) and the
     launches an iteration, and one iteration's kernels under
     torch.profiler with no cuBLAS GEMM or GEMV; two NLML evaluations and gradients bit for
     bit at elevators (median init, model_best.pkl) and houseelectric; two
     houseelectric evals after one Adam step with equal CG counts and alpha;
     K10's launches on one elevators training step and one posterior_cache,
     with no K3 or K9 in the step's exact backward (which runs on the CG's
     chain plan);
 12. K6's factor and K3'c's fused axes, as redesigned for Hopper: the rank-100
     factor (a column-major L, the argmax fused into each step, no host
     read or allocation a pivot) at elevators (median init and
     model_best.pkl) and houseelectric (median init, 1,311,539 rows), its
     k launches from one host call against its own steps and the same
     kernel's loop over a row-major L (torch.argmax and a launch a pivot,
     as the factor was driven before) bit for bit, against the plain loop (equal pivots, or L L^T z
     within K6_LLT_REL where a near-tie swaps one) and each step from the
     kernel's state against the plain step (K6_STEP_REL), with no host sync
     (set_sync_debug_mode("error")); the times of the factor, the row-major
     loop, the plain loop and the bound, a pivot at j = 0 / 50 / 99, and the
     preconditioner stage split into the factor and make_preconditioner;
     the fused axes against their plain twin and the d+1 per-axis launches
     (torch.equal) at elevators and houseelectric (capacity 32,768), c = 1
     and 11, launched and graph-replayed, with the bound; K3'c's and K6's
     launches in one elevators training step (190 per-axis launches before
     the fusion);
 13. ARD screening at prune_thresh 0.3 and the last entry points: the elevators
     configuration on the seeded elevators_sparse stand-in (10,623 rows,
     d = 18; the median-init lengthscale on the four dims the generator
     makes relevant, raw lengthscale 60 on the rest) through
     posterior_cache_screened and predict_from_cache_screened, against the
     JAX-on-CPU golden file tests/fixtures/elevators_sparse_screened_golden.npz
     (the kept dims equal, test RMSE and NLL within the serving gates, the
     screened occupancy), the kernels' launches on it, the unscreened RMSE and
     NLL beside it; houseelectric_sparse at full n (1,311,539 rows, d = 11,
     parameters built the same way) through ``python -m
     simplex_gp_torch.eval_checkpoint --plan-capacity -1 --prune-thresh 0.3``
     (finite, four dims kept, the screened occupancy at or below the
     capacity), then in this process the screened cache torch.equal to the
     hand-subset model's at the same omega and the kernels' launches on it
     (its range sketch and predict on the chunked chain: no K2, join rows or
     K9); each screened eval by stage with its peak memory, and at
     houseelectric_sparse K9's route for the sketch and predict on the same
     inputs beside it under the wide routes' gates; K3'd's generic path
     (d'+1 = 5) and the chain apply torch.equal to their plain twins on both
     screened plans, timed; then ``simplex_gp_torch.train --prune-thresh
     0.3`` for two epochs, ``quality_gap`` on 2,048 rows, ``asymptotics`` at
     its defaults and ``python -m simplex_gp_torch.sweep configs/simplexgp.yml
     --limit 1 --epochs 1`` (a process of its own, beside the other three);
 14. the exact backward on the CG's chain plan (the sort chain's reverse
     mode): K3'c transposed (the fused axes in reverse order over the
     inverse transitions) and its maps torch.equal to their plain twins over
     the live rows, and the transposed chain apply (output and final-order
     table) torch.equal to its plain version and a second call, at elevators
     (untrimmed, median init) and houseelectric (capacity 32,768), c = 1 and
     11, timed beside the forward's axes and apply and the bound; the chain
     backward's gradients (inv_ell, outputscale) against the join backward's
     from the same forward at both (cos 0.999, rel 2e-2, the bounds of the
     gradients against JAX), and two chain backwards bit for bit; one
     elevators training step's launches (no K2, row build, K9 or K3; one
     K3'c transposed and its maps, one K5);
 15. the chunked chain's shapes at houseelectric (median init): the range
     sketch's plan of the training rows at the autotrimmed capacity (15.7M
     contributions) and the rect predict's untrimmed plan of [train; val]
     (19.7M contributions): K3'a against its plain twin in every field, its
     time, stages and peak; on each a block of 8 and of 16 columns through
     K3'b, the fused K3'c, K3'd, the maps, K3'c transposed and the fused
     apply forward and transposed, each torch.equal to its plain twin and
     timed beside its bound; the block loop at c = 100 (101) in blocks of
     16 and of 8 columns, torch.equal to each other, timed in turns beside
     K9 on the join plan of the same positions, with each one's peak memory.

The line before the last is the card; the one before it a JSON object of
the kernels (launches on the slice -- K3 has none there since the range
sketch runs K9 on its plan's row lists; for K5, on the trainer run; for K7, on
the deriv-mode Adam steps; for K4 and K8, on the three mvm_err runs; for K9,
its row lists, on the slice (0 on the houseelectric trainer run, which
runs the chunked chain); for the bounded K2, on the houseelectric trainer
run (0: no path trims a join plan); for K11a, K11b (the sharded
join's, 0 since the step runs the sharded chain), the chain's unblock, K6' and K10',
on the two ranks' data-parallel NLML step; for K12, on the mixture trainer
run; for K13, on the SKIP trainer run; for K3', in one training step (the
per-axis K3'c, chain_axis, is off the path since the fused axes: 0; K3'c
transposed once, in the backward); for
K10, on one training step and one posterior_cache --,
errors, times, and
each kernel's bound: the larger of the bytes it must move over the card's
memory rate and its float operations over the card's float32 rate).  The last line is
{"ok": true, "device": {...}} only if every phase passed; otherwise the
script exits 1.  It exits 2 when no CUDA device is present.  It never
imports jax.

    python3 chip_smoke.py --ranks 4

runs only phase 7.3-7.5, over four NCCL ranks on four cards of one host
(its elevators rows cut to a multiple of 4), against one process on the
first card.
"""

from __future__ import annotations

import contextlib
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
DERIV_GOLDEN = ROOT / "tests" / "fixtures" / "elevators_deriv_golden.npz"
HOUSE_GOLDEN = ROOT / "tests" / "fixtures" / "houseelectric_golden.npz"
MIXTURE_GOLDEN = ROOT / "tests" / "fixtures" / "elevators_mixture_golden.npz"
PRECIP_GOLDEN = ROOT / "tests" / "fixtures" / "precipitation_baselines_golden.npz"
SPARSE_GOLDEN = ROOT / "tests" / "fixtures" / "elevators_sparse_screened_golden.npz"
R5_RUNS = ROOT / "runs" / "r5"
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
# code with K1), and its dots and the E product summed in the plain twin's
# order, so the two are gated bit for bit.  The mixture's
# position gradient weights the stacked K5 on the card and sums its
# components in another order than the check's: rel K5_REL there.
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
# Phase 5.  K4 is K3's operator with the same atomic splat: K3_REL, and the
# occupancy is exact.  K7 fed the plain version's derivative plan: an atomic
# splat of 418 columns, then a four-term difference with cancellation.
K7_REL = 1e-4
# Deriv-mode NLML, gradients and Adam steps: phase 4's bounds (NLML_ATOL,
# GRAD_COS, GRAD_REL, ADAM_*); the backward adds one K4 and one K7, each
# ~1e-6 from JAX's.
# mvm_err at elevators against JAX on the CPU: the one-shot filters differ
# by the chain-vs-join rel 2e-5, the dense products by f32 summation order.
MVM_ERR_ATOL = 1e-3
# Phase 6.  At the median init a houseelectric lattice row sums ~790
# contributions (1.31M points x 12 vertices over 19,919 rows), so the
# splat's atomic order moves outputs by rel ~5e-6 from run to run (two runs
# of the same K3 on the same plan: printed in 6.3; K9 vs K3 measured 5.3e-6,
# the bounded plan vs the untrimmed one 8.1e-6 on the H100).  Every operator
# comparison of the phase takes the chain-vs-join bound, rel 2e-5.
LARGE_N_REL = 2e-5
# JAX elevates the positions by a matmul (x @ E.T), the port by K1's
# sequential sum (bit-equal to its plain version); in the last bits they
# differ for nearly every point, and at 1.31M points one point lands in
# another simplex: occupancy 19,919 against JAX's 19,918 (the port's plain
# version on the CPU gives 19,919 too).
OCC_REL = 1e-4
# Phase 7.  The sharded filter over two ranks against K3 on one process: the
# same operator (K11a numbers the rows otherwise, K2's order is the CAS
# order), both atomic splats, and the two ranks' partial tables summed by the
# reduce-scatter; the chain-vs-join bound, rel 2e-5, as in phase 6.  The
# data-parallel NLML and gradients take phase 4's NLML_ATOL / GRAD_COS /
# GRAD_REL against one process on the same 10,622 rows and probes, K11a is
# held bit-equal to its plain version, K11b and K6' take K3_REL and the K6
# bounds.
PARALLEL_FILTER_REL = 2e-5
# The sharded sort chain (the data-parallel engine's plan) against the one-process chain on the same
# positions: the same plan and operations, except that each live row's splat sum is split into the ranks'
# partial sums, which the reduce-scatter adds (f32 rounding of a reordered sum, rel ~1e-7 at elevators):
# K3_REL.  Each rank's kernels against their plain versions, and a second call, bit for bit; at P = 1
# (one NCCL rank) the apply is the one-device apply bit for bit (torch.equal).
SHARDED_CHAIN_REL = K3_REL
# The wide filters above _JOIN_MAX_ROWS (the houseelectric range sketch and rect predicts, phases 6.5 and
# 13.2) run the chunked chain; K9's route on the join plan, on the same inputs, is the same operator: the
# sketch's K_hat Omega and the rect filter of the same columns within the chain-vs-join bound (LARGE_N_REL);
# the root and the predictions of each route from its own sketch under the serving gates (PREDICT_MEAN_ATOL
# for the mean row by row, RMSE_ATOL / NLL_ATOL); the root itself is printed (a QR and an eigh of the
# sketch, whose conditioning scales the operator's difference).  Phase 15 holds each chain kernel at the
# chunked chain's shapes torch.equal to its plain twin, and the 8- and 16-column blocks to each other.
# Phase 3's range sketch apply (K9 on the join plan's row lists, no atomics)
# against K3's atomic apply of the same operator at c = 100: K3_REL.
SKETCH_K3_REL = K3_REL
# Phase 8.  K12 runs on the stacked plan's row lists with no atomics, each
# sum in its plain version's order: against its plain version bit for bit
# (torch.equal, outputs and the read rows of its table; K3_REL while it
# splatted with atomics); against the J-fold K3 loop, K3's atomic splat
# (K3_REL); against JAX's mixture MVM, the chain-vs-join bound (LARGE_N_REL);
# the stacked K5, K5_REL.  The NLML, gradients, Adam steps and serving take
# phase 4's and phase 3's bounds with JAX's weights fed in; the engine runs
# JAX's plan, one chain plan a component, and K12's stacked route on the same
# inputs is printed beside it, the CG's MVM on the two routes held to the
# chain-vs-join bound (LARGE_N_REL).
# The port's own subset fit: NNLS can change its active set on a
# rounding-level change of its columns (the port's filters differ from JAX's
# by ~1e-6), so the fit is held through the operator it gives on a probe
# against the operator of JAX's weights: both are least-squares fits of one
# target over nearly the same columns, rel 1e-2.
MIX_FIT_REL = 1e-2
# Phase 10.  K3', the sort chain, has no atomics: its build is the plain
# build bit for bit (the same torch.sort calls on the same keys), its splat
# sums each row in its plain version's order and its stencils and slice use
# the plain version's IEEE operations in their order, so kernel and plain
# are bit-equal: the build, the splat, the slice and the apply are gated bit
# for bit (the axis alone on one input at max |diff| 10 CHAIN_REL).
# Against the join (K1 + K2, K3) on the same positions, the chain-vs-join
# bound (LARGE_N_REL).  Two builds and two applies must repeat bit for bit,
# and so must the NLML and the eval CG built on them.
CHAIN_REL = 1e-6
# Phase 9.  K13b, K13c and K13d against their plain versions: float32 sums of
# r or r k products (and of the rows, in chunks of whole 32-row stages, for
# K13c) in another order, the plain versions' products in cuBLAS's; K13a the same
# float32 formula, each product and add rounded on its own in tap order, where
# the plain version's torch.sum over the taps picks its own order: K13_REL for
# all.  Each of K13a-d sums in a fixed order with no atomics, so a second call
# is gated bit for bit; so is K13a's backward, which sums in its plain
# version's order (equal to it too).
K13_REL = 1e-5

# K14, the SLQ quadrature (phases 4.5, 4.6 and 6.5), on the training CG's records: it solves each probe's
# leading block in double, so against float64 eigh of the same float32 band (on the CPU) only its output's
# float32 rounding is left, while the float32 eigh path on the card (cuSOLVER, the port's route before it)
# carries float32 roundoff of the whole eigendecomposition.  Per probe the kernel may be no further from the
# float64 value than SLQ_F32_FACTOR times the float32 path, plus one float32 ulp of the value (its own
# rounding, for a probe the float32 path happens to land on).
SLQ_F32_FACTOR = 2.0
# SKIP against JAX on the CPU (golden, JAX's Omega, JAX's signs matched to
# the port's).  The grid kernels' 30-odd smallest kept eigenvalues lie
# within float32 roundoff of each other, so two LAPACKs return other
# eigenvectors for them (rotations within that cluster, not signs) and the
# fixed Omega sketches another subspace.  Measured between torch's and JAX's
# CPU LAPACKs at these 65,536 rows: |dNLML| 3.2e-5 (init) and 1.7e-4
# (model_best); R R^T on 256 rows rel 1.1e-2 / 3.9e-3; the served mean rms
# 0.071 (max 0.46) over the 4,096 golden rows, RMSE 0.3210 against 0.3215.
# The sign convention alone moves JAX's own NLML by 6e-3 (init) and 3e-3
# (best) and its model_best lengthscale gradient from [0.046, -0.030,
# -0.0009] to [0.0001, 0.0032, 0.0003]: there eigh's backward divides by
# roundoff-sized gaps, and the port's CPU run gives [0.025, -0.020,
# -0.0009].  So: NLML 1e-3 at both points; the whole raw gradient cos / rel
# (GRAD_COS, GRAD_REL) at the median init, where it is well conditioned
# (measured rel 7e-3); at model_best only the noise gradient (rel
# GRAD_REL; measured 3.4e-3), the rest printed; R R^T rel 0.05; the served
# mean rms 0.15; the test RMSE within 0.005 of round 5's 0.3196 (the NLL
# is the reference's broken variance, ROADMAP section 3: printed only).
SKIP_RRT_REL = 5e-2
SKIP_MEAN_RMS = 0.15
BASELINE_RMSE_ATOL = 5e-3
# SGPR against JAX on the CPU with JAX's inducing rows: float32 Cholesky
# factors and solves in another order (measured on the CPU: |dNLML| 2e-6,
# the whole raw gradient rel 1.7e-4, mean rms 1.3e-5).  NLL within 0.02.
SGPR_NLL_ATOL = 2e-2
SGPR_MEAN_RMS = 1e-3
# The round-5 baseline runs' flags (runs/r5/{skip,sgpr,exact}_precipitation_s0).
BASELINE_FLAGS = ["--dataset", "precipitation", "--kernel", "matern", "--nu", "1.5", "--min-noise", "0.1",
                  "--ls-init", "median"]
# The round-5 houseelectric run's flags (experiments/queue_r5_stage9.sh:15-18,
# without --host-loop, which is not ported).
HOUSE_FLAGS = ["--dataset", "houseelectric", "--kernel", "matern", "--nu", "1.5", "--order", "1", "--min-noise",
               "0.1", "--ls-init", "median", "--plan-capacity", "-1", "--cg-tol", "1.0"]
# Phase 13, ARD screening at 0.3 (the round-5 screened runs, experiments/queue_r5_stage2.sh:14-17): the
# elevators configuration on the _sparse stand-ins, the irrelevant dims at raw lengthscale 60.  The screened
# test RMSE and NLL take the serving gates (RMSE_ATOL, NLL_ATOL) against JAX on the CPU; the kept dims are
# JAX's exactly (they sit far from the threshold); the screened occupancy within rel 1e-4 of JAX's count
# (phase 6: K1 and JAX's matmul elevation can put a point in another simplex).
PRUNE_THRESH = 0.3
IRRELEVANT_RAW_LENGTHSCALE = 60.0
OCCUPANCY_REL = 1e-4
SPARSE_FLAGS = ["--kernel", "matern", "--nu", "1.5", "--order", "1", "--min-noise", "0.1"]
EPOCH_KEYS = {"epoch", "train/mll", "train/loss_ts", "hyp/noise", "hyp/outputscale", "hyp/ell_mean",
              "hyp/ell_min", "hyp/ell_max", "hyp/d_eff_30"}
VAL_KEYS = {"val/rmse", "val/mae", "val/nll", "val/pred_ts"}
TEST_KEYS = {"test/rmse", "test/mae", "test/nll", "test/pred_ts"}
# One NVIDIA H100 SXM at its full 700 W (NVIDIA's data sheet): device memory
# rate and float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# The reference's one-shot filter, seconds per MVM on real data, on a GPU the
# reference does not name (SURVEY.md section 6).
REFERENCE_ONESHOT_S = {"elevators": 0.083, "precipitation": 0.082, "houseelectric": 1.756}

KERNEL_ROWS = {
    "lattice_geometry": ("simplex_gp_torch/csrc/geometry.cu", "simplex_gp_tpu/ops/lattice.py:141"),
    "lattice_dedup_neighbors": ("simplex_gp_torch/csrc/dedup.cu", "simplex_gp_tpu/ops/lattice.py:387"),
    "lattice_apply": ("simplex_gp_torch/csrc/apply.cu", "simplex_gp_tpu/ops/lattice.py:470"),
    "pivot_column": ("simplex_gp_torch/csrc/pivot.cu", "simplex_gp_tpu/linalg/pivoted_cholesky.py:106"),
    "lattice_filter_grad": ("simplex_gp_torch/csrc/grad.cu", "simplex_gp_tpu/ops/filter.py:143"),
    "filter_once": ("simplex_gp_torch/csrc/once.cu", "simplex_gp_tpu/ops/lattice.py:1166"),
    "count_lattice_points": ("simplex_gp_torch/csrc/once.cu", "simplex_gp_tpu/ops/lattice.py:839"),
    "lattice_deriv_grad": ("simplex_gp_torch/csrc/deriv.cu", "simplex_gp_tpu/ops/filter.py:261"),
    # K9: the wide filter's join branch below _JOIN_MAX_ROWS (make_wide_filter's apply, and _filter_plain's :137);
    # above it the port runs JAX's chunked chain (:65-84, :99-115) on K3'.
    "lattice_apply_cols": ("simplex_gp_torch/csrc/apply.cu", "simplex_gp_tpu/ops/filter.py:117"),
    # K9's and K7's row lists: the chain plan's contribution order and run ends (_chain_core's cnt).
    "join_rows": ("simplex_gp_torch/csrc/apply.cu", "simplex_gp_tpu/ops/lattice.py:756"),
    "lattice_dedup_neighbors_bounded": ("simplex_gp_torch/csrc/dedup.cu", "simplex_gp_tpu/ops/lattice.py:693"),
    "lattice_dedup_ordered": ("simplex_gp_torch/csrc/dedup.cu", "simplex_gp_tpu/parallel/shard_filter.py:118"),
    "lattice_apply_sharded": ("simplex_gp_torch/csrc/apply.cu", "simplex_gp_tpu/ops/lattice.py:499"),
    # The sharded chain apply's gathered (P, n_lattice, cb) column blocks into the (n_lattice, c) table: the
    # layout half of JAX's all_gather along the columns and its cut to c_in (apply_plan_chain :1059-1061).
    "chain_unblock": ("simplex_gp_torch/csrc/chain.cu", "simplex_gp_tpu/ops/lattice.py:1059"),
    # K6' is pivot_column given the pivot's rows; its launches are the wrapper's sharded_launches.
    "pivot_column_at": ("simplex_gp_torch/csrc/pivot.cu", "simplex_gp_tpu/linalg/pivoted_cholesky.py:129"),
    "lattice_mixture_apply": ("simplex_gp_torch/csrc/mixture.cu", "simplex_gp_tpu/ops/filter.py:167"),
    "ski_interp": ("simplex_gp_torch/csrc/ski.cu", "simplex_gp_tpu/models/ski.py:108"),
    "ski_interp_backward": ("simplex_gp_torch/csrc/ski.cu", "simplex_gp_tpu/models/ski.py:108"),
    "ski_kr_matmul": ("simplex_gp_torch/csrc/ski.cu", "simplex_gp_tpu/models/ski.py:119"),
    "ski_kr_gram": ("simplex_gp_torch/csrc/ski.cu", "simplex_gp_tpu/models/ski.py:121"),
    "ski_kr_adjoint": ("simplex_gp_torch/csrc/ski.cu", "simplex_gp_tpu/models/ski.py:114"),
    "chain_build": ("simplex_gp_torch/csrc/chain.cu", "simplex_gp_tpu/ops/lattice.py:857"),
    "chain_splat": ("simplex_gp_torch/csrc/chain.cu", "simplex_gp_tpu/ops/lattice.py:1030"),
    "chain_axis": ("simplex_gp_torch/csrc/chain.cu", "simplex_gp_tpu/ops/lattice.py:1064"),
    # K3'c fused: the d+1 axes of an apply in one launch, what the path runs (chain_axis: 0 launches there).
    "chain_axes": ("simplex_gp_torch/csrc/chain.cu", "simplex_gp_tpu/ops/lattice.py:1010"),
    "chain_slice": ("simplex_gp_torch/csrc/chain.cu", "simplex_gp_tpu/ops/lattice.py:1077"),
    # K3'c transposed: the exact backward's B^T on the CG's chain plan, JAX's reverse mode of the axes' stencils
    # and transition sorts (apply_plan_chain :1010-1027, transposed by jax.vjp).
    "chain_axes_transpose": ("simplex_gp_torch/csrc/chain.cu", "simplex_gp_tpu/ops/lattice.py:1010"),
    # K10, the CG body (lax.while_loop body :133-205) and its initial state (:118-125, :220).
    "cg_dot": ("simplex_gp_torch/csrc/cg.cu", "simplex_gp_tpu/linalg/cg.py:136"),
    "cg_step_x": ("simplex_gp_torch/csrc/cg.cu", "simplex_gp_tpu/linalg/cg.py:145"),
    # The Woodbury solve (pivoted_cholesky.py::precond_solve :242-253) in K10's own passes over U: U^T r
    # (_ut_v :236), its fold with w (:253), then r / noise - U (w U^T r) with r . z (:253, cg.py:147-148).
    "cg_utr": ("simplex_gp_torch/csrc/cg.cu", "simplex_gp_tpu/linalg/pivoted_cholesky.py:236"),
    "cg_fold": ("simplex_gp_torch/csrc/cg.cu", "simplex_gp_tpu/linalg/pivoted_cholesky.py:253"),
    "cg_precond": ("simplex_gp_torch/csrc/cg.cu", "simplex_gp_tpu/linalg/cg.py:147"),
    "cg_step_p": ("simplex_gp_torch/csrc/cg.cu", "simplex_gp_tpu/linalg/cg.py:150"),
    "cg_init": ("simplex_gp_torch/csrc/cg.cu", "simplex_gp_tpu/linalg/cg.py:118"),
    # K10', the same body over sharded rows (every dot a psum, cg.py:113-115): the three kernels that reduce a
    # dot, given every rank's gathered block partials; P = 2 on the gloo ranks, launches on their NLML step.
    "cg_step_x_sharded": ("simplex_gp_torch/csrc/cg.cu", "simplex_gp_tpu/linalg/cg.py:113"),
    "cg_step_p_sharded": ("simplex_gp_torch/csrc/cg.cu", "simplex_gp_tpu/linalg/cg.py:113"),
    "cg_init_sharded": ("simplex_gp_torch/csrc/cg.cu", "simplex_gp_tpu/linalg/cg.py:113"),
    # The ranks' U^T r added in rank order (JAX's psum of U^T V, pivoted_cholesky.py:237-238).
    "cg_fold_sharded": ("simplex_gp_torch/csrc/cg.cu", "simplex_gp_tpu/linalg/pivoted_cholesky.py:238"),
    # K14: the quadrature of the CG record's tridiagonals (logdet_from_cg_tridiag :177; slq_logdet's :128).
    "slq_quadrature": ("simplex_gp_torch/csrc/slq.cu", "simplex_gp_tpu/linalg/lanczos.py:177"),
}


def chain_kernels() -> tuple:
    """The wrappers of K3'a-d on the path, K3'c the fused axes (imported when called: the script must fail
    without the repo)."""
    from simplex_gp_torch.kernels import chain as KC

    return KC.chain_build, KC.chain_splat, KC.chain_axes, KC.chain_slice



def bound(nbytes: float, ops: float) -> dict:
    """bound_ms and bound_by: the larger of bytes over the memory rate and float ops over the f32 rate.

    Each input is counted read once and each output written once; the hash
    tables, lattice tables and atomics inside a kernel are its own traffic,
    not the function's.  Integer hashing is not counted as operations.
    """
    t_bytes, t_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / F32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def k5_bound(n: int, d: int, c: int, n_lattice: int) -> dict:
    """K5's bound: ref, seg ids, v, g and the live rows of both tables in, grad_ref out; per contribution a
    dot of 2c products and the E product's d+1 multiply-adds a coordinate."""
    N = n * (d + 1)
    return bound(4 * (2 * n * d + N + 2 * n * c + 2 * min(n_lattice, N) * c), 4 * N * c + N * (3 * d + 1))


def geometry_ops(n: int, d: int) -> int:
    """Float operations of K1's per-point work: elevation, rounding, ranks, weights."""
    return n * (d + 1) * (3 * d + 9)


def apply_cost(n: int, d: int, c: int, n_lattice: int, order: int) -> tuple:
    """(bytes, ops) of K3 / K9: seg ids, weights and the live neighbour rows in, v in, out written;
    splat and slice multiply-adds, and (2r+1) taps per live row, column and axis."""
    N = n * (d + 1)
    nbytes = 4 * (2 * N + (d + 1) * n_lattice * 2 * order + 2 * n * c)
    return nbytes, 4 * N * c + 2 * (2 * order + 1) * (d + 1) * n_lattice * c + n * c


def dedup_bytes(N: int, M: int, dp1: int, order: int) -> int:
    """K2: the N hash pairs in, the N seg ids and the (d+1, M, 2r) neighbours out."""
    return 4 * (2 * N + N + dp1 * M * 2 * order)


def rows_bytes(N: int, M: int) -> int:
    """The row lists: the seg ids and weights in; each contribution's point and weight and each row's run end
    out (the lists of mid rows and pieces, under 1% of it, are left out)."""
    return 4 * (4 * N + M)


def cg_iteration_bytes(n: int, c: int, k: int) -> int:
    """K10: one CG iteration's vector updates over (n, c) -- x, r, p and the best iterate read and
    written, r z and r r read for the dots -- and the Woodbury solve's two reads of U (n, k)."""
    return 4 * (17 * n * c + 2 * n * k)


def u_pass_cost(name: str, n: int, k: int, t: int, nb: int) -> tuple:
    """(bytes, ops) of K10's passes over U and of the cuBLAS product that does the same pass: U and r read
    once, the outputs written once; a multiply and an add a product."""
    return {
        "cg_utr": (4 * (n * k + n * t + nb * k * t), 2 * n * k * t),  # U, r in; the block partials out
        "cg_precond": (4 * (n * k + k * t + 2 * n * t + 1 + nb * t), 2 * n * k * t + 4 * n * t),  # U, G2, r in; z out
        "mm_utr": (4 * (n * k + n * t + k * t), 2 * n * k * t),  # torch.mm(U.T, r)
        "mm_ug": (4 * (n * k + k * t + n * t), 2 * n * k * t),  # torch.mm(U, G2)
    }[name]


def slq_case(res, timer) -> dict:
    """K14 on a training CG's record (its probe columns), as logdet_from_cg_tridiag calls it: each probe's leading
    block, the kernel's error and the float32 eigh path's (on the card) against float64 eigh of the same band on
    the CPU, a second call's bits and the band form's on cg_band's band, the times of the kernel (launched,
    graph-replayed), its plain version (the band and the float32 eigh) and the library's eigh alone, and the
    bound of gpbench/counts.py's SLQ term (a dense eigh of m = min(iterations, 100))."""
    import torch

    from simplex_gp_torch.kernels import slq as KQ

    rec = (res.alphas[:, 1:], res.betas[:, 1:], res.tmask[:, 1:])
    diag, off = KQ.cg_band(*rec)
    got, again, f32 = KQ.slq_quadrature_cg(*rec), KQ.slq_quadrature_cg(*rec), KQ.slq_quadrature_plain(diag, off)
    dn, on = diag.double().cpu(), off.double().cpu()
    lam, vec = torch.linalg.eigh(torch.diag_embed(dn) + torch.diag_embed(on, offset=1) + torch.diag_embed(on, offset=-1))
    want = (vec[:, 0, :] ** 2 * torch.log(torch.clamp(lam, min=float(np.float32(1e-10))))).sum(dim=-1)
    err, err32 = (got.double().cpu() - want).abs(), (f32.double().cpu() - want).abs()
    ulp = torch.from_numpy(np.spacing(np.abs(want.numpy()).astype(np.float32)).astype(np.float64))
    lengths = [int(torch.nonzero(r_ == 0)[0]) + 1 if bool((r_ == 0).any()) else dn.shape[1] for r_ in on]
    dense = torch.diag_embed(diag) + torch.diag_embed(off, offset=1) + torch.diag_embed(off, offset=-1)
    p, m, m_counted = diag.shape[0], diag.shape[1], min(res.iterations, 100)
    return dict(p=p, m=m, cg_iters=res.iterations, block_lengths=lengths, max_abs_err=float(err.max()),
                kernel_err=err.tolist(), f32_eigh_err=err32.tolist(), ulp=ulp.tolist(),
                within=bool((err <= SLQ_F32_FACTOR * err32 + ulp).all()),
                bit_equal=bool(torch.equal(got, again) and torch.equal(got, KQ.slq_quadrature(diag, off))),
                ms=timer(lambda: KQ.slq_quadrature_cg(*rec), 50),
                graph_ms=graph_ms(lambda: KQ.slq_quadrature_cg(*rec), 20),
                plain_ms=timer(lambda: KQ.slq_quadrature_plain(*KQ.cg_band(*rec)), 10),
                library_ms=timer(lambda: torch.linalg.eigh(dense), 10),
                **bound(4 * p * m_counted ** 2, 9 * p * m_counted ** 3),
                shape=f"p={p}, m={m}, blocks {min(lengths)}-{max(lengths)}")


def slq_gate(case: dict, expect, tag: str) -> None:
    expect(case["within"] and case["bit_equal"],
           f"{tag}: K14 per probe within {SLQ_F32_FACTOR} x the float32 eigh path's error of float64 eigh (+1 ulp): "
           f"worst {case['max_abs_err']:.3e} against the float32 path's {max(case['f32_eigh_err']):.3e}; blocks "
           f"{case['block_lengths']} of {case['m']}; a second call and the band form bit-equal {case['bit_equal']}; "
           f"{case['ms']:.4f} ms (graph {case['graph_ms']:.4f}) against the float32 eigh's {case['plain_ms']:.4f}")


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


def graph_ms(fn, reps: int) -> float:
    """Device time of ``fn`` in ms: ``reps`` calls captured in one CUDA graph and replayed, so the
    host's work between launches (Python, argument checks) is left out."""
    import torch

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


def rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def cosine(a, b) -> float:
    return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def sketch_apply(dev, ref, dk, expect) -> dict:
    """Phase 3's range-sketch apply at c = 100 on the trained positions' join plan, as posterior_cache runs it:
    K9 in windows of 32 on the plan's row lists (make_wide_filter's route), against K9 in one window of the
    100 columns and its plain version (bit for bit: columns do not interact) and a second run, and against
    K3's atomic apply (SKETCH_K3_REL); the times of each and of the row build, with the bound."""
    import torch

    from simplex_gp_torch.kernels import lattice as K
    from simplex_gp_torch.ops import filter as F
    from simplex_gp_torch.ops import lattice as L

    n, d = ref.shape
    plan = L.wide_plan(L.build_plan_join(ref, dk.coeffs, dk.variance))
    omega = torch.randn((n, 100), generator=torch.Generator(device=dev).manual_seed(8), device=dev)
    taps, norm, nl = list(dk.coeffs), L.SLICE_NORM(d), int(plan.n_lattice)
    args = (*plan[:4], omega, taps, norm)
    route = F.apply_plan_wide(plan, omega, dk)
    one = K.lattice_apply_cols(*args, 100, plan.rows)
    plain = K.apply_cols_plain(*args, 100, plan.rows)
    k3 = K.lattice_apply(*args)
    equal = dict(plain=bool(torch.equal(route, plain)), one_window=bool(torch.equal(route, one)),
                 again=bool(torch.equal(route, F.apply_plan_wide(plan, omega, dk))))
    r3 = rel(route, k3)
    expect(all(equal.values()), f"range sketch apply (K9, windows of 32) bit-equal to plain / one window of 100 / "
           f"a second run: {equal}")
    expect(r3 <= SKETCH_K3_REL, f"range sketch apply vs K3's: rel {r3:.3e} (limit {SKETCH_K3_REL})")
    return dict(n_lattice=nl, bit_equal=equal, k3_rel=r3,
                k9_window_32_ms=cuda_ms(lambda: F.apply_plan_wide(plan, omega, dk), 20),
                k9_one_window_ms=cuda_ms(lambda: K.lattice_apply_cols(*args, 100, plan.rows), 20),
                k3_ms=cuda_ms(lambda: K.lattice_apply(*args), 10),
                row_build_ms=cuda_ms(lambda: K.join_rows(*plan[:4]), 20),
                **bound(*apply_cost(n, d, 100, nl, dk.order)))


def training_phase(dev, ds, expect, timer):
    """Phase 4: the training path at elevators.  Returns (K5's kernel row, the record)."""
    import tempfile

    import torch

    import simplex_gp_torch
    from simplex_gp_torch import train as trainer
    from simplex_gp_torch.kernels import chain as KC
    from simplex_gp_torch.kernels import lattice as K
    from simplex_gp_torch.kernels import slq as KQ
    from simplex_gp_torch.kernels.pivot import pivot_column
    from simplex_gp_torch.linalg import mll
    from simplex_gp_torch.linalg.cg import cg_solve
    from simplex_gp_torch.linalg.lanczos import logdet_from_cg_tridiag
    from simplex_gp_torch.linalg.pivoted_cholesky import precond_sqrt
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
        seg, w, nb, nl = L.build_plan_join(ref, dk.coeffs, dk.variance)  # K3's yardstick plan
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
        expect(bool(torch.isfinite(gr_k).all()) and torch.equal(gr_k, gr_p),
               f"K5 vs plain on the same tables: bit-equal {torch.equal(gr_k, gr_p)} (rel {r5:.3e})")
        expect(torch.equal(gr_k, K.lattice_filter_grad(ref, E, seg, v, g, tf_k, tb_k, norm)),
               "two K5 runs bit-equal")
        r5_route = rel(gr_k, K.lattice_filter_grad_plain(ref, E, seg, v, g, tf_p, tb_p, norm))
        print(f"    K5 vs the all-plain route (plain tables too): rel {r5_route:.3e}")
        k5 = dict(max_abs_err=float((gr_k - gr_p).abs().max()),
                  ms=timer(lambda: K.lattice_filter_grad(ref, E, seg, v, g, tf_k, tb_k, norm), 50),
                  plain_ms=timer(lambda: K.lattice_filter_grad_plain(ref, E, seg, v, g, tf_k, tb_k, norm), 10),
                  graph_ms=graph_ms(lambda: K.lattice_filter_grad(ref, E, seg, v, g, tf_k, tb_k, norm), 20),
                  **k5_bound(n, d, 11, int(nl)), library_ms=None, shape=f"n={n}, d={d}, c=11, n_lattice={int(nl)}")
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
    # Run to run: the CG and the backward run on the chain (no atomics).
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
    # The exact backward reuses the CG's chain plan (K3'c transposed); the eval (range sketch and predict) runs
    # K9 on its join plans' row lists.
    kernels = (K.lattice_geometry, K.lattice_dedup_neighbors, K.join_rows, K.lattice_apply_cols, pivot_column,
               K.lattice_filter_grad, *chain_kernels(), KC.chain_axes_transpose, KQ.slq_quadrature)
    for fn in kernels:
        fn.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        summary = trainer.main(["--dataset", "elevators", "--kernel", "matern", "--nu", "1.5", "--order", "1",
                                "--min-noise", "0.1", "--ls-init", "median", "--cg-tol", "1.0", "--cg-iter", "500",
                                "--lanc-iter", "100", "--pre-size", "100", "--num-probes", "10", "--epochs", "2",
                                "--out", tmp, "--device", dev.type])
    launches = {fn.__name__: fn.launches for fn in kernels}
    print(f"    launches on the trainer run: {launches}")
    expect(all(v > 0 for v in launches.values()), "every kernel launched on the trainer run")
    losses, final = [-r["train/mll"] for r in summary["records"]], summary["final"]
    expect(all(np.isfinite(losses)) and np.isfinite(final["test/nll"]) and final["test/rmse"] < ENTRY_RMSE_MAX,
           f"trainer: losses {losses}, test RMSE {final['test/rmse']:.4f} (limit "
           f"{ENTRY_RMSE_MAX}), NLL {final['test/nll']:.4f}")
    record.update(trainer=summary, trainer_launches=launches)

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
        plan = build_plan_any(ref, dk)  # the chain plan, as the engine builds it
        mark(1)
        P = mll.build_precond(dk, cfg, params, ref, n)
        mark(2)
        s, noise = params["outputscale"], params["noise"]
        b = precond_sqrt(P, z)
        res = cg_solve(lambda V: L.apply_plan_chain(plan, V, dk.coeffs),
                       torch.cat([(y - params["mean"])[:, None], b], dim=-1), tol=cfg.cg_tolerance,
                       max_iters=cfg.max_cg_iterations, precond=P, tridiag_m=100, shift=(s, noise))
        mark(3)
        logdet_from_cg_tridiag(res.alphas[:, 1:], res.betas[:, 1:], res.tmask[:, 1:], (z * z).sum(0))
        mark(4)
    loss = model.nlml(x, y, probes=z)
    mark(5)
    loss.backward()
    mark(6)
    if ev is not None:
        torch.cuda.synchronize()
        names = ("plan", "preconditioner", "cg", "slq", "forward", "backward")
        stages = {nm: ev[i].elapsed_time(ev[i + 1]) for i, nm in enumerate(names)}
        a0, a1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a0.record()
        opt.step()
        a1.record()
        torch.cuda.synchronize()
        stages["adam"] = a0.elapsed_time(a1)
        stages["cg_iters"] = res.iterations
        with torch.no_grad():
            stages.update(backward_parts((x * model.constrained()["inv_ell"]).contiguous(), dk, None, 11, 9))
        warm = timer(lambda: train_step(model, opt, x, y, z), 5)
        print(f"    warm training step {warm:.2f} ms (CUDA events); stages (ms): "
              + json.dumps({k: round(v, 3) for k, v in stages.items()}))
        record.update(step_ms=warm, stages=stages)

    print("training 4.6: K14 slq_quadrature on the step's CG record and on a 100-step record vs float64 eigh")
    with torch.no_grad():
        record["slq"] = slq_case(res, timer)
        slq_gate(record["slq"], expect, "elevators training CG record")
        # All 100 steps of the record live: the largest block the training path can give, with the repeated
        # Ritz values of a CG that has lost orthogonality.
        res100 = cg_solve(lambda V: L.apply_plan_chain(plan, V, dk.coeffs),
                          torch.cat([(y - params["mean"])[:, None], b], dim=-1), tol=cfg.cg_tolerance, max_iters=100,
                          min_iters=100, precond=P, tridiag_m=100, shift=(s, noise))
        record["slq_100"] = slq_case(res100, timer)
        slq_gate(record["slq_100"], expect, "elevators 100-step CG record")
    print("    " + json.dumps({k: record[k] for k in ("slq", "slq_100")}))
    return k5, record


def oneshot_phase(dev, ds, expect, timer):
    """Phase 5: K4, K8, K7, deriv-mode training and mvm_err.  Returns (kernel rows, launches, record)."""
    import torch

    import simplex_gp_torch
    from simplex_gp_torch import mvm_err
    from simplex_gp_torch.kernels import lattice as K
    from simplex_gp_torch.linalg import mll
    from simplex_gp_torch.ops import kernels as kern
    from simplex_gp_torch.ops import lattice as L
    from simplex_gp_torch.ops.filter import lattice_filter
    from simplex_gp_torch.utils import data

    golden = np.load(DERIV_GOLDEN)
    x = torch.from_numpy(ds.train_x).to(dev)
    y = torch.from_numpy(ds.train_y).to(dev)
    n, d = x.shape
    cfg = mll.BBMMConfig(cg_tolerance=1.0, max_cg_iterations=500, max_lanczos_iterations=100,
                         precond_rank=100, num_probes=10, slq_mode="cg", grad_mode="deriv_filter")
    model = simplex_gp_torch.SimplexGP(num_dims=d, kernel="matern", nu=1.5, order=1, min_noise=0.1,
                                       bbmm=cfg, device=dev)
    dk = model.dk
    rows, record = {}, {}

    def point(tag):
        return {k: golden[f"{tag}_{k}"] for k in RAW_NAMES}

    def probes(seed):
        z = np.random.default_rng(int(seed)).choice([-1.0, 1.0], size=(n, cfg.num_probes))
        return torch.from_numpy(z.astype(np.float32)).to(dev)

    print("one-shot 5.1: K4 lattice_filter_once vs plain, bit for bit, and a second call (median-init training "
          "positions)")
    model.load_raw(point("init"))
    with torch.no_grad():
        ref = (x * model.constrained()["inv_ell"]).contiguous()
        E, a, oh1, oh2 = L._lattice_constants(d, dk.coeffs, dk.variance, dev)
        taps, norm, N = list(dk.coeffs), L.SLICE_NORM(d), n * (d + 1)
        gen = torch.Generator(device=dev).manual_seed(5)
        k4_err, k4_ms, k4_plain_ms = 0.0, {}, {}
        for c in (1, 11):
            v = torch.randn((n, c), generator=gen, device=dev)
            kout, knl = K.lattice_filter_once(ref, E, a, oh1, oh2, v, taps, norm, N)
            again, _ = K.lattice_filter_once(ref, E, a, oh1, oh2, v, taps, norm, N)
            pout, pnl = K.filter_once_plain(ref, E, a, oh1, oh2, v, taps, norm, N)
            occ = int(pnl)
            expect(int(knl) == occ == int(golden["n_lattice_init"]),
                   f"c={c}: occupancy kernel {int(knl)} plain {occ} JAX {int(golden['n_lattice_init'])}")
            k4_err = max(k4_err, float((kout - pout).abs().max()))
            expect(bool(torch.equal(kout, pout) and torch.equal(again, kout)),
                   f"c={c}: bit-equal to the plain version ({torch.equal(kout, pout)}, rel {rel(kout, pout):.3e}) "
                   f"and to a second call ({torch.equal(again, kout)})")
            fit, _ = K.lattice_filter_once(ref, E, a, oh1, oh2, v, taps, norm, occ)
            expect(bool(torch.equal(fit, pout)), f"c={c}: capacity = occupancy: bit-equal to the untrimmed plain "
                   f"version ({torch.equal(fit, pout)})")
            under, _ = K.lattice_filter_once(ref, E, a, oh1, oh2, v, taps, norm, occ - 1)
            expect(bool(torch.isnan(under).all()), f"c={c}: capacity = occupancy - 1 gives all NaN")
            k4_ms[c] = timer(lambda: K.lattice_filter_once(ref, E, a, oh1, oh2, v, taps, norm, N), 20)
            k4_plain_ms[c] = timer(lambda: K.filter_once_plain(ref, E, a, oh1, oh2, v, taps, norm, N), 3)
            print(f"    c={c}: kernel {k4_ms[c]:.4f} ms, plain {k4_plain_ms[c]:.4f} ms")
    # x and v in, out written; K1's geometry, then K3's operations (the tables are K4's own).
    _, k4_ops = apply_cost(n, d, 11, occ, dk.order)
    rows["filter_once"] = dict(max_abs_err=k4_err, ms=k4_ms[11], plain_ms=k4_plain_ms[11],
                               **bound(4 * (n * d + 2 * n * 11), geometry_ops(n, d) + k4_ops), library_ms=None,
                               shape=f"n={n}, d={d}, c=11, n_lattice={occ}", ms_by_c=k4_ms,
                               plain_ms_by_c=k4_plain_ms)

    print("one-shot 5.2: K8 lattice_count vs plain (all rows of each dataset, rbf order 1)")
    rbf = kern.rbf_kernel(1)
    sets = {}
    for name in ("elevators", "precipitation", "houseelectric"):
        s = data.load_dataset(name)
        xa = torch.from_numpy(np.concatenate([s.train_x, s.val_x, s.test_x])).to(dev)
        ya = torch.from_numpy(np.concatenate([s.train_y, s.val_y, s.test_y])[:, None].copy()).to(dev)
        sets[name] = (xa, ya)
    k8_err, k8_ms, k8_plain_ms, occupancy = 0, {}, {}, {}
    with torch.no_grad():
        for name, (xa, _) in sets.items():
            Ea, aa, _, _ = L._lattice_constants(xa.shape[1], rbf.coeffs, rbf.variance, dev)
            kc, pc = int(K.lattice_count(xa, Ea, aa)), int(K.count_plain(xa, Ea, aa))
            occupancy[name] = kc
            k8_err = max(k8_err, abs(kc - pc))
            expect(kc == pc, f"{name} {tuple(xa.shape)}: count kernel {kc} plain {pc}")
            k8_ms[name] = timer(lambda: K.lattice_count(xa, Ea, aa), 5)
            k8_plain_ms[name] = timer(lambda: K.count_plain(xa, Ea, aa), 2)
            print(f"    {name}: occupancy {kc} of {xa.shape[0] * (xa.shape[1] + 1)}; kernel {k8_ms[name]:.4f} ms, "
                  f"plain {k8_plain_ms[name]:.4f} ms")
        xe = sets["elevators"][0]
        k2 = int(L.build_plan_join(xe, rbf.coeffs, rbf.variance).n_lattice)
        expect(occupancy["elevators"] == k2 == int(golden["mvm_n_lattice"]),
               f"elevators: K8 {occupancy['elevators']} vs K2 n_lattice {k2} vs JAX {int(golden['mvm_n_lattice'])}")
        xh, yh = sets["houseelectric"]
        t0 = time.perf_counter()
        guard = L.filter_once(yh, xh, rbf.coeffs, rbf.variance, occupancy["houseelectric"] - 1)
        torch.cuda.synchronize()
        guard_s = time.perf_counter() - t0
        expect(bool(torch.isnan(guard).all()), f"houseelectric: capacity = occupancy - 1 gives all NaN "
               f"({guard_s:.3f} s, no hang)")
        Eh, ah, _, _ = L._lattice_constants(xh.shape[1], rbf.coeffs, rbf.variance, dev)
        # The hot-key case: every houseelectric row replaced by the first, so each block's keys are
        # the same d+1 and every insert finds its key taken.
        xhot = xh[:1].expand(xh.shape[0], -1).contiguous()
        kc, pc = int(K.lattice_count(xhot, Eh, ah)), int(K.count_plain(xhot, Eh, ah))
        k8_err = max(k8_err, abs(kc - pc))
        expect(kc == pc == xh.shape[1] + 1, f"houseelectric size, one point repeated: count kernel {kc} plain {pc} "
               f"(d+1 = {xh.shape[1] + 1})")
        k8_ms["houseelectric, one point repeated"] = timer(lambda: K.lattice_count(xhot, Eh, ah), 5)
        del xhot
        hh1, hh2, _ = K.lattice_geometry(xh, Eh, ah)
        # torch.unique of the packed keys: the dedup stage alone, given K1's hashes; with K1's time,
        # the two-call route that counts the same points.
        k8_unique_ms = timer(lambda: torch.unique(K._pack(hh1, hh2)).numel(), 3)
        k8_k1_ms = timer(lambda: K.lattice_geometry(xh, Eh, ah), 3)
        del hh1, hh2
        k8_again_ms = timer(lambda: K.lattice_count(xh, Eh, ah), 5)
    nh, dh = xh.shape
    print(f"    houseelectric: K8 {k8_ms['houseelectric']:.4f} / {k8_again_ms:.4f} ms against K1 {k8_k1_ms:.4f} + "
          f"torch.unique {k8_unique_ms:.4f} = {k8_k1_ms + k8_unique_ms:.4f} ms; one point repeated: K8 "
          f"{k8_ms['houseelectric, one point repeated']:.4f} ms")
    rows["count_lattice_points"] = dict(max_abs_err=k8_err, ms=k8_ms["houseelectric"],
                                        plain_ms=k8_plain_ms["houseelectric"],
                                        **bound(4 * nh * dh + 4, geometry_ops(nh, dh)), library_ms=None,
                                        unique_ms=k8_unique_ms, geometry_ms=k8_k1_ms,
                                        geometry_unique_ms=k8_k1_ms + k8_unique_ms, ms_after=k8_again_ms,
                                        shape=f"houseelectric x ({nh}, {dh})",
                                        ms_by_dataset=k8_ms, plain_ms_by_dataset=k8_plain_ms)
    record.update(occupancy=occupancy, houseelectric_guard_s=guard_s)

    print("one-shot 5.3: K7 lattice_deriv_grad vs plain (median init, c = 11, 418 stacked columns)")
    with torch.no_grad():
        src = torch.randn((n, 11), generator=gen, device=dev)
        g = torch.randn((n, 11), generator=gen, device=dev)
        dplan = L.build_plan_join(ref, dk.deriv_coeffs, dk.deriv_variance)
        dtaps, scale = list(dk.deriv_coeffs), 2.0 * dk.dk0
        gk = K.lattice_deriv_grad(*dplan, ref, src, g, dtaps, norm, scale)
        gk2 = K.lattice_deriv_grad(*dplan, ref, src, g, dtaps, norm, scale)
        gp = K.deriv_grad_plain(dplan.seg_ids, dplan.weights, dplan.neighbors, ref, src, g, dtaps, norm, scale)
        r7 = rel(gk, gp)
        expect(bool(torch.isfinite(gk).all()) and r7 <= K7_REL, f"K7 vs plain: rel error {r7:.3e} (limit {K7_REL})")
        k7_equal = bool(torch.equal(gk, gp) and torch.equal(gk2, gk))
        expect(k7_equal, f"K7 bit-equal to its plain version and to a second run: {torch.equal(gk, gp)} / "
               f"{torch.equal(gk2, gk)}")
        drows, drows_plain = K.join_rows(*dplan), K.join_rows_plain(*dplan)
        expect(all(torch.equal(a_, b_) for a_, b_ in zip(drows, drows_plain)),
               "the derivative plan's row lists bit-equal to their plain build")
        rows_ms = timer(lambda: K.join_rows(*dplan), 10)
        nl7, C = int(dplan.n_lattice), 2 * 11 * (1 + d)
        rows["lattice_deriv_grad"] = dict(
            # seg, weights, live neighbour rows, ref, src and g in; grad_ref out.
            **bound(4 * (2 * N + (d + 1) * nl7 * 2 * dk.order + 2 * n * d + 2 * n * 11),
                    4 * N * C + 2 * (2 * dk.order + 1) * (d + 1) * nl7 * C + 8 * n * d * 11),
            library_ms=None,
            max_abs_err=float((gk - gp).abs().max()),
            ms=timer(lambda: K.lattice_deriv_grad(*dplan, ref, src, g, dtaps, norm, scale), 10),
            plain_ms=timer(lambda: K.deriv_grad_plain(dplan.seg_ids, dplan.weights, dplan.neighbors, ref, src, g,
                                                      dtaps, norm, scale), 2),
            shape=f"n={n}, d={d}, L=11, C=418, M={N}", bit_equal=k7_equal, join_rows_ms=rows_ms)
        deriv_plan_ms = timer(lambda: L.build_plan_join(ref, dk.deriv_coeffs, dk.deriv_variance), 10)
    st = src.clone().requires_grad_(True)
    lattice_filter(st, ref, dk).backward(g)
    with torch.no_grad():
        k4g = L.filter_once(g, ref, dk.coeffs, dk.variance)
        r_src = rel(st.grad, k4g)
    expect(bool(torch.equal(st.grad, k4g)), f"deriv-mode lattice_filter grad_src bit-equal to K4 of g (rel "
           f"{r_src:.3e})")
    print(f"    K7 {rows['lattice_deriv_grad']['ms']:.4f} ms (its row lists' build in it, join_rows: {rows_ms:.4f}), plain "
          f"{rows['lattice_deriv_grad']['plain_ms']:.4f} ms; deriv plan (K1 + K2) {deriv_plan_ms:.4f} ms; bit-equal "
          f"to plain and repeatable: {k7_equal}")
    record.update(k7_rel=r7, k7_bit_equal=k7_equal, grad_src_rel=r_src, deriv_plan_ms=deriv_plan_ms,
                  deriv_join_rows_ms=rows_ms)

    print("one-shot 5.4: grad_mode=deriv_filter: NLML and raw gradients vs JAX on the CPU, three Adam steps")
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
            a_ = getattr(model, k).grad.detach().cpu().numpy().astype(np.float64).ravel()
            b_ = golden[f"grad_{tag}_{k}"].astype(np.float64).ravel()
            c_, r_ = cosine(a_, b_), float(np.linalg.norm(a_ - b_) / np.linalg.norm(b_))
            expect(c_ >= GRAD_COS and r_ <= GRAD_REL,
                   f"{tag}: d/d{k} cos {c_:.6f} (limit {GRAD_COS}), rel {r_:.2e} (limit {GRAD_REL})")
            record[f"deriv_{tag}_grad_rel_{k}"] = r_
        record[f"deriv_{tag}_nlml_diff"] = dl
        first = {k: getattr(model, k).grad.detach().clone() for k in RAW_NAMES}
        model.zero_grad(set_to_none=True)
        loss2 = model.nlml(x, y, probes=probes(golden[f"seed_{tag}"]))
        loss2.backward()
        same = bool(torch.equal(loss2.detach(), loss.detach())) and all(
            torch.equal(getattr(model, k).grad, first[k]) for k in RAW_NAMES)
        expect(same, f"{tag}: a second deriv-mode NLML and its raw gradients bit-equal to the first")
        record[f"deriv_{tag}_repeat_bit_equal"] = same
    model.load_raw(point("init"))
    steps = iter([probes(golden["seed_adam"] + e) for e in range(3)])
    path = (K.lattice_geometry, K.lattice_dedup_neighbors, *chain_kernels(), K.lattice_filter_once,
            K.join_rows, K.lattice_deriv_grad)
    for fn in (*path, K.lattice_apply):
        fn.launches = 0
    hist = simplex_gp_torch.fit_adam(lambda _gen: model.nlml(x, y, probes=next(steps)), model.parameters(),
                                     epochs=3, lr=0.1)
    deriv_launches = {fn.__name__: fn.launches for fn in path}
    print(f"    launches on the deriv-mode Adam steps: {deriv_launches}; K3: {K.lattice_apply.launches}")
    expect(all(v > 0 for v in deriv_launches.values()) and K.lattice_apply.launches == 0,
           f"every kernel of the deriv-mode step launched, K3 never ({K.lattice_apply.launches})")
    dl = float(np.abs(np.array(hist["loss"]) - golden["adam_loss"]).max())
    expect(dl <= ADAM_LOSS_ATOL, f"Adam losses {hist['loss']} vs JAX {golden['adam_loss'].tolist()} "
           f"(max |diff| {dl:.2e}, limit {ADAM_LOSS_ATOL})")
    dp = max(float(np.abs(getattr(model, k).detach().cpu().numpy() - golden[f"adam_{k}"][-1]).max())
             for k in RAW_NAMES)
    expect(dp <= ADAM_PARAM_ATOL, f"raw parameters after 3 steps: max |diff| {dp:.2e} (limit {ADAM_PARAM_ATOL})")
    record.update(deriv_adam_loss_diff=dl, deriv_adam_param_diff=dp, deriv_adam_step_ms=hist["step_ms"],
                  deriv_launches=deriv_launches)

    model.load_raw(point("init"))
    opt = torch.optim.Adam(model.parameters(), lr=0.1)
    z = probes(golden["seed_init"])
    train_step(model, opt, x, y, z)  # warm-up
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    model.load_raw(point("init"))
    ev[0].record()
    opt.zero_grad(set_to_none=True)
    loss = model.nlml(x, y, probes=z)
    ev[1].record()
    loss.backward()
    ev[2].record()
    opt.step()
    ev[3].record()
    torch.cuda.synchronize()
    stages = {nm: ev[i].elapsed_time(ev[i + 1]) for i, nm in enumerate(("forward", "backward", "adam"))}
    stages.update(k4_c11=k4_ms[11], deriv_plan=deriv_plan_ms, k7=rows["lattice_deriv_grad"]["ms"])
    warm = timer(lambda: train_step(model, opt, x, y, z), 5)
    print(f"    warm deriv-mode training step {warm:.2f} ms (CUDA events); stages (ms; the backward runs "
          f"K4 at c = 11, the deriv plan and K7): " + json.dumps({k: round(v, 3) for k, v in stages.items()}))
    record.update(deriv_step_ms=warm, deriv_stages=stages)

    print("one-shot 5.5: python -m simplex_gp_torch.mvm_err, rbf order 1, full n")
    for fn in (K.lattice_filter_once, K.lattice_count):
        fn.launches = 0
    mvm = {name: mvm_err.main(["--dataset", name, "--order", "1", "--device", dev.type]) for name in sets}
    mvm_launches = {fn.__name__: fn.launches for fn in (K.lattice_filter_once, K.lattice_count)}
    print(f"    launches on the mvm_err runs: {mvm_launches}")
    expect(all(v > 0 for v in mvm_launches.values()), "K4 and K8 launched on the mvm_err runs")
    e = mvm["elevators"]
    for key in ("rel_err", "cos_err"):
        diff = abs(e[key] - float(golden[f"mvm_{key}"]))
        expect(diff <= MVM_ERR_ATOL, f"elevators {key} {e[key]:.6f} vs JAX {float(golden[f'mvm_{key}']):.6f} "
               f"(|diff| {diff:.2e}, limit {MVM_ERR_ATOL})")
    with torch.no_grad():
        # K4 against its plain version at the shapes and capacities mvm_err gave it.
        for name, (xa, ya) in sets.items():
            da = xa.shape[1]
            Ea, aa, oh1a, oh2a = L._lattice_constants(da, rbf.coeffs, rbf.variance, dev)
            cap = mvm_err.trim_capacity(xa, rbf)
            cap = xa.shape[0] * (da + 1) if cap is None else cap
            args = (xa, Ea, aa, oh1a, oh2a, ya, list(rbf.coeffs), L.SLICE_NORM(da), cap)
            kout, knl = K.lattice_filter_once(*args)
            pout, pnl = K.filter_once_plain(*args)
            r = rel(kout, pout)
            expect(int(knl) == int(pnl) and bool(torch.isfinite(kout).all()) and bool(torch.equal(kout, pout)),
                   f"{name}: K4 vs plain at capacity {cap}: occupancy {int(knl)} vs {int(pnl)}, bit-equal "
                   f"{torch.equal(kout, pout)} (rel {r:.3e}), finite")
            record[f"{name}_k4_rel"] = r
            del kout, pout
        for name in ("precipitation", "houseelectric"):
            xa, ya = sets[name]
            cap = mvm_err.trim_capacity(xa, rbf)
            full = L.filter_once(ya, xa, rbf.coeffs, rbf.variance)
            trimmed = L.filter_once(ya, xa, rbf.coeffs, rbf.variance, cap)
            r = rel(trimmed, full)
            expect(cap is not None and bool(torch.isfinite(full).all() and torch.isfinite(trimmed).all())
                   and r <= K3_REL, f"{name}: capacity {cap} of {xa.shape[0] * (xa.shape[1] + 1)}, trimmed vs "
                   f"untrimmed rel {r:.3e} (limit {K3_REL}), both finite")
            record[f"{name}_capacity"] = cap
    for name, m in mvm.items():
        print(f"    {name}: n={m['n']} d={m['d']} ts/lattice {m['ts/lattice']:.6f} s (the reference, real data, its "
              f"unnamed GPU: {REFERENCE_ONESHOT_S[name]} s), rel_err {m['rel_err']:.4f}, cos_err {m['cos_err']:.4f}, "
              f"ts/exact_subset {m['ts/exact_subset']:.6f} s on {m['exact_subset_n']} rows")
    record.update(mvm_err=mvm)
    launches = dict(filter_once=mvm_launches["lattice_filter_once"], count_lattice_points=mvm_launches["lattice_count"],
                    lattice_deriv_grad=deriv_launches["lattice_deriv_grad"])
    return rows, launches, record


def large_n_phase(dev, expect, timer):
    """Phase 6: the houseelectric path: K9, the bounded K2 and its guard, the trainer.

    Returns (kernel rows, launches on the trainer run, the record).
    """
    import tempfile

    import torch

    import simplex_gp_torch
    from simplex_gp_torch import train as trainer
    from simplex_gp_torch.kernels import chain as KC
    from simplex_gp_torch.kernels import lattice as K
    from simplex_gp_torch.kernels.pivot import pivot_column
    from simplex_gp_torch.linalg import mll
    from simplex_gp_torch.ops import filter as F
    from simplex_gp_torch.ops import lattice as L
    from simplex_gp_torch.utils import data

    golden = np.load(HOUSE_GOLDEN)
    ds = data.load_dataset("houseelectric")
    cut = int(golden["max_n"])
    dk = simplex_gp_torch.SimplexGP(num_dims=11, kernel="matern", nu=1.5, order=1).dk
    n, d = ds.train_x.shape
    taps, norm, order, chunk = list(dk.coeffs), L.SLICE_NORM(d), dk.order, L.k9_window(F._WIDE_CHUNK)
    E, a, oh1, oh2 = L._lattice_constants(d, dk.coeffs, dk.variance, dev)
    rows, record = {}, {}
    ell = {tag: trainer.median_lengthscale(x) for tag, x in (("full", ds.train_x), ("cut", ds.train_x[:cut]))}
    for tag in ell:
        expect(np.float32(ell[tag]) == golden[f"{tag}_ls_init"],
               f"{tag}: median-init lengthscale {ell[tag]:.6f} vs JAX {float(golden[f'{tag}_ls_init']):.6f}")

    def positions(x_np, tag):  # the training positions at the median init, as the autotrim sees them
        return (torch.from_numpy(x_np).to(dev) / ell[tag]).contiguous()

    def plain_plan(pts, cap):
        h1, h2, w = K.geometry_plain(pts, E, a)
        seg, nb, nl = K.dedup_neighbors_plain(h1, h2, oh1, oh2, cap)
        return L.LatticePlan(seg.reshape(-1, d + 1), w, nb, nl)

    gen = torch.Generator(device=dev).manual_seed(6)
    print("large n 6.1: K9 lattice_apply_cols vs plain (houseelectric --max-n 360,000, median init)")
    xc = positions(ds.train_x[:cut], "cut")
    cap_cut = int(golden["cut_capacity"])
    k9_err = 0.0
    with torch.no_grad():
        cases = (("train, trimmed", xc, 100, cap_cut),
                 ("[train; 4,096 val], untrimmed", torch.cat([xc, positions(ds.val_x[:4096], "cut")]), 101, None))
        for name, pts, c, cap in cases:
            expect(pts.shape[0] * (d + 1) > F._JOIN_MAX_ROWS, f"{name}: {pts.shape[0] * (d + 1)} contribution rows, "
                   f"above the chunking threshold {F._JOIN_MAX_ROWS}")
            v = torch.randn((pts.shape[0], c), generator=gen, device=dev)
            kplan, pplan = L.build_plan_join(pts, dk.coeffs, dk.variance, cap), plain_plan(pts, cap)
            kout = K.lattice_apply_cols(*kplan, v, taps, norm, chunk)
            same = K.apply_cols_plain(*kplan, v, taps, norm, chunk)
            route = K.apply_cols_plain(*pplan, v, taps, norm, chunk)
            r_same, r_route = rel(kout, same), rel(kout, route)
            k9_err = max(k9_err, float((kout - same).abs().max()))
            expect(int(kplan.n_lattice) == int(pplan.n_lattice) and max(r_same, r_route) <= LARGE_N_REL,
                   f"{name}, c={c}: n_lattice kernel {int(kplan.n_lattice)} plain {int(pplan.n_lattice)}; rel "
                   f"{r_same:.3e} on the same plan, {r_route:.3e} against the all-plain route (limit {LARGE_N_REL})")
            expect(bool(torch.equal(kout, same)), f"{name}, c={c}: K9 bit-equal to its plain version on its plan")
            record[f"k9_rel_{c}"] = r_route
            del kplan, pplan, kout, same, route

    print("large n 6.2: K9 vs the unchunked K3, c = 100 over all 1,311,539 training rows (untrimmed plan)")
    xf = positions(ds.train_x, "full")
    with torch.no_grad():
        plan_u = L.build_plan_join(xf, dk.coeffs, dk.variance)
        nl_u = int(plan_u.n_lattice)
        v100 = torch.randn((n, 100), generator=gen, device=dev)

        def peak_gb(fn):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            out = fn()
            torch.cuda.synchronize()
            return out, (torch.cuda.max_memory_allocated() - base) / 1e9

        rows_u = K.join_rows(*plan_u)
        rows_err = max(float((a_.double() - b_.double()).abs().max()) if a_.numel() else 0.0
                       for a_, b_ in zip(rows_u, K.join_rows_plain(*plan_u)))
        expect(rows_err == 0, f"the untrimmed plan's row lists bit-equal to their plain build (max |diff| {rows_err})")
        join_rows_ms = timer(lambda: K.join_rows(*plan_u), 5)
        join_rows_plain_ms = timer(lambda: K.join_rows_plain(*plan_u), 1)
        sort_ms = timer(lambda: torch.sort(plan_u.seg_ids.reshape(-1), stable=True), 5)
        k9_out, k9_gb = peak_gb(lambda: K.lattice_apply_cols(*plan_u, v100, taps, norm, chunk, rows_u))
        k9_again = K.lattice_apply_cols(*plan_u, v100, taps, norm, chunk)
        k9_plain = K.apply_cols_plain(*plan_u, v100, taps, norm, chunk, rows_u)
        k9_equal = bool(torch.equal(k9_out, k9_plain) and torch.equal(k9_again, k9_out))
        expect(k9_equal, f"K9 bit-equal to its plain version and to a second run: {torch.equal(k9_out, k9_plain)} / "
               f"{torch.equal(k9_again, k9_out)}")
        k9_err = max(k9_err, float((k9_out - k9_plain).abs().max()))
        del k9_again, k9_plain
        k3_out, k3_gb = peak_gb(lambda: K.lattice_apply(*plan_u, v100, taps, norm))
        r93 = rel(k9_out, k3_out)
        expect(r93 <= LARGE_N_REL, f"K9 vs K3: rel {r93:.3e} (limit {LARGE_N_REL})")
        del k3_out
        # As the predict calls it (its row lists built inside), and given them, as the range sketch's two MVMs.
        k9_ms = timer(lambda: K.lattice_apply_cols(*plan_u, v100, taps, norm, chunk), 3)
        k9_given_ms = timer(lambda: K.lattice_apply_cols(*plan_u, v100, taps, norm, chunk, rows_u), 3)
        k9_graph_ms = graph_ms(lambda: K.lattice_apply_cols(*plan_u, v100, taps, norm, chunk, rows_u), 2)
        k3_ms = timer(lambda: K.lattice_apply(*plan_u, v100, taps, norm), 3)
        k9_plain_ms = timer(lambda: K.apply_cols_plain(*plan_u, v100, taps, norm, chunk, rows_u), 1)
        # The same points and n_lattice on a plan of M = occupancy rows in place of n(d+1).
        occ_fit = int(K.lattice_count(xf, E, a))
        plan_fit = L.build_plan_join(xf, dk.coeffs, dk.variance, occ_fit)
        rows_fit = K.join_rows(*plan_fit)
        k9_fit_ms = timer(lambda: K.lattice_apply_cols(*plan_fit, v100, taps, norm, chunk, rows_fit), 3)
        del plan_fit, rows_fit
        print(f"    n_lattice {nl_u} of {n * (d + 1)}, window {chunk} columns: K9 {k9_ms:.3f} ms with its row lists "
              f"built inside (join_rows {join_rows_ms:.3f} ms, its stable sort {sort_ms:.3f}; plain "
              f"{join_rows_plain_ms:.3f}), {k9_given_ms:.3f} ms given them, {k9_graph_ms:.3f} ms by CUDA-graph replay; "
              f"on the plan of capacity = occupancy {k9_fit_ms:.3f} ms (untrimmed / occupancy-sized "
              f"{k9_given_ms / k9_fit_ms:.2f}); peak {k9_gb:.3f} GB; unchunked K3 {k3_ms:.3f} ms, peak {k3_gb:.3f} "
              f"GB; K9 plain {k9_plain_ms:.3f} ms (CUDA events); bit-equal to plain and repeatable: {k9_equal}")
        record.update(k9_k3_rel=r93, k9_ms=k9_ms, k9_given_rows_ms=k9_given_ms, k9_graph_ms=k9_graph_ms,
                      k9_peak_gb=k9_gb, k9_window=chunk, k9_bit_equal=k9_equal, k3_c100_ms=k3_ms,
                      k3_c100_peak_gb=k3_gb, houseelectric_untrimmed_n_lattice=nl_u, join_rows_ms=join_rows_ms,
                      k9_capacity_occupancy_ms=k9_fit_ms)

    print("large n 6.3: K8 count, autotrim, the bounded K2 and its guard (all training rows, median init)")
    with torch.no_grad():
        occ, occ_plain = int(K.lattice_count(xf, E, a)), int(K.count_plain(xf, E, a))
        occ_jax = int(golden["full_occupancy"])
        cap = trainer.trim_capacity(occ, n, d)
        expect(occ == occ_plain and abs(occ - occ_jax) <= OCC_REL * occ_jax and cap == int(golden["full_capacity"]),
               f"occupancy {occ} (plain {occ_plain}, JAX {occ_jax}, limit {OCC_REL} relative), autotrimmed capacity "
               f"{cap} (JAX {int(golden['full_capacity'])})")
        h1, h2, w = K.lattice_geometry(xf, E, a)
        v11 = torch.randn((n, 11), generator=gen, device=dev)
        full = K.lattice_apply(*plan_u, v11, taps, norm)
        spread = rel(K.lattice_apply(*plan_u, v11, taps, norm), full)
        seg, nb, nl = K.lattice_dedup_neighbors(h1, h2, oh1, oh2, occ)
        fit = K.lattice_apply(seg.reshape(n, d + 1), w, nb, nl, v11, taps, norm)
        r_fit = rel(fit, full)
        expect(int(nl) == occ and tuple(nb.shape) == (d + 1, occ, 2 * order) and r_fit <= LARGE_N_REL,
               f"capacity = occupancy: n_lattice {int(nl)}, neighbours {tuple(nb.shape)}, rel {r_fit:.3e} against "
               f"the untrimmed plan (limit {LARGE_N_REL}; two runs of the untrimmed K3 differ by {spread:.3e})")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seg, nb, nl = K.lattice_dedup_neighbors(h1, h2, oh1, oh2, occ - 1)
        seg = seg.reshape(n, d + 1)
        under, table = K.lattice_apply(seg, w, nb, nl, v11, taps, norm, return_table=True)
        under9 = K.lattice_apply_cols(seg, w, nb, nl, v100, taps, norm, chunk)
        grad = K.lattice_filter_grad(xf, E, seg, v11, v11, table, table, norm)
        torch.cuda.synchronize()
        guard_s = time.perf_counter() - t0
        expect(int(nl) > occ - 1 and bool(torch.isnan(under).all() and torch.isnan(under9).all())
               and grad.shape == (n, d),
               f"capacity = occupancy - 1: bounded K2, K3, K9 and K5 in {guard_s:.3f} s (host clock, no hang, no "
               f"fault); K3 and K9 all NaN; count {int(nl)}")
        del under, under9, table, grad, fit
        bounded_ms = timer(lambda: K.lattice_dedup_neighbors(h1, h2, oh1, oh2, cap), 5)
        unbounded_ms = timer(lambda: K.lattice_dedup_neighbors(h1, h2, oh1, oh2), 5)
        bounded_plain_ms = timer(lambda: K.dedup_neighbors_plain(h1, h2, oh1, oh2, cap), 2)
        print(f"    K2 bounded (capacity {cap}) {bounded_ms:.3f} ms, unbounded {unbounded_ms:.3f} ms, bounded plain "
              f"{bounded_plain_ms:.3f} ms; guard run {guard_s:.3f} s")
        # A join plan at the autotrimmed capacity (the backward's before it reused the CG's chain plan): its
        # row lists (M = cap) and the one-call wide plan.
        tseg, tnb, tnl = K.lattice_dedup_neighbors(h1, h2, oh1, oh2, cap)
        tplan = L.LatticePlan(tseg.reshape(n, d + 1), w, tnb, tnl)
        trows, trows_plain = K.join_rows(*tplan), K.join_rows_plain(*tplan)
        trim_equal = all(torch.equal(a_, b_) for a_, b_ in zip(trows, trows_plain))
        expect(int(tplan.n_lattice) == occ and trim_equal, f"capacity {cap}: n_lattice {int(tplan.n_lattice)} "
               f"(occupancy {occ}); the row lists bit-equal to their plain build: {trim_equal}")
        trim_rows_ms = timer(lambda: K.join_rows(*tplan), 5)
        trim_rows_plain_ms = timer(lambda: K.join_rows_plain(*tplan), 1)
        before = (K.lattice_dedup_neighbors.bounded_launches, K.join_rows.launches)
        oseg, onb, onl, orows = K.lattice_plan_rows(h1, h2, w, oh1, oh2, cap)
        counted = (K.lattice_dedup_neighbors.bounded_launches - before[0], K.join_rows.launches - before[1])
        orows_plain = K.join_rows_plain(oseg, w, onb, onl)
        one_equal = all(torch.equal(a_, b_) for a_, b_ in zip(orows, orows_plain))
        r_one = rel(K.lattice_apply_cols(oseg, w, onb, onl, v11, taps, norm, 11, orows), full)
        expect(int(onl) == occ and one_equal and r_one <= LARGE_N_REL and counted == (1, 1),
               f"one-call wide plan (lattice_plan_rows) at capacity {cap}: n_lattice {int(onl)}, row lists bit-equal "
               f"to their plain build of its plan: {one_equal}; K9 on it rel {r_one:.3e} against the untrimmed K3 "
               f"(limit {LARGE_N_REL}); counted as one bounded K2 and one row build: {counted}")
        one_ms = timer(lambda: K.lattice_plan_rows(h1, h2, w, oh1, oh2, cap), 5)
        two_ms = timer(lambda: _k2_then_rows(K, L, h1, h2, w, oh1, oh2, cap, n, d), 5)
        print(f"    capacity {cap}: join_rows {trim_rows_ms:.3f} ms (plain {trim_rows_plain_ms:.3f}); one-call wide "
              f"plan {one_ms:.3f} ms against K2 + join_rows {two_ms:.3f} ms (CUDA events)")
        del tseg, tnb, tplan, trows, trows_plain, oseg, onb, orows, orows_plain
        hc1, hc2, wc = K.lattice_geometry(xc, E, a)
        kseg, knb, knl = K.lattice_dedup_neighbors(hc1, hc2, oh1, oh2, cap_cut)
        pseg, pnb, pnl = K.dedup_neighbors_plain(hc1, hc2, oh1, oh2, cap_cut)
        vc = torch.randn((xc.shape[0], 11), generator=gen, device=dev)
        r_b = rel(K.lattice_apply(kseg.reshape(-1, d + 1), wc, knb, knl, vc, taps, norm),
                  K.apply_plain(pseg.reshape(-1, d + 1), wc, pnb, vc, taps, norm, n_lattice=pnl))
        k2b_err = abs(int(knl) - int(pnl))
        expect(int(knl) == int(pnl) == int(golden["cut_occupancy"]) and r_b <= LARGE_N_REL,
               f"bounded K2 vs plain at n={cut}, capacity {cap_cut}: n_lattice {int(knl)} / {int(pnl)} (JAX "
               f"{int(golden['cut_occupancy'])}); K3 on each, rel {r_b:.3e} (limit {LARGE_N_REL})")
        del hc1, hc2, wc, kseg, knb, pseg, pnb
    rows["lattice_dedup_neighbors_bounded"] = dict(
        max_abs_err=k2b_err, ms=bounded_ms, plain_ms=bounded_plain_ms,
        **bound(dedup_bytes(n * (d + 1), cap, d + 1, order), 0), library_ms=None,
        shape=f"houseelectric N={n * (d + 1)} hash pairs, capacity {cap}", unbounded_ms=unbounded_ms,
        one_call_wide_plan_ms=one_ms, k2_then_join_rows_ms=two_ms,
        one_call_bound_ms=bound(dedup_bytes(n * (d + 1), cap, d + 1, order) + rows_bytes(n * (d + 1), cap), 0)[
            "bound_ms"])
    record.update(join_rows_trimmed_ms=trim_rows_ms, join_rows_trimmed_plain_ms=trim_rows_plain_ms,
                  one_call_wide_plan_ms=one_ms, k2_then_join_rows_ms=two_ms)
    record.update(occupancy=occ, occupancy_jax=occ_jax, capacity=cap, trim_rel=r_fit, k3_repeat_rel=spread,
                  guard_s=guard_s, bounded_k2_rel=r_b)

    print(f"    NLML and raw gradients at n={cut}, capacity {cap_cut}, vs JAX on the CPU (same probes)")
    xcut, ycut = torch.from_numpy(ds.train_x[:cut]).to(dev), torch.from_numpy(ds.train_y[:cut]).to(dev)
    z = torch.from_numpy(np.random.default_rng(int(golden["seed"])).choice([-1.0, 1.0], size=(xcut.shape[0], 10))
                         .astype(np.float32)).to(dev)
    # "init": the training CG at tolerance 1.0, whose stop after 10, 11 or 12 iterations turns on f32
    # noise at the tolerance (K3's atomic order): the NLML is held, the gradients printed.  "fixed":
    # exactly JAX's iteration count on both sides, NLML and gradients held.  At this point the
    # outputscale and lengthscale gradients nearly cancel (|d/draw_outputscale| ~5e-4 against
    # |d/draw_noise| ~0.30), so each group's error is taken relative to the whole raw gradient's
    # norm; against their own norms the port on the CPU (plain versions, deterministic) is 0.117
    # (outputscale) and 0.037 (lengthscales) from JAX, the chain-vs-join operator difference
    # amplified by the cancellation, with or without the capacity.
    for tag, tol, iters in (("init", 1.0, 500), ("fixed", 0.0, int(golden["cg_iters_fixed"]))):
        cfg = mll.BBMMConfig(cg_tolerance=tol, max_cg_iterations=iters, max_lanczos_iterations=100,
                             precond_rank=100, num_probes=10, plan_capacity=cap_cut)
        model = simplex_gp_torch.SimplexGP(num_dims=d, kernel="matern", nu=1.5, order=1, min_noise=0.1, bbmm=cfg,
                                           device=dev)
        model.load_raw({k: golden[f"init_{k}"] for k in RAW_NAMES})
        stats = {}
        loss = model.nlml(xcut, ycut, probes=z, stats=stats)
        loss.backward()
        dl = abs(float(loss.detach()) - float(golden[f"loss_{tag}"]))
        jax_iters = int(golden[f"cg_iters_{tag}"])
        expect(dl <= NLML_ATOL and (tag == "init" or stats["cg_iters"] == jax_iters),
               f"{tag}: NLML {float(loss.detach()):.6f} vs JAX {float(golden[f'loss_{tag}']):.6f} (|diff| {dl:.2e}, "
               f"limit {NLML_ATOL}); CG iterations {stats['cg_iters']} (JAX {jax_iters})")
        ga = {k: getattr(model, k).grad.detach().cpu().numpy().astype(np.float64).ravel() for k in RAW_NAMES}
        gb = {k: golden[f"grad_{tag}_{k}"].astype(np.float64).ravel() for k in RAW_NAMES}
        whole_a, whole_b = (np.concatenate([g_[k] for k in RAW_NAMES]) for g_ in (ga, gb))
        scale = np.linalg.norm(whole_b)
        c_ = cosine(whole_a, whole_b)
        worst = max(float(np.linalg.norm(ga[k] - gb[k]) / scale) for k in RAW_NAMES)
        own = {k: float(np.linalg.norm(ga[k] - gb[k]) / np.linalg.norm(gb[k])) for k in RAW_NAMES}
        what = (f"{tag}: raw gradient cos {c_:.6f} (limit {GRAD_COS}); worst group error {worst:.2e} of the whole "
                f"gradient's norm (limit {GRAD_REL}); each group against its own norm: "
                + ", ".join(f"{k} {v:.2e}" for k, v in own.items()))
        if tag == "fixed":
            expect(c_ >= GRAD_COS and worst <= GRAD_REL, what)
        else:
            print(f"    {what}")
        record.update({f"cut_{tag}_grad_rel_{k}": v for k, v in own.items()})
        record[f"cut_{tag}_grad_worst_of_whole"] = worst
        record.update({f"cut_{tag}_nlml_diff": dl, f"cut_{tag}_cg_iters": stats["cg_iters"]})
    steps = len(golden["adam_loss"])
    print(f"    {steps} Adam steps at n={cut} (fit_adam, lr 0.1, CG tolerance 1.0) vs the JAX trajectory (same probes)")
    model.bbmm = mll.BBMMConfig(cg_tolerance=1.0, max_cg_iterations=500, max_lanczos_iterations=100,
                                precond_rank=100, num_probes=10, plan_capacity=cap_cut)
    model.load_raw({k: golden[f"init_{k}"] for k in RAW_NAMES})
    zs = iter([torch.from_numpy(np.random.default_rng(int(golden["seed"]) + 1 + e).choice(
        [-1.0, 1.0], size=(xcut.shape[0], 10)).astype(np.float32)).to(dev) for e in range(steps)])
    traj, iters, st = [], [], {}

    def after_step(*_):
        traj.append({k: getattr(model, k).detach().cpu().numpy() for k in RAW_NAMES})
        iters.append(st["cg_iters"])

    hist = simplex_gp_torch.fit_adam(lambda _gen: model.nlml(xcut, ycut, probes=next(zs), stats=st),
                                     model.parameters(), epochs=steps, lr=0.1, callback=after_step)
    # Adam's first step moves each raw parameter by lr times the sign of its gradient, so it matches
    # JAX's while every sign does; the loss of step 1 is then the NLML at the same point.  Later steps
    # are printed, not held: the lengthscale gradients here are ~1e-4 against 0.3 for the noise and
    # carry ~2e-2 of their own norm in f32 noise (the per-group errors above), which Adam turns into
    # moves of up to lr once a gradient nears zero, so two correct runs part (PERF.md section 6, PR 4).
    losses = np.array(hist["loss"])
    dl2 = float(np.abs(losses[:2] - golden["adam_loss"][:2]).max())
    dp1 = max(float(np.abs(traj[0][k] - golden[f"adam_{k}"][0]).max()) for k in RAW_NAMES)
    expect(dl2 <= ADAM_LOSS_ATOL and dp1 <= ADAM_PARAM_ATOL,
           f"first Adam step: raw parameters max |diff| {dp1:.2e} (limit {ADAM_PARAM_ATOL}); losses of steps 0-1 "
           f"max |diff| {dl2:.2e} (limit {ADAM_LOSS_ATOL})")
    jl = golden["adam_raw_lengthscale"]
    pl = np.stack([t["raw_lengthscale"] for t in traj])
    moves = np.sign(np.diff(np.concatenate([golden["init_raw_lengthscale"][None], pl]), axis=0))
    jmoves = np.sign(np.diff(np.concatenate([golden["init_raw_lengthscale"][None], jl]), axis=0))
    agree = int((moves == jmoves).sum())
    dp = np.abs(pl - jl).max(axis=1)
    print(f"    losses {np.round(losses, 6).tolist()} (JAX {np.round(golden['adam_loss'], 6).tolist()}), CG "
          f"iterations {iters}; raw lengthscales max |diff| per step {np.round(dp, 4).tolist()}; the sign of "
          f"each step's move agrees with JAX's in {agree} of {moves.size}")
    record.update(adam_losses=losses.tolist(), adam_cg_iters=iters, adam_first_step_param_diff=dp1,
                  adam_lengthscale_diff_per_step=dp.tolist(), adam_move_signs_agree=agree,
                  adam_move_signs=int(moves.size))
    del model, loss, plan_u, rows_u, v100, k9_out, h1, h2, w, seg, nb

    print("large n 6.4: python -m simplex_gp_torch.train at houseelectric, the round-5 flags, two epochs")
    # The exact backward reuses the CG's chain plan (K3'c transposed); the eval's range sketch and predicts
    # apply the chunked chain (above _JOIN_MAX_ROWS), so K2, the join rows, K9 and K3 are off this path.
    path = (K.lattice_geometry, pivot_column, K.lattice_filter_grad, K.lattice_count, *chain_kernels(),
            KC.chain_axes_transpose)
    off_path = (K.lattice_dedup_neighbors, K.join_rows, K.lattice_apply_cols, K.lattice_apply)
    predictions = []
    real_predict = simplex_gp_torch.SimplexGP.predict_from_cache

    def recording_predict(self, cache, x, x_test):
        mean, var = real_predict(self, cache, x, x_test)
        predictions.append(dict(rows=x_test.shape[0], shape_ok=mean.shape == var.shape == (x_test.shape[0],),
                                finite=bool(torch.isfinite(mean).all() and torch.isfinite(var).all()),
                                positive=bool((var > 0).all())))
        return mean, var

    for fn in (*path, *off_path):
        fn.launches = 0
    K.lattice_dedup_neighbors.bounded_launches = 0
    simplex_gp_torch.SimplexGP.predict_from_cache = recording_predict
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            summary = trainer.main([*HOUSE_FLAGS, "--epochs", "2", "--log-int", "2", "--out", tmp,
                                    "--device", dev.type])
            lines = [json.loads(line) for line in
                     (pathlib.Path(summary["out_dir"]) / "metrics.jsonl").read_text().splitlines()]
    finally:
        simplex_gp_torch.SimplexGP.predict_from_cache = real_predict
    wall_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in path}
    off = {fn.__name__: fn.launches for fn in off_path}
    off["lattice_dedup_neighbors_bounded"] = K.lattice_dedup_neighbors.bounded_launches
    print(f"    launches on the trainer run: {launches}; off the path: {off}")
    expect(all(v > 0 for v in launches.values()), "every kernel of the path launched on the trainer run")
    expect(launches["chain_axes_transpose"] == 2, f"K3'c transposed {launches['chain_axes_transpose']} times: "
           f"one a training step")
    expect(not any(off.values()), f"no K2, join rows, K9 or atomic K3 on the trainer run: {off} (the val eval's "
           f"two sketch MVMs, its rect predict and the test predict run the chunked chain above _JOIN_MAX_ROWS)")
    launches.update(off)
    recs = summary["records"]
    expect(all(np.isfinite(r["train/mll"]) for r in recs), f"finite losses {[r['train/mll'] for r in recs]}")
    expect(summary["plan_capacity"] == cap, f"the trainer's capacity {summary['plan_capacity']} (phase 6.3: {cap})")
    sizes = [ds.val_x.shape[0], ds.test_x.shape[0]]
    expect([p_["rows"] for p_ in predictions] == sizes and all(p_["shape_ok"] and p_["finite"] and p_["positive"]
                                                               for p_ in predictions),
           f"val and test predictions: {predictions} (one finite mean and positive variance per row of {sizes})")
    final = summary["final"]
    val_rmse = recs[-1].get("val/rmse", float("nan"))
    expect(val_rmse < ENTRY_RMSE_MAX and final.get("test/rmse", float("nan")) < ENTRY_RMSE_MAX,
           f"val RMSE {val_rmse:.4f}, test RMSE {final.get('test/rmse', float('nan')):.4f} (limit {ENTRY_RMSE_MAX}), "
           f"test NLL {final.get('test/nll', float('nan')):.4f}")
    epoch_lines = [r for r in lines if "epoch" in r]
    keys_ok = (sorted(lines[0]) == ["config", "model"] and set(epoch_lines[0]) == EPOCH_KEYS
               and set(epoch_lines[-1]) == EPOCH_KEYS | VAL_KEYS and set(lines[-1]) == TEST_KEYS)
    expect(keys_ok, f"metrics.jsonl keys: {[sorted(r) for r in lines]}")
    step_ms = [1e3 * r["train/loss_ts"] for r in recs]
    print(f"    steps {[round(t, 1) for t in step_ms]} ms (host clock, synchronised); val eval "
          f"{recs[-1]['val/pred_ts']:.3f} s with {recs[-1]['val/cg_iters']} eval CG iterations; test predict "
          f"{final['test/pred_ts']:.3f} s; outputscale {recs[-1]['hyp/outputscale']:.4f}, lengthscales "
          f"{recs[-1]['hyp/ell_min']:.3f}..{recs[-1]['hyp/ell_max']:.3f}; phase wall time {wall_s:.1f} s")
    record.update(trainer=summary, trainer_wall_s=wall_s, trainer_launches=launches)

    print("large n 6.5: one warm training step and one eval at houseelectric, stage by stage (CUDA events)")
    record["k5"] = k5_houseelectric(dev, ds, dk, cap, ell["full"], expect, timer)
    stages, evals, peaks, routes = houseelectric_stages(dev, ds, dk, cap, ell["full"])
    with torch.no_grad():
        record["eval_routes"] = wide_routes_check(*routes, dk, torch.from_numpy(ds.val_y).to(dev), expect,
                                                  "houseelectric eval")
    del routes
    record["slq"] = stages.pop("slq_case")
    slq_gate(record["slq"], expect, "houseelectric training CG record")
    prof = stages.pop("backward_profile")
    expect(prof["sorts"] == 0 and prof["cumsums"] == 0 and not any(prof["kernels"].values())
           and all(v > 0 for v in prof["chain_kernels"].values()),
           f"the step's backward under torch.profiler: torch.sort {prof['sorts']} times, torch.cumsum "
           f"{prof['cumsums']} times (expected 0); the join plan's kernels {prof['kernels']} (expected none: the "
           f"backward reuses the CG's chain plan); the chain backward's kernels {prof['chain_kernels']}")
    record["backward_profile"] = prof
    r3 = lambda v: round(v, 3) if isinstance(v, float) else v
    print("    training step (ms): " + json.dumps({k: r3(v) for k, v in stages.items()}))
    print("    eval (ms): " + json.dumps({k: r3(v) for k, v in evals.items() if k != "eval_raw_params"}))
    print(f"    eval CG: {evals['eval_cg_iters']} iterations, best residual {evals['eval_cg_res']!r} (tolerance "
          f"0.01), stopped by the {evals['eval_cg_stop']}; raw parameters {json.dumps(evals['eval_raw_params'])}")
    print(f"    peak device memory (GB): {json.dumps({k: round(v, 3) for k, v in peaks.items()})}")
    record.update(step_stages=stages, eval_stages=evals, peak_gb=peaks, houseelectric_n=n)

    rows["lattice_apply_cols"] = dict(max_abs_err=k9_err, ms=k9_ms, plain_ms=k9_plain_ms,
                                      **bound(*apply_cost(n, d, 100, nl_u, order)),
                                      library_ms=None, shape=f"houseelectric n={n}, c=100, n_lattice={nl_u}, "
                                      f"untrimmed, window {chunk}", peak_gb=k9_gb, unchunked_k3_ms=k3_ms,
                                      unchunked_k3_peak_gb=k3_gb, given_rows_ms=k9_given_ms, graph_ms=k9_graph_ms,
                                      capacity_occupancy_ms=k9_fit_ms, bit_equal=k9_equal)
    N_u = n * (d + 1)
    rows["join_rows"] = dict(max_abs_err=rows_err, ms=join_rows_ms,
                             plain_ms=join_rows_plain_ms, **bound(rows_bytes(N_u, N_u), 0),
                             library_ms=None, sort_ms=sort_ms,
                             shape=f"houseelectric untrimmed plan, N={N_u} contributions, M={N_u}, n_lattice={nl_u}",
                             trimmed_ms=record["join_rows_trimmed_ms"],
                             trimmed_plain_ms=record["join_rows_trimmed_plain_ms"],
                             trimmed_bound_ms=bound(rows_bytes(N_u, record["capacity"]), 0)["bound_ms"])
    return rows, launches, record


def k9_wide_filter(ref, dk, cap):
    """K9's route for a wide filter above _JOIN_MAX_ROWS, held beside the chunked chain: one join plan with its
    row lists at ``cap`` (K1, then K2 and the rows from one host call), applied by K9 in windows of 32."""
    from simplex_gp_torch.ops import filter as F
    from simplex_gp_torch.ops import lattice as L

    plan = L.build_wide_plan_join(ref, dk.coeffs, dk.variance, cap)
    return lambda V: L.apply_plan_cols(plan, V, dk.coeffs, F._WIDE_CHUNK)


def k9_rect(src, x_from, x_to, dk):
    """K9's route for the rect predict above _JOIN_MAX_ROWS: the untrimmed join plan of [x_from; x_to] with its
    row lists, K9 in windows of 32 on [src; 0], the x_to rows (lattice_filter_rect's zero-pad trick)."""
    import torch

    from simplex_gp_torch.ops import filter as F
    from simplex_gp_torch.ops import lattice as L

    plan = L.build_wide_plan_join(torch.cat([x_from, x_to]).contiguous(), dk.coeffs, dk.variance)
    v = torch.cat([src, src.new_zeros((x_to.shape[0], src.shape[1]))])
    return L.apply_plan_cols(plan, v, dk.coeffs, F._WIDE_CHUNK)[x_from.shape[0]:]


def sketch_and_predict(make_kmv, rect, params, omega, alpha, ref, ref_to) -> dict:
    """The range sketch (its wide filter built by ``make_kmv()``, two MVMs, the QR, the eigh, the root) and
    the predict (``rect`` of [alpha, root_inv] from ref to ref_to, the mean and variance), as posterior_cache
    and predict_from_cache run them, between CUDA events, with the peak device memory above what was live
    when they started.  Returns the times (ms), the peak (GB), Y = K_hat Omega, the root, the rect output and
    the predicted mean and variance."""
    import torch

    s, noise = params["outputscale"], params["noise"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    kmv = make_kmv()
    Y = s * kmv(omega) + noise * omega
    Q, _ = torch.linalg.qr(Y)
    T = Q.T @ (s * kmv(Q) + noise * Q)
    evals_, evecs = torch.linalg.eigh(0.5 * (T + T.T))
    root_inv = Q @ (evecs / torch.sqrt(torch.clamp(evals_, min=1e-8))[None, :])
    del kmv, Q, T
    ev[1].record()
    F_ = rect(torch.cat([alpha, root_inv], dim=-1), ref, ref_to)
    ev[2].record()
    torch.cuda.synchronize()
    S = s * F_[:, 1:]
    mean = s * F_[:, 0] + params["mean"]
    var = torch.clamp(s + noise - (S * S).sum(dim=-1), min=1e-8)
    return dict(range_sketch=ev[0].elapsed_time(ev[1]), predict=ev[1].elapsed_time(ev[2]),
                extra_peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9, base_gb=base / 1e9, Y=Y,
                root_inv=root_inv, rect=F_, mean=mean, var=var)


def wide_routes_check(chain: dict, k9: dict, cols, ref, ref_to, dk, y_to, expect, tag: str) -> dict:
    """The chunked chain's sketch and predict against K9's route on the same inputs: the sketch's K_hat Omega
    and the rect filter of the chain route's columns (K9 on the same columns) within LARGE_N_REL; the root
    printed; each route's own predictions against the other's under the serving gates.  Frees the K9 route's
    tensors.  Returns the record."""
    import torch

    from simplex_gp_torch.train import regression_metrics

    r_y = rel(chain["Y"], k9["Y"])
    r_rect = rel(chain["rect"], k9_rect(cols, ref, ref_to, dk))
    r_root = rel(chain["root_inv"], k9["root_inv"])
    dmean = float((chain["mean"] - k9["mean"]).abs().max())
    y_np = y_to.cpu().numpy()
    m_c, m_k = (regression_metrics(r["mean"].cpu().numpy(), r["var"].cpu().numpy(), y_np) for r in (chain, k9))
    expect(r_y <= LARGE_N_REL and r_rect <= LARGE_N_REL,
           f"{tag}: the chunked chain's sketch K_hat Omega vs K9's route rel {r_y:.3e}, the rect filter of the same "
           f"columns rel {r_rect:.3e} (limit {LARGE_N_REL}); the roots differ by rel {r_root:.3e} (printed)")
    expect(dmean <= PREDICT_MEAN_ATOL and abs(m_c["rmse"] - m_k["rmse"]) <= RMSE_ATOL
           and abs(m_c["nll"] - m_k["nll"]) <= NLL_ATOL and bool(torch.isfinite(chain["var"]).all()),
           f"{tag}: predictions on the chunked chain vs K9's route: mean max |diff| {dmean:.3e} (limit "
           f"{PREDICT_MEAN_ATOL}), RMSE {m_c['rmse']:.4f} / {m_k['rmse']:.4f} (limit {RMSE_ATOL}), NLL "
           f"{m_c['nll']:.4f} / {m_k['nll']:.4f} (limit {NLL_ATOL})")
    for key in ("Y", "root_inv", "rect", "mean", "var"):
        k9.pop(key)
    return dict(sketch_rel=r_y, rect_rel=r_rect, root_rel=r_root, mean_max_abs_diff=dmean, chain_metrics=m_c,
                k9_metrics=m_k)


def _k2_then_rows(K, L, h1, h2, w, oh1, oh2, cap, n, d):
    """K2 and then join_rows as two host calls: the route the one-call wide plan replaces."""
    seg, nb, nl = K.lattice_dedup_neighbors(h1, h2, oh1, oh2, cap)
    return K.join_rows(seg.reshape(n, d + 1), w, nb, nl)


def backward_parts(ref, dk, cap, c: int, seed: int) -> dict:
    """The exact backward's parts by CUDA events (random V and U), on both routes.  The chain route, the path's
    (LatticeInvQuadLogdet.backward on the CG's plan, built here as the CG builds it, K1 + K3'a): the chain apply
    with its table, the transposed chain apply with its table (the maps, K3'b, K3'c transposed, K3'd), K5 at
    slice_idx.  The join route, the one before: the join plan (K1 + K2) and its row lists as two calls, the
    plan with its rows from one host call (K1, then K2 and the rows, build_wide_plan_join), K9 with its table,
    K9 transposed with its table, K5."""
    import torch

    from simplex_gp_torch.kernels import lattice as K
    from simplex_gp_torch.ops import lattice as L

    n, d = ref.shape
    gen = torch.Generator(device=ref.device).manual_seed(seed)
    V, U = (torch.randn((n, c), generator=gen, device=ref.device) for _ in range(2))
    E = torch.from_numpy(L.build_rotation(d, dk.variance)).to(ref.device)
    chain = L.build_plan_chain(ref, dk.coeffs, dk.variance, cap)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(11)]
    ev[0].record()
    _, table_f = L.apply_plan_chain(chain, V, dk.coeffs, return_table=True)
    ev[1].record()
    _, table_b = L.apply_plan_chain(chain, U, dk.coeffs, transpose=True, return_table=True)
    ev[2].record()
    K.lattice_filter_grad(ref, E, chain.slice_idx, V, U, table_f, table_b, L.SLICE_NORM(d))
    ev[3].record()
    del chain, table_f, table_b
    ev[4].record()
    jplan = L.build_plan_join(ref, dk.coeffs, dk.variance, cap)
    ev[5].record()
    L.wide_plan(jplan)
    ev[6].record()
    plan = L.build_wide_plan_join(ref, dk.coeffs, dk.variance, cap)
    ev[7].record()
    _, table_f = L.apply_plan_rows(plan, V, dk.coeffs, return_table=True)
    ev[8].record()
    _, table_b = L.apply_plan_rows(plan, U, dk.coeffs, transpose=True, return_table=True)
    ev[9].record()
    K.lattice_filter_grad(ref, E, plan.seg_ids, V, U, table_f, table_b, L.SLICE_NORM(d))
    ev[10].record()
    torch.cuda.synchronize()
    names = ("backward_chain_forward", "backward_chain_transpose", "backward_chain_k5", None, "backward_join_plan",
             "backward_join_rows", "backward_wide_plan", "backward_k9", "backward_k9t", "backward_k5")
    parts = {nm: ev[i].elapsed_time(ev[i + 1]) for i, nm in enumerate(names) if nm is not None}
    parts["backward_chain_total"] = ev[0].elapsed_time(ev[3])
    parts["backward_join_total"] = ev[6].elapsed_time(ev[10])  # the one-call plan, K9, K9 transposed, K5
    return parts


def k5_houseelectric(dev, ds, dk, cap, ell, expect, timer) -> dict:
    """K5 at the houseelectric training step's shape: c = 11 on the backward's plan, the CG's chain plan at the
    trimmed capacity, and its two final-order tables (the chain apply's and the transposed apply's, random V
    and U), against its plain twin and a second run bit for bit, with its time."""
    import torch

    from simplex_gp_torch.kernels import lattice as K
    from simplex_gp_torch.ops import lattice as L

    ref = (torch.from_numpy(ds.train_x).to(dev) / ell).contiguous()
    n, d = ref.shape
    gen = torch.Generator(device=dev).manual_seed(9)
    V, U = (torch.randn((n, 11), generator=gen, device=dev) for _ in range(2))
    E = torch.from_numpy(L.build_rotation(d, dk.variance)).to(dev)
    plan = L.build_plan_chain(ref, dk.coeffs, dk.variance, cap)
    _, tf = L.apply_plan_chain(plan, V, dk.coeffs, return_table=True)
    _, tb = L.apply_plan_chain(plan, U, dk.coeffs, transpose=True, return_table=True)
    args = (ref, E, plan.slice_idx, V, U, tf, tb, L.SLICE_NORM(d))
    gk, gp = K.lattice_filter_grad(*args), K.lattice_filter_grad_plain(*args)
    equal, repeat = torch.equal(gk, gp), torch.equal(gk, K.lattice_filter_grad(*args))
    expect(equal and repeat, f"houseelectric K5 (c = 11, capacity {cap}, the chain plan's tables): bit-equal to "
           f"plain {equal}, to a second run {repeat} (rel {rel(gk, gp):.3e})")
    rec = dict(max_abs_err=float((gk - gp).abs().max()), ms=timer(lambda: K.lattice_filter_grad(*args), 20),
               graph_ms=graph_ms(lambda: K.lattice_filter_grad(*args), 10),
               plain_ms=timer(lambda: K.lattice_filter_grad_plain(*args), 3), **k5_bound(n, d, 11, int(plan.n_lattice)),
               shape=f"houseelectric n={n}, d={d}, c=11, capacity {cap}, n_lattice={int(plan.n_lattice)}, chain plan")
    print(f"    K5 at houseelectric: {rec['ms']:.4f} ms (graph {rec['graph_ms']:.4f}), plain {rec['plain_ms']:.3f} ms, "
          f"bound {rec['bound_ms']:.4f} ms")
    return rec


def houseelectric_stages(dev, ds, dk, cap, ell):
    """Phase 6.5: a warm training step and an eval (posterior cache + val predict) by stage.

    The stages are those of mll._solve_system and SimplexGP.posterior_cache /
    predict_from_cache, run one by one between CUDA events: the chain plan
    (K1 + K3'a) and the CGs on it, the range sketch on a join plan of its
    own (its build included).
    """
    import torch

    import simplex_gp_torch
    from simplex_gp_torch.linalg import mll
    from simplex_gp_torch.linalg.cg import cg_solve
    from simplex_gp_torch.linalg.lanczos import logdet_from_cg_tridiag
    from simplex_gp_torch.linalg.pivoted_cholesky import precond_sqrt
    from simplex_gp_torch.models.components import init_raw_params
    from simplex_gp_torch.models.exact_gp import rademacher
    from simplex_gp_torch.ops.filter import apply_plan_any, build_plan_any, lattice_filter_rect, make_wide_filter

    cfg = mll.BBMMConfig(cg_tolerance=1.0, max_cg_iterations=500, max_lanczos_iterations=100, precond_rank=100,
                         num_probes=10, plan_capacity=cap)
    model = simplex_gp_torch.SimplexGP(num_dims=11, kernel="matern", nu=1.5, order=1, min_noise=0.1, bbmm=cfg,
                                       device=dev)
    model.load_raw(init_raw_params(11, lengthscale=ell))
    x, y = torch.from_numpy(ds.train_x).to(dev), torch.from_numpy(ds.train_y).to(dev)
    xv = torch.from_numpy(ds.val_x).to(dev)
    n = x.shape[0]
    z = rademacher((n, 10), torch.Generator(device=dev).manual_seed(7), dev)
    opt = torch.optim.Adam(model.parameters(), lr=0.1)
    train_step(model, opt, x, y, z)  # warm-up
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
    peaks = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    opt.zero_grad(set_to_none=True)
    with torch.no_grad():
        ev[0].record()
        params = model.constrained()
        ref = x * params["inv_ell"]
        plan = build_plan_any(ref, dk, cap)
        ev[1].record()
        P = mll.build_precond(dk, cfg, params, ref, n)
        ev[2].record()
        s, noise = params["outputscale"], params["noise"]
        res = cg_solve(lambda V: apply_plan_any(plan, V, dk),
                       torch.cat([(y - params["mean"])[:, None], precond_sqrt(P, z)], dim=-1), tol=1.0,
                       max_iters=500, precond=P, tridiag_m=100, shift=(s, noise))
        ev[3].record()
        logdet_from_cg_tridiag(res.alphas[:, 1:], res.betas[:, 1:], res.tmask[:, 1:], (z * z).sum(0))
        ev[4].record()
    loss = model.nlml(x, y, probes=z)
    ev[5].record()
    loss.backward()
    ev[6].record()
    opt.step()
    ev[7].record()
    torch.cuda.synchronize()
    peaks["training_step"] = torch.cuda.max_memory_allocated() / 1e9
    names = ("plan", "preconditioner", "cg", "slq", "forward", "backward", "adam")
    stages = {nm: ev[i].elapsed_time(ev[i + 1]) for i, nm in enumerate(names)}
    stages["cg_iters"] = res.iterations
    with torch.no_grad():
        stages["slq_case"] = slq_case(res, cuda_ms)
    # One training CG iteration's parts at c = 11, by CUDA-graph replay: the MVM, K10's passes over U (U^T R's
    # partials, their fold, R / noise - U G2), and cuBLAS's U^T R and U G2 of the same shapes.
    r11 = res.x.contiguous()
    stages.update(cg_mvm_graph_ms=graph_ms(lambda: apply_plan_any(plan, r11, dk), 10), **u_pass_times(P, r11, "cg"))
    backward_parts(ref.contiguous(), dk, cap, 11, 9)  # warm
    stages.update(backward_parts(ref.contiguous(), dk, cap, 11, 9))
    stages["warm_step"] = cuda_ms(lambda: train_step(model, opt, x, y, z), 2)
    stages["backward_profile"] = backward_profile(model, x, y, z)
    del plan, P, res, loss

    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with torch.no_grad():
        ev[0].record()
        params = model.constrained()
        ref = x * params["inv_ell"]
        plan = build_plan_any(ref, dk, cap)
        ev[1].record()
        P = mll.build_precond(dk, cfg, params, ref, n)
        ev[2].record()
        s, noise = params["outputscale"], params["noise"]
        sol = cg_solve(lambda V: apply_plan_any(plan, V, dk), (y - params["mean"])[:, None],
                       tol=model.eval_cg_tolerance, max_iters=500, precond=P, shift=(s, noise), graph=True)
        ev[3].record()
        peaks["eval_plan_and_cg"] = torch.cuda.max_memory_allocated() / 1e9
        omega = torch.randn((n, 100), generator=torch.Generator(device=dev).manual_seed(8), device=dev)
        ref_val, alpha = xv * params["inv_ell"], sol.x[:, :1]
        # The path's route: the sketch's own chain plan at the capacity and the [train; val] plan untrimmed, each
        # applied in 16-column blocks (above _JOIN_MAX_ROWS); then K9's route on the same inputs.
        chain = sketch_and_predict(lambda: make_wide_filter(ref, dk, cap),
                                   lambda c, a, b: lattice_filter_rect(c, a, b, dk), params, omega, alpha, ref,
                                   ref_val)
        evals = {nm: ev[i].elapsed_time(ev[i + 1]) for i, nm in enumerate(("plan", "preconditioner", "eval_cg"))}
        evals.update(range_sketch=chain["range_sketch"], predict_val=chain["predict"])
        peaks["eval"] = max(peaks["eval_plan_and_cg"], chain["base_gb"] + chain["extra_peak_gb"])
        chain_host = {k_: chain.pop(k_).cpu() for k_ in ("Y", "root_inv")}
        k9 = sketch_and_predict(lambda: k9_wide_filter(ref, dk, cap), lambda c, a, b: k9_rect(c, a, b, dk), params,
                                omega, alpha, ref, ref_val)
        k9["Y"], k9["root_inv"] = k9["Y"].cpu(), k9["root_inv"].cpu()
        evals.update(range_sketch_k9=k9["range_sketch"], predict_val_k9=k9["predict"])
        peaks.update(eval_sketch_predict_extra=chain["extra_peak_gb"], eval_sketch_predict_extra_k9=k9["extra_peak_gb"],
                     eval_k9_route=max(peaks["eval_plan_and_cg"], k9["base_gb"] + k9["extra_peak_gb"]))
        routes = (dict(chain, **chain_host), k9, torch.cat([alpha, chain_host["root_inv"].to(dev)], dim=-1), ref,
                  ref_val)
    torch.cuda.synchronize()
    evals["eval_cg_iters"] = sol.iterations
    # One eval CG iteration's parts at these parameters, by CUDA-graph replay: the MVM, K10's passes over U and
    # cuBLAS's products of the same shapes.
    r1 = sol.x[:, :1].contiguous()
    evals.update(eval_mvm_graph_ms=graph_ms(lambda: apply_plan_any(plan, r1, dk), 10), **u_pass_times(P, r1, "eval"))
    # The eval CG's stop: its count, best residual and the rule that ended it (ROADMAP section 3, item 3), with
    # the parameters it ran at (raw, after the warm steps above), so that another solver can be run on them.
    evals.update(eval_cg_res=float(sol.residual_norm.mean()),
                 eval_cg_stop=cg_stop_rule(sol.iterations, float(sol.residual_norm.mean()), model.eval_cg_tolerance,
                                           500),
                 eval_raw_params={k_: v_.detach().cpu().reshape(-1).tolist() for k_, v_ in model.named_parameters()})
    return stages, evals, peaks, routes


# Kernels of a join plan built with its rows in one call (csrc/dedup.cu, csrc/join_rows.cu; cub's radix sort
# and scans), the exact backward's before it reused the CG's chain plan, and of the chain backward (the maps,
# the splat's short rows, the fused axes (transposed), the slice, K5), by a part of their names under
# torch.profiler.
WIDE_PLAN_KERNELS = ("insert_kernel", "neighbors_kernel", "rows_pack_kernel", "DeviceRadixSort",
                     "join_runs_kernel", "join_rows_kernel", "DeviceScan")
CHAIN_BACKWARD_KERNELS = ("chain_maps_kernel", "chain_axes_kernel", "chain_slice_kernel", "filter_grad")


def backward_profile(model, x, y, z) -> dict:
    """One exact backward of a training step under torch.profiler: how often torch.sort and torch.cumsum ran
    in it, and the launches of a join plan's kernels and of the chain backward's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    loss = model.nlml(x, y, probes=z)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loss.backward()
        torch.cuda.synchronize()
    model.zero_grad(set_to_none=True)
    counts = {e.key: e.count for e in prof.key_averages()}
    return dict(sorts=sum(c for k, c in counts.items() if k in ("aten::sort", "aten::argsort")),
                cumsums=sum(c for k, c in counts.items() if k == "aten::cumsum"),
                kernels={part: sum(c for k, c in counts.items() if part in k) for part in WIDE_PLAN_KERNELS},
                chain_kernels={part: sum(c for k, c in counts.items() if part in k)
                               for part in CHAIN_BACKWARD_KERNELS})


def cg_stop_rule(iterations: int, best_res: float, tol: float, max_iters: int) -> str:
    """Which of cg_solve's rules ended a one-column "mean" solve (cg.py:65-69): max_iters, the tolerance (the
    residual fell below tol, so the best one did), or the stall guard (50 iterations past the floor without a
    1% gain in the best residual)."""
    if iterations >= max_iters:
        return "max_iters"
    return "tolerance" if best_res < tol else "stall guard"


def u_pass_times(P, r, prefix: str) -> dict:
    """K10's passes over U at r's width (CUDA-graph replays) beside cuBLAS's U^T r and U G2 and their bounds."""
    import torch

    from simplex_gp_torch.kernels import cg as K10

    (n, k), t = P.U.shape, r.shape[1]
    lay = K10.u_layout(n, k, t)
    U = P.U.contiguous()
    w = (P.s2 / (P.noise * (P.noise + P.s2)) / P.gamma).contiguous()
    noise = P.noise.reshape(()).contiguous()
    part_g, G2 = torch.empty((lay.nb, k, t), device=r.device), torch.empty((k, t), device=r.device)
    z, part = torch.empty_like(r), torch.empty((lay.nb, t), device=r.device)
    K10.cg_utr(U, r, part_g)
    K10.cg_fold(part_g, w, G2)
    G, H = torch.empty_like(G2), torch.empty_like(r)
    out = {f"{prefix}_cg_utr_graph_ms": graph_ms(lambda: K10.cg_utr(U, r, part_g), 10),
           f"{prefix}_cg_fold_graph_ms": graph_ms(lambda: K10.cg_fold(part_g, w, G2), 10),
           f"{prefix}_cg_precond_graph_ms": graph_ms(lambda: K10.cg_precond(U, G2, r, noise, z, part), 10),
           f"{prefix}_mm_utr_graph_ms": graph_ms(lambda: torch.mm(U.T, r, out=G), 10),
           f"{prefix}_mm_ug_graph_ms": graph_ms(lambda: torch.mm(U, G2, out=H), 10)}
    for nm in ("cg_utr", "cg_precond"):
        out[f"{prefix}_{nm}_bound_ms"] = bound(*u_pass_cost(nm, n, k, t, lay.nb))["bound_ms"]
    return out


def parallel_rank(axis, case):
    """Phase 7.3's rank body, on each of two gloo ranks sharing the card.

    The sharded filter at c = 11 on the sharded join (K11b) and on the
    sharded chain (the engine's plan); K11b against its plain version
    (forward and transposed, outputs and blurred tables); the sharded chain
    apply against its plain version (:func:`sharded_chain_checks`), with its
    global plan fields for the parent to hold across ranks; one K6' step against its
    plain version at this rank's shapes, with the pivot held by whichever
    rank wins it (-1 on the others); the rank-100 sharded factor, whose rows
    the parent holds against one process's; the data-parallel NLML and
    gradients (``data_parallel_loss_fn``) with the kernels' launch counts of
    that run; one Adam step; the step's stages by CUDA events and its
    transport by the axis's timed collectives; K10' (the sharded CG's three
    reducing kernels given every rank's partials) against their plain twins
    from a saved state three iterations into the step's CG; that CG's
    collectives between consecutive MVMs; the J = 8 mixture's data-parallel
    NLML, gradients and warm step (the mixture golden file's median init and
    weights); then ``simplex_gp_torch.scaling``'s records; then, with
    ``case["house"]``, the houseelectric stand-in's data-parallel NLML and
    gradients (:func:`house_rank`).  Returns numpy arrays and numbers.
    """
    import dataclasses

    import torch

    import simplex_gp_torch
    from simplex_gp_torch import convert, scaling
    from simplex_gp_torch.kernels import cg as K10
    from simplex_gp_torch.kernels import chain as KC
    from simplex_gp_torch.kernels import lattice as K
    from simplex_gp_torch.kernels.pivot import pivot_column, pivot_column_plain
    from simplex_gp_torch.linalg import mll
    from simplex_gp_torch.linalg.cg import CGLoop, cg_solve
    from simplex_gp_torch.linalg.pivoted_cholesky import pivoted_cholesky_features, precond_sqrt, sharded_pivot
    from simplex_gp_torch.ops import lattice as L
    from simplex_gp_torch.parallel import (build_plan_sharded, build_plan_sharded_join, data_parallel_loss_fn,
                                           replicate, shard_batch)

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = mll.BBMMConfig(**case["cfg"])
    model = simplex_gp_torch.SimplexGP(num_dims=case["d"], kernel="matern", nu=1.5, order=1, min_noise=0.1,
                                       bbmm=cfg, device=dev)
    model.load_raw(case["raw"])
    replicate(axis, model)
    x, y, z, v = shard_batch(axis, case["x"], case["y"], case["z"], case["v"])
    dk = model.dk
    out = dict(transport=axis.transport)
    with torch.no_grad():
        ref = (x * model.constrained()["inv_ell"]).contiguous()
        plan = build_plan_sharded_join(ref, dk.coeffs, dk.variance, axis)
        out["filter"] = L.apply_plan_join(plan, v, dk.coeffs, axis=axis).cpu().numpy()
        out["n_lattice"] = int(plan.n_lattice)
        taps, norm = list(dk.coeffs), L.SLICE_NORM(case["d"])
        out["k11b_rel"], out["k11b_equal"] = 0.0, True
        for transpose in (False, True):
            kout, ktab = K.lattice_apply_sharded(*plan[:4], v, taps, norm, axis, transpose, True, plan.rows)
            again, _ = K.lattice_apply_sharded(*plan[:4], v, taps, norm, axis, transpose, True, plan.rows)
            pout, ptab = K.apply_sharded_plain(*plan[:4], v, taps, norm, axis, transpose, True, plan.rows)
            out["k11b_rel"] = max(out["k11b_rel"], rel(kout, pout), rel(ktab, ptab))
            out["k11b_equal"] &= bool(torch.equal(kout, pout) and torch.equal(ktab, ptab) and torch.equal(again, kout))
        out["apply_ms"] = cuda_ms(lambda: L.apply_plan_join(plan, v, dk.coeffs, axis=axis), 5)
        # The whole apply and its collectives from the same calls, each collective between two synchronises.
        axis.timing = True
        axis.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            L.apply_plan_join(plan, v, dk.coeffs, axis=axis)
        torch.cuda.synchronize()
        out["apply_timed_ms"] = 1e3 * (time.perf_counter() - t0) / 5
        out["apply_transport_ms"] = 1e3 * axis.stats["seconds"] / 5
        out["apply_bytes_per_collective"] = axis.stats["bytes"] / max(1, axis.stats["calls"])
        axis.timing = False
        cplan = build_plan_sharded(ref, dk.coeffs, dk.variance, axis)
        out["chain_filter"] = L.apply_plan_chain(cplan, v, dk.coeffs, axis=axis).cpu().numpy()
        out["chain_global"] = {f: getattr(cplan, f).cpu().numpy() for f in ("gather", "tapw", "n_lattice")}
        out["chain"] = sharded_chain_checks(cplan, v, dk, axis)
        out["chain_build_ms"] = cuda_ms(lambda: build_plan_sharded(ref, dk.coeffs, dk.variance, axis), 3)
        del cplan

        # The rank-100 sharded factor, and one K6' step on its first 99 columns: the winner's rows come
        # from sharded_pivot, so one of the two ranks runs with piv = -1.
        s = model.constrained()["outputscale"].reshape(()).contiguous()
        k = cfg.precond_rank
        diag = s * torch.ones(ref.shape[0], device=dev)
        pc = pivoted_cholesky_features(ref, diag, dk.nu, s, k, axis)
        out["factor_L"] = pc.L.cpu().numpy()
        L0 = pc.L.clone()
        L0[:, k - 1] = 0.0
        dg = torch.clamp(diag - (L0 * L0).sum(dim=-1), min=0.0)
        piv, row = sharded_pivot(ref, L0, dg, axis)
        La, Lb = L0.clone(), L0.clone()
        pa, pb = pc.pivots.clone(), pc.pivots.clone()
        d0 = axis.pmax(diag.max())
        da = pivot_column(ref, La, dg, piv, k - 1, s, d0, dk.nu, pa, row)
        db = pivot_column_plain(ref, Lb, dg, piv, k - 1, s, d0, dk.nu, pb, row)
        out.update(k6_step_rel=max(rel(La[:, k - 1], Lb[:, k - 1]), rel(da, db)), k6_step_piv=int(piv),
                   k6_step_pivots_equal=bool(torch.equal(pa, pb)))

    # K10': the step's CG as _solve_system poses it (the sharded chain plan, the rank-100 preconditioner,
    # [y | P^1/2 z], the shift, the 100-step record), three iterations in, then its three reducing kernels
    # against their twins.
    acfg = dataclasses.replace(cfg, axis=axis)
    with torch.no_grad():
        params = model.constrained()
        ref = x * params["inv_ell"]
        plan = build_plan_sharded(ref, dk.coeffs, dk.variance, axis)
        P = mll.build_precond(dk, acfg, params, ref, axis.n_global(x.shape[0]))
        s, noise = params["outputscale"], params["noise"]
        rhs = torch.cat([(y - params["mean"])[:, None], precond_sqrt(P, z, axis)], dim=-1)

        def cg_mv(V):
            return L.apply_plan_chain(plan, V, dk.coeffs, axis=axis)

        loop = CGLoop(cg_mv, rhs, tol=cfg.cg_tolerance, max_iters=cfg.max_cg_iterations, precond=P, tridiag_m=100,
                      shift=(s, noise), axis=axis)
        for _ in range(3):
            loop.iteration()
        out["k10_sharded"] = k10_sharded_pairs(loop, axis, 20)
        del loop

    path = (K.lattice_geometry, KC.chain_build, KC.chain_splat, KC.chain_axes, KC.chain_maps,
            KC.chain_axes_transpose, KC.chain_unblock, KC.chain_slice, K.lattice_filter_grad,
            K10.cg_dot, K10.cg_step_x, K10.cg_utr, K10.cg_fold, K10.cg_precond, K10.cg_step_p, K10.cg_init)
    off_path = (K.lattice_dedup_ordered, K.lattice_apply_sharded, K.lattice_apply)  # the join's K11a, K11b; K3
    for fn in (*path, *off_path):
        fn.launches = 0
    pivot_column.sharded_launches = 0
    step = data_parallel_loss_fn(model, axis)
    stats = {}
    loss, grads = step(x, y, probes=z, stats=stats)
    out["launches"] = {fn.__name__: fn.launches for fn in path}
    out["off_path_launches"] = {fn.__name__: fn.launches for fn in off_path}
    out["launches"]["pivot_column_at"] = pivot_column.sharded_launches
    for name in ("cg_step_x", "cg_step_p", "cg_init", "cg_fold"):  # K10''s rows: the reducing kernels on this step
        out["launches"][f"{name}_sharded"] = out["launches"][name]
    out.update(loss=float(loss), grads={k: g.cpu().numpy() for k, g in grads.items()}, cg_iters=stats["cg_iters"],
               cg_res=stats["cg_res"])
    loss2, grads2 = step(x, y, probes=z)  # the same step again: every kernel and collective in a fixed order
    out["step_repeat_bit_equal"] = float(loss2) == float(loss) and all(
        torch.equal(grads2[k], g) for k, g in grads.items())
    opt = torch.optim.Adam(model.parameters(), lr=0.1)
    opt.step()
    out["params"] = {k: p.detach().cpu().numpy() for k, p in model.named_parameters()}

    # The stages of one step, as mll._solve_system and data_parallel_loss_fn run them.
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(9)]
    model.zero_grad(set_to_none=True)
    with torch.no_grad():
        ev[0].record()
        params = model.constrained()
        ref = x * params["inv_ell"]
        plan = build_plan_sharded(ref, dk.coeffs, dk.variance, axis)
        ev[1].record()
        P = mll.build_precond(dk, acfg, params, ref, axis.n_global(x.shape[0]))
        ev[2].record()
        s, noise = params["outputscale"], params["noise"]
        rhs = torch.cat([(y - params["mean"])[:, None], precond_sqrt(P, z, axis)], dim=-1)
        cg_kw = dict(tol=cfg.cg_tolerance, max_iters=cfg.max_cg_iterations, precond=P, tridiag_m=100, axis=axis,
                     shift=(s, noise))
        res = cg_solve(lambda V: L.apply_plan_chain(plan, V, dk.coeffs, axis=axis), rhs, **cg_kw)
        ev[3].record()
    ev[4].record()
    loss = model.nlml(x, y, probes=z, axis=axis)
    ev[5].record()
    loss.backward()
    ev[6].record()
    named = list(model.named_parameters())
    flat = axis.psum(torch.cat([p.grad.reshape(-1) for _, p in named]))
    for p, g in zip((p for _, p in named), flat.split([p.numel() for _, p in named])):
        p.grad = g.reshape(p.shape)
    ev[7].record()
    opt.step()
    ev[8].record()
    torch.cuda.synchronize()
    names = ("plan", "preconditioner", "cg", None, "forward", "backward", "grad_psum", "adam")
    stages = {nm: ev[i].elapsed_time(ev[i + 1]) for i, nm in enumerate(names) if nm}
    stages["cg_iters"] = res.iterations
    out["cg_state"] = dict(iterations=res.iterations, residual=res.residual_norm.cpu().numpy(),
                           alphas=res.alphas.cpu().numpy(), betas=res.betas.cpu().numpy())

    # The CG's own collectives: those between one MVM's end and the next one's start (an iteration's), and
    # the solve's in all less the MVMs'.
    marks, mvm_calls = [], []

    def counted_mv(V):
        c0 = axis.stats["calls"]
        out_ = L.apply_plan_chain(plan, V, dk.coeffs, axis=axis)
        marks.append((c0, axis.stats["calls"]))
        mvm_calls.append(axis.stats["calls"] - c0)
        return out_

    axis.timing = True
    axis.reset_stats()
    with torch.no_grad():
        res_c = cg_solve(counted_mv, rhs, **cg_kw)
    axis.timing = False
    between = sorted({b0 - a1 for (_, a1), (b0, _) in zip(marks, marks[1:])})
    stages.update(cg_collectives=axis.stats["calls"] - sum(mvm_calls), cg_collectives_an_iteration=between,
                  cg_mvm_collectives=sum(mvm_calls), cg_iters_counted=res_c.iterations)

    def train_step_():
        step(x, y, probes=z)
        opt.step()

    stages["warm_step"] = cuda_ms(train_step_, 3)
    axis.timing = True
    axis.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_step_()
    torch.cuda.synchronize()
    timed_ms = 1e3 * (time.perf_counter() - t0)
    axis.timing = False
    comm = dict(axis.stats)
    stages.update(timed_step_ms=timed_ms, transport_ms=1e3 * comm["seconds"],
                  kernels_and_host_ms=timed_ms - 1e3 * comm["seconds"], collectives=comm["calls"],
                  transport_bytes=comm["bytes"])
    out["stages"] = stages

    # The J = 8 mixture on the same rows and probes: one sharded plan per component.
    mix = convert.mixture_model_from_jax(case["mixture_raw"], case["mixture_weights"], nu=1.5, order=1,
                                         min_noise=0.1, bbmm=cfg, device=dev)
    replicate(axis, mix)
    mix_step = data_parallel_loss_fn(mix, axis)
    mix_stats = {}
    loss, grads = mix_step(x, y, probes=z, stats=mix_stats)
    out["mixture"] = dict(loss=float(loss), grads={k: g.cpu().numpy() for k, g in grads.items()},
                          cg_iters=mix_stats["cg_iters"], cg_res=mix_stats["cg_res"],
                          warm_step_ms=cuda_ms(lambda: mix_step(x, y, probes=z), 2))
    out["scaling"] = scaling.records(axis, case["scaling_argv"])
    if case.get("house") is not None:
        out["house"] = house_rank(axis, case["house"])
    return out


def house_rank(axis, hcase):
    """Phase 7.5's rank body: the houseelectric stand-in's data-parallel NLML and raw gradients
    (``data_parallel_loss_fn``) on this rank's rows, with the given probes and the median-init parameters,
    the kernels' launches on the step (K11a and K11b apart), and a second step's time by CUDA events."""
    import torch

    import simplex_gp_torch
    from simplex_gp_torch.kernels import chain as KC
    from simplex_gp_torch.kernels import lattice as K
    from simplex_gp_torch.linalg import mll
    from simplex_gp_torch.parallel import data_parallel_loss_fn, replicate, shard_batch

    dev = torch.device("cuda", torch.cuda.current_device())
    model = simplex_gp_torch.SimplexGP(num_dims=hcase["x"].shape[1], kernel="matern", nu=1.5, order=1, min_noise=0.1,
                                       bbmm=mll.BBMMConfig(**hcase["cfg"]), device=dev)
    model.load_raw(hcase["raw"])
    replicate(axis, model)
    x, y, z = shard_batch(axis, hcase["x"], hcase["y"], hcase["z"])
    path = (KC.chain_build, KC.chain_splat, KC.chain_axes, KC.chain_axes_transpose, KC.chain_unblock,
            KC.chain_slice, K.lattice_filter_grad)
    off_path = (K.lattice_dedup_ordered, K.lattice_apply_sharded)
    for fn in (*path, *off_path):
        fn.launches = 0
    step = data_parallel_loss_fn(model, axis)
    stats = {}
    loss, grads = step(x, y, probes=z, stats=stats)
    out = dict(loss=float(loss), grads={k: g.cpu().numpy() for k, g in grads.items()}, cg_iters=stats["cg_iters"],
               launches={fn.__name__: fn.launches for fn in path},
               off_path_launches={fn.__name__: fn.launches for fn in off_path})
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    step(x, y, probes=z)
    ev[1].record()
    torch.cuda.synchronize()
    out["step_ms"] = ev[0].elapsed_time(ev[1])
    return out


def house_case(nprocs: int) -> dict:
    """Phase 7.5's problem: the houseelectric stand-in's first rows (houseelectric_golden.npz's max_n, cut to
    a multiple of ``nprocs``), the golden file's probe seed and median-init parameters, and phase 6's
    "fixed" CG (tolerance 0, the golden file's iteration count: the same iterations on every side), the
    plan untrimmed (the sharded plan has no capacity)."""
    from simplex_gp_torch.utils import data

    golden = np.load(HOUSE_GOLDEN)
    hds = data.load_dataset("houseelectric")
    cut = int(golden["max_n"])
    n = (cut // nprocs) * nprocs
    z = np.random.default_rng(int(golden["seed"])).choice([-1.0, 1.0], size=(cut, 10)).astype(np.float32)
    return dict(x=hds.train_x[:n], y=hds.train_y[:n], z=z[:n], raw={k: golden[f"init_{k}"] for k in RAW_NAMES},
                cfg=dict(cg_tolerance=0.0, max_cg_iterations=int(golden["cg_iters_fixed"]), max_lanczos_iterations=100,
                         precond_rank=100, num_probes=10))


def parallel_case(ds, nprocs: int) -> dict:
    """Phase 7's problem: the elevators rows shard_batch keeps over ``nprocs`` ranks, the median init of
    elevators_train_golden.npz, its probes, and 11 filter columns, as numpy arrays; and the houseelectric
    stand-in's (:func:`house_case`)."""
    golden, mixture = np.load(TRAIN_GOLDEN), np.load(MIXTURE_GOLDEN)
    n = (ds.train_x.shape[0] // nprocs) * nprocs
    return dict(d=ds.train_x.shape[1], x=ds.train_x[:n], y=ds.train_y[:n],
                z=np.random.default_rng(int(golden["seed_init"])).choice([-1.0, 1.0], size=(n, 10)).astype(np.float32),
                v=np.random.default_rng(7).normal(size=(n, 11)).astype(np.float32),
                raw={k: golden[f"init_{k}"] for k in RAW_NAMES},
                mixture_raw={k: mixture[f"init_{k}"] for k in RAW_NAMES}, mixture_weights=mixture["weights"],
                cfg=dict(cg_tolerance=1.0, max_cg_iterations=500, max_lanczos_iterations=100, precond_rank=100,
                         num_probes=10),
                scaling_argv=["--rows", str(n), "-d", str(ds.train_x.shape[1]), "--cols", "11", "--reps", "3"],
                house=house_case(nprocs))


def parallel_model(case, dev):
    import simplex_gp_torch
    from simplex_gp_torch.linalg import mll

    model = simplex_gp_torch.SimplexGP(num_dims=case["d"], kernel="matern", nu=1.5, order=1, min_noise=0.1,
                                       bbmm=mll.BBMMConfig(**case["cfg"]), device=dev)
    model.load_raw(case["raw"])
    return model


def parallel_phase(dev, ds, expect, timer):
    """Phase 7: the data-parallel training path at elevators' width.  Returns (kernel rows, launches, record)."""
    import os
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from simplex_gp_torch import scaling
    from simplex_gp_torch.kernels import chain as KC
    from simplex_gp_torch.kernels import lattice as K
    from simplex_gp_torch.kernels.pivot import pivot_column, pivot_column_plain
    from simplex_gp_torch.linalg.pivoted_cholesky import pivoted_cholesky_features
    from simplex_gp_torch.ops import lattice as L
    from simplex_gp_torch.parallel import build_plan_sharded, build_plan_sharded_join, initialize_distributed, make_mesh

    case = parallel_case(ds, 2)
    model = parallel_model(case, dev)
    dk = model.dk
    n, d = case["x"].shape
    order, taps, norm = dk.order, list(dk.coeffs), L.SLICE_NORM(d)
    x = torch.from_numpy(case["x"]).to(dev)
    v = torch.from_numpy(case["v"]).to(dev)
    E, a, oh1, oh2 = L._lattice_constants(d, dk.coeffs, dk.variance, dev)
    rows, record = {}, {}
    with torch.no_grad():
        params = model.constrained()
        ref = (x * params["inv_ell"]).contiguous()

    print(f"parallel 7.1: K11a lattice_dedup_ordered vs plain and K2 (elevators median init, {n} rows)")
    with torch.no_grad():
        h1, h2, w = K.lattice_geometry(ref, E, a)
        N = h1.shape[0]
        kseg, knb, knl = K.lattice_dedup_ordered(h1, h2, oh1, oh2)
        aseg, anb, _ = K.lattice_dedup_ordered(h1, h2, oh1, oh2)
        pseg, pnb, pnl = K.dedup_ordered_plain(h1, h2, oh1, oh2)
        _, _, nl2 = K.lattice_dedup_neighbors(h1, h2, oh1, oh2)
        diff = int((kseg != pseg).sum()) + int((knb != pnb).sum())
        twice = bool(torch.equal(aseg, kseg) and torch.equal(anb, knb))
        expect(diff == 0 and twice and int(knl) == int(pnl) == int(nl2),
               f"N={N}: {diff} seg/neighbour entries differ from the plain version (limit 0, bit-equal); two builds "
               f"equal: {twice}; n_lattice {int(knl)} (plain {int(pnl)}, K2 {int(nl2)})")
        k11a = dict(ms=timer(lambda: K.lattice_dedup_ordered(h1, h2, oh1, oh2), 20),
                    plain_ms=timer(lambda: K.dedup_ordered_plain(h1, h2, oh1, oh2), 5),
                    k2_ms=timer(lambda: K.lattice_dedup_neighbors(h1, h2, oh1, oh2), 20))
        print(f"    K11a {k11a['ms']:.4f} ms, plain {k11a['plain_ms']:.4f} ms, K2 {k11a['k2_ms']:.4f} ms")
        nl = int(knl)
        single = K.lattice_apply(*L.build_plan_join(ref, dk.coeffs, dk.variance), v, taps, norm)
    rows["lattice_dedup_ordered"] = dict(max_abs_err=diff, **{k: k11a[k] for k in ("ms", "plain_ms")},
                                         **bound(dedup_bytes(N, N, d + 1, order), 0), library_ms=None,
                                         shape=f"N={N} hash pairs (elevators at P = 2)", k2_ms=k11a["k2_ms"])
    del kseg, knb, aseg, anb, pseg, pnb

    print("parallel 7.2: K11b lattice_apply_sharded (bit for bit, and a second call) and K6' (pivot_column given the "
          "pivot's rows) vs plain, one NCCL rank")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    initialize_distributed(backend="nccl", init_method="file://" + os.path.join(tmp, "store"), rank=0,
                           world_size=1, device="cuda")
    try:
        axis = make_mesh()
        with torch.no_grad():
            plan = build_plan_sharded_join(ref, dk.coeffs, dk.variance, axis)
            k11b_err, r11b, k11b_equal = 0.0, 0.0, True
            for transpose in (False, True):
                kout, ktab = K.lattice_apply_sharded(*plan[:4], v, taps, norm, axis, transpose, True, plan.rows)
                again, atab = K.lattice_apply_sharded(*plan[:4], v, taps, norm, axis, transpose, True, plan.rows)
                pout, ptab = K.apply_sharded_plain(*plan[:4], v, taps, norm, axis, transpose, True, plan.rows)
                r11b = max(r11b, rel(kout, pout), rel(ktab, ptab))
                k11b_equal &= bool(torch.equal(kout, pout) and torch.equal(ktab, ptab) and torch.equal(again, kout)
                                   and torch.equal(atab, ktab))
                k11b_err = max(k11b_err, float((kout - pout).abs().max()))
                if not transpose:
                    r_k3 = rel(kout, single)
            expect(k11b_equal and r_k3 <= K3_REL,
                   f"c=11, forward and transposed: outputs and ({ktab.shape[0]}, 11) tables bit-equal to the plain "
                   f"version and to a second call: {k11b_equal} (rel {r11b:.3e}); {r_k3:.3e} against K3 on one "
                   f"process (limit {K3_REL})")
            k11b = dict(ms=timer(lambda: K.lattice_apply_sharded(*plan[:4], v, taps, norm, axis, rows=plan.rows), 20),
                        plain_ms=timer(lambda: K.apply_sharded_plain(*plan[:4], v, taps, norm, axis,
                                                                     rows=plan.rows), 5),
                        k3_ms=timer(lambda: K.lattice_apply(*plan[:4], v, taps, norm), 20),
                        rows_ms=timer(lambda: K.sharded_rows(plan.seg_ids, plan.weights, plan.n_lattice), 10))
            axis.timing = True
            axis.reset_stats()
            K.lattice_apply_sharded(*plan[:4], v, taps, norm, axis, rows=plan.rows)
            axis.timing = False
            k11b["bytes_per_collective"] = axis.stats["bytes"] / max(1, axis.stats["calls"])
            print(f"    K11b c=11 {k11b['ms']:.4f} ms (the first design, an atomic splat over all M rows: 0.772 ms, PERF.md section 6), plain "
                  f"{k11b['plain_ms']:.4f} ms, K3 on the same plan {k11b['k3_ms']:.4f} ms; its row lists (once a plan) "
                  f"{k11b['rows_ms']:.4f} ms; {k11b['bytes_per_collective']:.0f} bytes a collective "
                  f"({ktab.shape[0]} live rows of {plan.neighbors.shape[1]})")

            # The sharded chain, the engine's plan: on one rank its plan is the one-device untrimmed plan (its
            # run ends cut to the live rows) and its apply the one-device apply, bit for bit.
            cplan = build_plan_sharded(ref, dk.coeffs, dk.variance, axis)
            one = L.build_plan_chain(ref, dk.coeffs, dk.variance)
            cnl = int(one.n_lattice)
            p1_plan = all(torch.equal(getattr(cplan, f), getattr(one, f)) for f in KC.ChainPlan._fields if f != "cnt")
            p1_plan &= bool(torch.equal(cplan.cnt, one.cnt[:cnl]))
            p1_apply = True
            for transpose in (False, True):
                so, stab = L.apply_plan_chain(cplan, v, dk.coeffs, transpose, True, axis)
                oo, otab = L.apply_plan_chain(one, v, dk.coeffs, transpose, True)
                p1_apply &= bool(torch.equal(so, oo) and torch.equal(stab, otab[:cnl]))
            chain_p1 = sharded_chain_checks(cplan, v, dk, axis)
            chain_p1.update(one_device_ms=timer(lambda: L.apply_plan_chain(one, v, dk.coeffs), 20),
                            one_device_transposed_ms=timer(lambda: L.apply_plan_chain(one, v, dk.coeffs, True), 20),
                            plan_equal=p1_plan, apply_equal=p1_apply, k11b_ms=k11b["ms"],
                            build_ms=timer(lambda: build_plan_sharded(ref, dk.coeffs, dk.variance, axis), 5),
                            one_device_build_ms=timer(lambda: L.build_plan_chain(ref, dk.coeffs, dk.variance), 5))
            expect(chain_p1["equal"] and p1_plan and p1_apply,
                   f"sharded chain, one NCCL rank, c=11, forward and transposed: outputs and ({cnl}, 11) tables "
                   f"bit-equal to the plain version and to a second call: {chain_p1['equal']} (rel "
                   f"{chain_p1['rel']:.3e}); the plan torch.equal to the one-device untrimmed plan: {p1_plan}; the "
                   f"apply and its table torch.equal to the one-device chain apply: {p1_apply}")
            print(f"    sharded chain c=11 {chain_p1['ms']:.4f} ms (transposed {chain_p1['transposed_ms']:.4f}; "
                  f"with a synchronise around each collective {chain_p1['timed_ms']:.4f}, of which transport "
                  f"{chain_p1['transport_ms']:.4f}; {chain_p1['bytes_per_collective']:.0f} bytes a collective), "
                  f"plain {chain_p1['plain_ms']:.4f} ms, bound {chain_p1['bound_ms']:.5f} ms; one-device chain "
                  f"apply {chain_p1['one_device_ms']:.4f} ms (transposed {chain_p1['one_device_transposed_ms']:.4f}); "
                  f"K11b {k11b['ms']:.4f} ms; build {chain_p1['build_ms']:.3f} ms (one device "
                  f"{chain_p1['one_device_build_ms']:.3f})")
            del cplan, one

            s = params["outputscale"].reshape(()).contiguous()
            k = case["cfg"]["precond_rank"]
            diag = s * torch.ones(n, device=dev)
            pc_at = pivoted_cholesky_features(ref, diag, dk.nu, s, k, axis)
            pc = pivoted_cholesky_features(ref, diag, dk.nu, s, k)
            zz = torch.randn((n, 4), generator=torch.Generator(device=dev).manual_seed(9), device=dev)
            r_llt = rel(pc_at.L @ (pc_at.L.T @ zz), pc.L @ (pc.L.T @ zz))
            same = bool(torch.equal(pc_at.L, pc.L))
            expect(r_llt <= K6_LLT_REL, f"rank-{k} factor through K6' vs K6: L L^T z rel {r_llt:.3e} (limit "
                   f"{K6_LLT_REL}); bit-equal L: {same}")
            L0 = torch.zeros((n, k), device=dev)
            piv = torch.zeros(k, dtype=torch.int64, device=dev)
            dg, d0 = diag.clone(), diag.max()
            for j in range(k - 1):
                dg = pivot_column_plain(ref, L0, dg, torch.argmax(dg), j, s, d0, dk.nu, piv)
            p = torch.argmax(dg)
            row = (ref[p].clone(), L0[p].clone(), dg[p].reshape(1).clone())
            La, Lb = L0.clone(), L0.clone()
            pa, pb = piv.clone(), piv.clone()
            da = pivot_column(ref, La, dg, p, k - 1, s, d0, dk.nu, pa, row)
            db = pivot_column_plain(ref, Lb, dg, p, k - 1, s, d0, dk.nu, pb, row)
            r_step = max(rel(La[:, k - 1], Lb[:, k - 1]), rel(da, db))
            expect(r_step <= K6_STEP_REL, f"K6' single step j={k - 1}: rel {r_step:.3e} (limit {K6_STEP_REL})")
            k6 = dict(max_abs_err=float((La[:, k - 1] - Lb[:, k - 1]).abs().max()),
                      ms=timer(lambda: pivot_column(ref, La, dg, p, k - 1, s, d0, dk.nu, pa, row), 50),
                      plain_ms=timer(lambda: pivot_column_plain(ref, Lb, dg, p, k - 1, s, d0, dk.nu, pb, row), 20))
            print(f"    K6' {k6['ms']:.4f} ms, plain {k6['plain_ms']:.4f} ms")
        argv = case["scaling_argv"]
        print("parallel 7.4a: python -m simplex_gp_torch.scaling " + " ".join(argv) + ", one NCCL rank")
        scaling_nccl = scaling.records(axis, argv)
        for rec in scaling_nccl:
            print("    " + json.dumps(rec))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    rows["lattice_apply_sharded"] = dict(max_abs_err=k11b_err, ms=k11b["ms"], plain_ms=k11b["plain_ms"],
                                         **bound(*apply_cost(n, d, 11, nl, order)), library_ms=None,
                                         shape=f"n={n}, d={d}, c=11, n_lattice={nl}, P = 1 (NCCL)",
                                         k3_same_plan_ms=k11b["k3_ms"], rows_ms=k11b["rows_ms"],
                                         bytes_per_collective=k11b["bytes_per_collective"])
    # ref and L[:, :j], the diagonal and the pivot's rows in; L[:, j] and the diagonal out.
    rows["pivot_column_at"] = dict(**k6, **bound(4 * (n * d + n * (k - 1) + 3 * n + d + k),
                                                 n * (3 * d + 2 * (k - 1) + 12)),
                                   library_ms=None, shape=f"n={n}, dim={d}, k={k}, j={k - 1}, P = 1 (NCCL)")
    record.update(k11a=k11a, k11b_rel=r11b, k11b_bit_equal=k11b_equal, k11b_k3_rel=r_k3, k6_at_llt_rel=r_llt, k6_at_bit_equal=same,
                  k6_at_step_rel=r_step, scaling_nccl=scaling_nccl, sharded_chain_p1=chain_p1)

    t0 = time.perf_counter()
    row_p2, launches, rec_p2 = ranks_phase(dev, ds, expect, 2, "gloo")
    rows["lattice_apply_sharded"].update(gloo_p2_ms=row_p2["ranks_ms"], gloo_p2_timed_ms=row_p2["ranks_timed_ms"],
                                         gloo_p2_transport_ms=row_p2["ranks_transport_ms"])
    unblock = row_p2["chain"]["unblock"]
    rows["chain_unblock"] = dict(max_abs_err=0.0 if unblock["equal"] else float("nan"), ms=unblock["ms"],
                                 plain_ms=unblock["plain_ms"], bound_ms=unblock["bound_ms"],
                                 bound_by=unblock["bound_by"], library_ms=unblock["library_ms"],
                                 shape=f"{unblock['shape']} (elevators at P = 2, gloo rank 0)")
    for name, row in row_p2["k10_sharded"].items():  # rank 0's K10' times at P = 2
        rows[f"{name}_sharded"] = {k_: v_ for k_, v_ in row.items() if k_ != "bit_equal"}
    record.update(rec_p2, launch_wall_s=time.perf_counter() - t0)
    return rows, launches, record


def ranks_phase(dev, ds, expect, nprocs: int, backend: str):
    """Phase 7.3-7.5: ``nprocs`` ranks (gloo ranks sharing card 0, or NCCL ranks, one per card) against
    one process on card 0.  Returns (K11b's times on the ranks, launches summed over the ranks, the record)."""
    import torch

    from simplex_gp_torch.kernels import lattice as K
    from simplex_gp_torch.linalg.pivoted_cholesky import pivoted_cholesky_features
    from simplex_gp_torch.ops import lattice as L
    from simplex_gp_torch.parallel import launch

    case = parallel_case(ds, nprocs)
    model = parallel_model(case, dev)
    dk = model.dk
    x, y, z, v = (torch.from_numpy(case[k]).to(dev) for k in ("x", "y", "z", "v"))
    with torch.no_grad():
        ref = (x * model.constrained()["inv_ell"]).contiguous()
        plan = L.build_plan_join(ref, dk.coeffs, dk.variance)
        single = K.lattice_apply(*plan, v, list(dk.coeffs), L.SLICE_NORM(case["d"]))
        cplan = L.build_plan_chain(ref, dk.coeffs, dk.variance)
        chain_single = L.apply_plan_chain(cplan, v, dk.coeffs)
        chain_global = {f: getattr(cplan, f).cpu().numpy() for f in ("gather", "tapw", "n_lattice")}
        del cplan
    where = "sharing card 0" if backend == "gloo" else "one per card"
    print(f"parallel 7.3: {nprocs} {backend} ranks ({where}), {x.shape[0]} rows: the sharded filter, NLML and "
          f"gradients, one Adam step")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch(parallel_rank, nprocs, (case,), backend=backend, device="cuda", timeout=600)
    print(f"    transport: {ranks[0]['transport']}; the launch took {time.perf_counter() - t0:.1f} s (host clock)")
    out = torch.from_numpy(np.concatenate([r["filter"] for r in ranks])).to(dev)
    r_f = rel(out, single)
    nl = int(plan.n_lattice)
    expect(r_f <= PARALLEL_FILTER_REL and all(r["n_lattice"] == nl for r in ranks),
           f"sharded filter vs K3 on one process, c=11: rel {r_f:.3e} (limit {PARALLEL_FILTER_REL}); n_lattice "
           f"{[r['n_lattice'] for r in ranks]} (one process {nl})")
    r_cf = rel(torch.from_numpy(np.concatenate([r["chain_filter"] for r in ranks])).to(dev), chain_single)
    same_global = all(np.array_equal(r["chain_global"][f], chain_global[f]) for r in ranks for f in chain_global)
    expect(r_cf <= SHARDED_CHAIN_REL and same_global,
           f"sharded chain filter vs the one-process chain apply, c=11: rel {r_cf:.3e} (limit {SHARDED_CHAIN_REL}); "
           f"gather, tapw and n_lattice the same bits on every rank and in the one-process plan: {same_global}")
    chains = [r["chain"] for r in ranks]
    expect(all(ch["equal"] for ch in chains) and all(ch["unblock"]["equal"] for ch in chains if "unblock" in ch),
           f"sharded chain apply vs its plain version on each rank (c=11 in blocks of {-(-11 // nprocs)} columns), "
           f"forward and transposed, outputs and ({chains[0]['n_lattice']}, 11) tables, and a second call: "
           f"bit-equal {[ch['equal'] for ch in chains]} (rel {[float(ch['rel']) for ch in chains]}); "
           f"the unblock vs its twin and torch.cat {[ch.get('unblock', {}).get('equal') for ch in chains]}")
    for i, (r, ch) in enumerate(zip(ranks, chains)):
        print(f"    rank {i}: sharded chain apply c=11 {ch['ms']:.4f} ms (transposed {ch['transposed_ms']:.4f}; with a "
              f"synchronise around each collective {ch['timed_ms']:.4f}, of which transport "
              f"{ch['transport_ms']:.4f}; {ch['bytes_per_collective']:.0f} bytes a collective), plain "
              f"{ch['plain_ms']:.4f} ms, bound {ch['bound_ms']:.5f} ms; build {r['chain_build_ms']:.3f} ms")
        if "unblock" in ch:
            print(f"    rank {i}: chain_unblock {ch['unblock']['shape']} {ch['unblock']['ms']:.4f} ms, plain "
                  f"{ch['unblock']['plain_ms']:.4f} ms, torch.cat {ch['unblock']['library_ms']:.4f} ms, bound "
                  f"{ch['unblock']['bound_ms']:.5f} ms")
    r11b = [r["k11b_rel"] for r in ranks]
    expect(all(r["k11b_equal"] for r in ranks), f"K11b vs its plain version on each rank ({x.shape[0] // nprocs} "
           f"rows, c=11 in blocks of {-(-11 // nprocs)} columns), forward and transposed, outputs and tables, and a "
           f"second call: bit-equal {[r['k11b_equal'] for r in ranks]} (rel {', '.join(f'{r_:.3e}' for r_ in r11b)})")
    repeat = [r["step_repeat_bit_equal"] for r in ranks]
    expect(all(repeat), f"two runs of the data-parallel NLML step give bit-equal loss and raw gradients on each "
           f"rank: {repeat}")
    steps, pivs = [r["k6_step_rel"] for r in ranks], [r["k6_step_piv"] for r in ranks]
    expect(max(steps) <= K6_STEP_REL and sum(p_ >= 0 for p_ in pivs) == 1
           and all(r["k6_step_pivots_equal"] for r in ranks),
           f"K6' step j={case['cfg']['precond_rank'] - 1} vs its plain version on each rank: rel "
           f"{', '.join(f'{r_:.3e}' for r_ in steps)} (limit {K6_STEP_REL}); local pivot index {pivs} (one rank "
           f"holds it, the others pass -1)")
    with torch.no_grad():
        k = case["cfg"]["precond_rank"]
        s = model.constrained()["outputscale"].reshape(()).contiguous()
        pc = pivoted_cholesky_features(ref, s * torch.ones(x.shape[0], device=dev), dk.nu, s, k)
        L_ranks = torch.from_numpy(np.concatenate([r["factor_L"] for r in ranks])).to(dev)
        zz = torch.randn((x.shape[0], 4), generator=torch.Generator(device=dev).manual_seed(9), device=dev)
        r_llt = rel(L_ranks @ (L_ranks.T @ zz), pc.L @ (pc.L.T @ zz))
        same_L = bool(torch.equal(L_ranks, pc.L))
    expect(r_llt <= K6_LLT_REL, f"rank-{k} sharded factor (K6' on {nprocs} ranks) vs K6 on one process: L L^T z "
           f"rel {r_llt:.3e} (limit {K6_LLT_REL}); bit-equal L: {same_L}")
    stats = {}
    model.zero_grad(set_to_none=True)
    loss = model.nlml(x, y, probes=z, stats=stats)
    loss.backward()
    losses = [r["loss"] for r in ranks]
    dl = abs(losses[0] - float(loss.detach()))
    iters = [r["cg_iters"] for r in ranks]
    expect(len(set(losses)) == 1 and dl <= NLML_ATOL and len(set(iters)) == 1,
           f"NLML {losses} on the ranks vs {float(loss.detach()):.6f} on one process (|diff| {dl:.2e}, limit "
           f"{NLML_ATOL}); CG iterations {iters} (one process {stats['cg_iters']})")
    record = {}
    for name in RAW_NAMES:
        gb = getattr(model, name).grad.detach().cpu().numpy().astype(np.float64).ravel()
        ga = ranks[0]["grads"][name].astype(np.float64).ravel()
        same = all(np.array_equal(r["grads"][name], ranks[0]["grads"][name]) for r in ranks)
        c_, r_ = cosine(ga, gb), float(np.linalg.norm(ga - gb) / np.linalg.norm(gb))
        expect(c_ >= GRAD_COS and r_ <= GRAD_REL and same,
               f"d/d{name} on the ranks (bit-equal across ranks: {same}) vs one process: cos {c_:.6f} (limit "
               f"{GRAD_COS}), rel {r_:.2e} (limit {GRAD_REL})")
        record[f"grad_rel_{name}"] = r_
    equal = all(np.array_equal(r["params"][k], ranks[0]["params"][k]) for r in ranks for k in RAW_NAMES)
    expect(equal, "after one Adam step the raw parameters are bit-equal on every rank")
    launches = {name: sum(r["launches"][name] for r in ranks) for name in ranks[0]["launches"]}
    off = {name: sum(r["off_path_launches"][name] for r in ranks) for name in ranks[0]["off_path_launches"]}
    print(f"    launches on the data-parallel NLML step, all ranks: {launches}; off the path: {off}")
    expect(all(r["launches"][name] > 0 for r in ranks for name in launches) and not any(off.values()),
           f"every kernel of the path (the sharded chain's) launched on each rank; K11a, K11b and K3 never: {off}")
    launches.update(off)

    # K10': the sharded CG on K10's kernels.
    for i, r in enumerate(ranks):
        k10p = r["k10_sharded"]
        expect(all(v_["bit_equal"] for v_ in k10p.values()),
               f"rank {i}: K10' cg_step_x / cg_step_p / cg_init given the {nprocs} ranks' gathered partials vs "
               f"their plain twins from one state three iterations into the step's CG: bit-equal "
               f"{[v_['bit_equal'] for v_ in k10p.values()]}; ms " + ", ".join(
                   f"{nm} {v_['ms']:.4f} (plain {v_['plain_ms']:.4f}, bound {v_['bound_ms']:.5f})"
                   for nm, v_ in k10p.items()))
    st0 = ranks[0]["cg_state"]
    same_cg = all(r["cg_state"]["iterations"] == st0["iterations"] and r["cg_iters"] == ranks[0]["cg_iters"]
                  and r["cg_res"] == ranks[0]["cg_res"]
                  and all(np.array_equal(r["cg_state"][k_], st0[k_]) for k_ in ("residual", "alphas", "betas"))
                  for r in ranks)
    expect(same_cg, f"the sharded CG's iterations ({st0['iterations']}; the NLML step's {iters}), best residuals, "
           f"SLQ record and the step's mean residual are the same bits on every rank")
    per_it = [r["stages"]["cg_collectives_an_iteration"] for r in ranks]
    print(f"    the sharded CG's collectives: {[r['stages']['cg_collectives'] for r in ranks]} over "
          f"{[r['stages']['cg_iters_counted'] for r in ranks]} iterations, an iteration {per_it} (the MVMs' "
          f"{[r['stages']['cg_mvm_collectives'] for r in ranks]} apart)")
    expect(all(p_ == [3] for p_ in per_it), f"3 collectives an iteration of the sharded CG: {per_it}")

    # The J = 8 mixture, data-parallel against one process (one chain plan a component) on the same rows and probes.
    from simplex_gp_torch import convert

    mix = convert.mixture_model_from_jax(case["mixture_raw"], case["mixture_weights"], nu=1.5, order=1,
                                         min_noise=0.1, bbmm=model.bbmm, device=dev)
    mix_stats = {}
    mix_loss = mix.nlml(x, y, probes=z, stats=mix_stats)
    mix_loss.backward()
    m_losses = [r["mixture"]["loss"] for r in ranks]
    m_dl = abs(m_losses[0] - float(mix_loss.detach()))
    expect(len(set(m_losses)) == 1 and m_dl <= NLML_ATOL,
           f"J = 8 mixture NLML {m_losses} on the ranks (one sharded plan a component) vs "
           f"{float(mix_loss.detach()):.6f} on one process (|diff| {m_dl:.2e}, limit {NLML_ATOL}); CG "
           f"iterations {[r['mixture']['cg_iters'] for r in ranks]} (one process {mix_stats['cg_iters']})")
    for name in RAW_NAMES:
        gb = getattr(mix, name).grad.detach().cpu().numpy().astype(np.float64).ravel()
        ga = ranks[0]["mixture"]["grads"][name].astype(np.float64).ravel()
        same = all(np.array_equal(r["mixture"]["grads"][name], ranks[0]["mixture"]["grads"][name]) for r in ranks)
        c_, r_ = cosine(ga, gb), float(np.linalg.norm(ga - gb) / np.linalg.norm(gb))
        expect(c_ >= GRAD_COS and r_ <= GRAD_REL and same,
               f"mixture d/d{name} on the ranks (bit-equal across ranks: {same}) vs one process: cos {c_:.6f} "
               f"(limit {GRAD_COS}), rel {r_:.2e} (limit {GRAD_REL})")
        record[f"mixture_grad_rel_{name}"] = r_
    print(f"    mixture warm data-parallel step (ms, CUDA events): {[r['mixture']['warm_step_ms'] for r in ranks]}")
    for i, r in enumerate(ranks):
        print(f"    rank {i}: step stages (ms) " + json.dumps({k_: round(v_, 3) if isinstance(v_, float) else v_
                                                              for k_, v_ in r["stages"].items()})
              + f"; K11b apply at c=11 {r['apply_ms']:.3f} ms (CUDA events); with a synchronise around each "
              f"collective {r['apply_timed_ms']:.3f} ms, of which transport {r['apply_transport_ms']:.3f} ms; "
              f"{r['apply_bytes_per_collective']:.0f} bytes a collective of the apply, "
              f"{r['stages']['transport_bytes'] / max(1, r['stages']['collectives']):.0f} a collective of the step")
    print(f"parallel 7.4b: simplex_gp_torch.scaling over the {nprocs} {backend} ranks")
    for rec in ranks[0]["scaling"]:
        print("    " + json.dumps(rec))
    house = house_check(dev, case["house"], ranks, expect)
    record.update(ranks=nprocs, backend=backend, filter_rel=r_f, k11b_rel=r11b, step_repeat_bit_equal=repeat,
                  apply_bytes_per_collective=[r["apply_bytes_per_collective"] for r in ranks],
                  k6_step_rel=steps, k6_step_piv=pivs,
                  factor_llt_rel=r_llt, factor_bit_equal=same_L, nlml_diff=dl, losses=losses, cg_iters=iters,
                  cg_iters_single=stats["cg_iters"], params_equal=equal, launches=launches,
                  stages=[r["stages"] for r in ranks], scaling=ranks[0]["scaling"],
                  k10_sharded=[r["k10_sharded"] for r in ranks], cg_state_equal=same_cg,
                  mixture=dict(losses=m_losses, nlml_diff=m_dl, cg_iters=[r["mixture"]["cg_iters"] for r in ranks],
                               cg_iters_single=mix_stats["cg_iters"],
                               warm_step_ms=[r["mixture"]["warm_step_ms"] for r in ranks]),
                  chain_filter_rel=r_cf, chain_global_equal=same_global, sharded_chain=chains,
                  chain_build_ms=[r["chain_build_ms"] for r in ranks], house=house)
    return (dict(ranks_ms=[r["apply_ms"] for r in ranks], ranks_timed_ms=[r["apply_timed_ms"] for r in ranks],
                 ranks_transport_ms=[r["apply_transport_ms"] for r in ranks], k10_sharded=ranks[0]["k10_sharded"],
                 chain=chains[0]),
            launches, record)


def house_check(dev, hcase, ranks, expect) -> dict:
    """Phase 7.5: the houseelectric stand-in's data-parallel NLML and raw gradients on the ranks against one
    process on the untrimmed chain with the same rows, probes, parameters and CG iterations, under phase 6's
    gates: NLML_ATOL, and the whole raw gradient's cosine (GRAD_COS) with each group's error against the whole
    gradient's norm (GRAD_REL); the same bits on every rank; K11a and K11b never launched."""
    import torch

    import simplex_gp_torch
    from simplex_gp_torch.linalg import mll

    golden = np.load(HOUSE_GOLDEN)
    n, d = hcase["x"].shape
    print(f"parallel 7.5: houseelectric stand-in, {n} rows over the {len(ranks)} ranks vs one process (untrimmed "
          f"chain, the golden file's probes and median init, {hcase['cfg']['max_cg_iterations']} CG iterations)")
    model = simplex_gp_torch.SimplexGP(num_dims=d, kernel="matern", nu=1.5, order=1, min_noise=0.1,
                                       bbmm=mll.BBMMConfig(**hcase["cfg"]), device=dev)
    model.load_raw(hcase["raw"])
    x, y, z = (torch.from_numpy(hcase[k]).to(dev) for k in ("x", "y", "z"))
    stats = {}
    loss = model.nlml(x, y, probes=z, stats=stats)
    loss.backward()
    hs = [r["house"] for r in ranks]
    losses = [h["loss"] for h in hs]
    dl = abs(losses[0] - float(loss.detach()))
    same = len(set(losses)) == 1 and all(np.array_equal(h["grads"][k], hs[0]["grads"][k]) for h in hs for k in RAW_NAMES)
    expect(dl <= NLML_ATOL and same and all(h["cg_iters"] == stats["cg_iters"] for h in hs),
           f"NLML {losses} on the ranks vs {float(loss.detach()):.6f} on one process (|diff| {dl:.2e}, limit "
           f"{NLML_ATOL}; JAX's golden {float(golden['loss_fixed']):.6f}); CG iterations "
           f"{[h['cg_iters'] for h in hs]} (one process {stats['cg_iters']}); loss and gradients the same bits on "
           f"every rank: {same}")
    ga = {k: hs[0]["grads"][k].astype(np.float64).ravel() for k in RAW_NAMES}
    gb = {k: getattr(model, k).grad.detach().cpu().numpy().astype(np.float64).ravel() for k in RAW_NAMES}
    whole_a, whole_b = (np.concatenate([g_[k] for k in RAW_NAMES]) for g_ in (ga, gb))
    c_ = cosine(whole_a, whole_b)
    worst = max(float(np.linalg.norm(ga[k] - gb[k]) / np.linalg.norm(whole_b)) for k in RAW_NAMES)
    expect(c_ >= GRAD_COS and worst <= GRAD_REL,
           f"raw gradient on the ranks vs one process: cos {c_:.6f} (limit {GRAD_COS}); worst group error "
           f"{worst:.2e} of the whole gradient's norm (limit {GRAD_REL})")
    off = [h["off_path_launches"] for h in hs]
    expect(all(v_ > 0 for h in hs for v_ in h["launches"].values()) and not any(v_ for o in off for v_ in o.values()),
           f"the step's launches on each rank {[h['launches'] for h in hs]}; K11a and K11b never: {off}")
    print(f"    warm data-parallel step (ms, CUDA events, each rank): {[h['step_ms'] for h in hs]}")
    return dict(rows=n, losses=losses, nlml_diff=dl, grad_cos=c_, grad_worst_of_whole=worst, cg_iters=stats["cg_iters"],
                step_ms=[h["step_ms"] for h in hs], launches=[h["launches"] for h in hs])


@contextlib.contextmanager
def k12_engine():
    """The mixture engine on K12's stacked route, held beside its J chain plans on the same inputs: the NLML's
    plan build returns the stacked MixturePlan, which apply_plan_any and filter_backward take by K12, K12
    transposed and the stacked K5."""
    from simplex_gp_torch.linalg import mll
    from simplex_gp_torch.ops import filter as F

    real = mll.build_plan_any
    mll.build_plan_any = lambda ref, dk, capacity=None, axis=None: F.build_wide_plan_any(ref, dk)
    try:
        yield
    finally:
        mll.build_plan_any = real


def mixture_phase(dev, ds, expect, timer):
    """Phase 8: the Gaussian-mixture kernel path at elevators (J = 8).  Returns (K12's row, launches, record)."""
    import dataclasses
    import tempfile

    import torch

    import simplex_gp_torch
    from simplex_gp_torch import convert, mvm_err
    from simplex_gp_torch import train as trainer
    from simplex_gp_torch.kernels import chain as KC
    from simplex_gp_torch.kernels import lattice as K
    from simplex_gp_torch.kernels import mixture as KM
    from simplex_gp_torch.kernels.pivot import pivot_column
    from simplex_gp_torch.linalg import mll
    from simplex_gp_torch.linalg.cg import cg_solve
    from simplex_gp_torch.linalg.lanczos import logdet_from_cg_tridiag
    from simplex_gp_torch.linalg.pivoted_cholesky import precond_solve, precond_sqrt
    from simplex_gp_torch.ops import filter as F
    from simplex_gp_torch.ops import lattice as L

    golden = np.load(MIXTURE_GOLDEN)
    x = torch.from_numpy(ds.train_x).to(dev)
    y = torch.from_numpy(ds.train_y).to(dev)
    xt = torch.from_numpy(ds.test_x).to(dev)
    n, d = x.shape
    cfg = mll.BBMMConfig(cg_tolerance=1.0, max_cg_iterations=500, max_lanczos_iterations=100, precond_rank=100,
                         num_probes=10, slq_mode="cg", grad_mode="exact")
    kw = dict(nu=1.5, order=1, min_noise=0.1, bbmm=cfg, eval_cg_tolerance=0.01, device=dev)
    init = {k: golden[f"init_{k}"] for k in RAW_NAMES}
    model = convert.mixture_model_from_jax(init, golden["weights"], **kw)
    dk = model.dk
    J = len(dk.alphas)
    expect(dk.alphas == tuple(float(a) for a in golden["alphas"]) and J == 8,
           f"the J = {J} alphas equal JAX's, bit for bit")
    taps, norm, order = list(dk.base.coeffs), L.SLICE_NORM(d), dk.order
    E = torch.from_numpy(L.build_rotation(d, dk.base.variance)).to(dev)

    def probes(seed):
        z = np.random.default_rng(int(seed)).choice([-1.0, 1.0], size=(n, cfg.num_probes))
        return torch.from_numpy(z.astype(np.float32)).to(dev)

    def k3_loop(plan, v):
        """The J-fold K3 loop on the same component plans: JAX's apply_plan_any, one apply per component."""
        out = None
        for j, w in enumerate(dk.weights):
            term = w * K.lattice_apply(*L.mixture_component(plan, j), v, taps, norm)
            out = term if out is None else out + term
        return out

    record, row = {}, {}
    print("mixture 8.1: K12 lattice_mixture_apply vs plain (median init, JAX's weights, c = 1, 11 and 100)")
    with torch.no_grad():
        ref = (x * model.constrained()["inv_ell"]).contiguous()
        plan = L.build_plan_mixture(ref, dk.alphas, dk.base.coeffs, dk.base.variance)
        live = plan.live.tolist()
        M = plan.neighbors.shape[1] // J
        print(f"    J = {J}, M = {M} rows a component, live rows {live} ({sum(live)} of {J * M}); row lists: "
              f"{int(plan.rows.n_mid)} mid rows, {int(plan.rows.n_long)} long rows in {int(plan.rows.n_pieces)} "
              f"pieces")
        expect(len(set(live)) > 1 and max(live) <= M, "the components' live counts differ, each within M")
        rows_plain = KM.mixture_rows_plain(plan.seg_ids, plan.weights, plan.neighbors)
        rows_equal = all(torch.equal(a_, b_) for a_, b_ in zip(plan.rows, rows_plain))
        expect(rows_equal, "the stacked plan's row lists (mixture_rows) bit-equal to their plain build")
        rows_ms = timer(lambda: KM.mixture_rows(plan.seg_ids, plan.weights, plan.neighbors, plan.live), 20)
        gen = torch.Generator(device=dev).manual_seed(8)
        args = (plan.seg_ids, plan.weights, plan.neighbors)
        rows_read = plan.seg_ids.reshape(-1).long()
        err, ms, graph, plain_ms, loop_ms, tables, bounds = 0.0, {}, {}, {}, {}, {}, {}
        for c in (1, 11, 100):
            v = torch.randn((n, c), generator=gen, device=dev)
            g = torch.randn((n, c), generator=gen, device=dev)
            for u, tr in ((v, False), (g, True)):
                k_out, k_tab = KM.lattice_mixture_apply(*args, plan.live, u, taps, norm, dk.weights, tr, True,
                                                        plan.rows)
                p_out, p_tab = KM.mixture_apply_plain(*args, u, taps, norm, dk.weights, tr, True, plan.rows)
                again = KM.lattice_mixture_apply(*args, plan.live, u, taps, norm, dk.weights, tr, False, plan.rows)
                equal = bool(torch.equal(k_out, p_out) and torch.equal(k_tab[rows_read], p_tab[rows_read]))
                err = max(err, float((k_out - p_out).abs().max()))
                expect(equal and torch.equal(again, k_out),
                       f"c={c}{' transposed' if tr else ''}: output and table == plain bit for bit ({equal}; rel "
                       f"{rel(k_out, p_out):.3e}), a second apply bit-equal {torch.equal(again, k_out)}")
                tables[(c, tr)] = k_tab
                del p_out, p_tab
            r_loop = rel(KM.lattice_mixture_apply(*args, plan.live, v, taps, norm, dk.weights, rows=plan.rows),
                         k3_loop(plan, v))
            expect(r_loop <= K3_REL, f"c={c}: K12 vs the J-fold K3 loop on the same plans rel {r_loop:.3e} "
                   f"(limit {K3_REL})")
            ms[c] = timer(lambda: KM.lattice_mixture_apply(*args, plan.live, v, taps, norm, dk.weights,
                                                           rows=plan.rows), 20)
            graph[c] = graph_ms(lambda: KM.lattice_mixture_apply(*args, plan.live, v, taps, norm, dk.weights,
                                                                 rows=plan.rows), 10)
            plain_ms[c] = timer(lambda: KM.mixture_apply_plain(*args, v, taps, norm, dk.weights, rows=plan.rows), 3)
            loop_ms[c] = timer(lambda: k3_loop(plan, v), 10)
            nbytes, ops = 0, 0
            for nl_j in live:  # Sum over the components of K3's cost on each plan (apply_cost)
                b_j, o_j = apply_cost(n, d, c, nl_j, order)
                nbytes, ops = nbytes + b_j, ops + o_j
            bounds[c] = bound(nbytes, ops)
            print(f"    c={c}: K12 {ms[c]:.4f} ms (graph {graph[c]:.4f}), plain {plain_ms[c]:.4f} ms, the J-fold K3 "
                  f"loop {loop_ms[c]:.4f} ms; bound {bounds[c]['bound_ms']:.4f} ms ({bounds[c]['bound_by']})")
        print(f"    the row lists (mixture_rows, once a plan): {rows_ms:.4f} ms")
        for key in [k_ for k_ in tables if k_[0] == 100]:
            del tables[key]
        v1 = torch.from_numpy(np.random.default_rng(int(golden["mvm_seed"])).normal(size=(n, 1)).astype(np.float32))
        r_jax = rel(F.apply_plan_any(plan, v1.to(dev), dk).cpu(), torch.from_numpy(golden["mvm_out"]))
        expect(r_jax <= LARGE_N_REL, f"K12 vs JAX's lattice_filter_any (CPU golden), c=1: rel {r_jax:.3e} "
               f"(limit {LARGE_N_REL}, the chain-vs-join bound)")
        row = dict(max_abs_err=err, ms=ms[1], plain_ms=plain_ms[1], **bounds[1], library_ms=None,
                   shape=f"n={n}, d={d}, J={J}, c=1, live rows {sum(live)}", ms_by_c=ms, graph_ms_by_c=graph,
                   plain_ms_by_c=plain_ms, k3_loop_ms_by_c=loop_ms,
                   bound_ms_by_c={c: b["bound_ms"] for c, b in bounds.items()}, row_build_ms=rows_ms)
        record.update(k12_jax_rel=r_jax, live=live, rows_bit_equal=rows_equal)

        print("mixture 8.2: the mixture position gradient (K5 on the stacked problem) vs plain (c = 11)")
        gen = torch.Generator(device=dev).manual_seed(8)
        v, g = (torch.randn((n, 11), generator=gen, device=dev) for _ in range(2))
        tf, tb = tables[(11, False)], tables[(11, True)]
        before = K.lattice_filter_grad.launches
        gr_k = F.mixture_position_grad(plan, ref, dk, v, g, tf, tb)
        expect(K.lattice_filter_grad.launches == before + 1, "one K5 launch covers the J components")
        stacked = K.lattice_filter_grad_plain(L.mixture_positions(ref, dk.alphas), E, plan.seg_ids.reshape(J * n, d + 1),
                                              v.repeat(J, 1), g.repeat(J, 1), tf, tb, norm).reshape(J, n, d)
        gr_p = sum(w * a * stacked[j] for j, (w, a) in enumerate(zip(dk.weights, dk.alphas)))
        r5 = rel(gr_k, gr_p)
        expect(bool(torch.isfinite(gr_k).all()) and r5 <= K5_REL,
               f"stacked K5 vs plain on the same tables: rel {r5:.3e} (limit {K5_REL})")
        stacked_k = K.lattice_filter_grad(L.mixture_positions(ref, dk.alphas), E, plan.seg_ids.reshape(J * n, d + 1),
                                          v.repeat(J, 1), g.repeat(J, 1), tf, tb, norm).reshape(J, n, d)
        expect(torch.equal(stacked_k, stacked), "the stacked K5 alone bit-equal to its plain twin")
        grad_ms = (timer(lambda: F.mixture_position_grad(plan, ref, dk, v, g, tf, tb), 20),
                   timer(lambda: K.lattice_filter_grad_plain(L.mixture_positions(ref, dk.alphas), E,
                                                             plan.seg_ids.reshape(J * n, d + 1), v.repeat(J, 1),
                                                             g.repeat(J, 1), tf, tb, norm), 5))
        print(f"    mixture position gradient {grad_ms[0]:.4f} ms (stacked K5), plain K5 {grad_ms[1]:.4f} ms")
        record.update(grad_rel=r5, grad_ms=grad_ms[0], grad_plain_ms=grad_ms[1])

        print("mixture 8.3: the port's subset fit vs JAX's weights, through the operator")
        fitted = convert.mixture_model_from_jax(init, golden["weights"], **kw).with_fitted_mixture(x)
        probe = torch.randn((n, 2), generator=gen, device=dev)
        r_fit = rel(F.apply_plan_any(plan, probe, fitted.dk), F.apply_plan_any(plan, probe, dk))
        print(f"    weights: port {np.round(fitted.mix_weights, 5).tolist()}, JAX "
              f"{np.round(golden['weights'], 5).tolist()}")
        expect(r_fit <= MIX_FIT_REL, f"K_mix(port's weights) vs K_mix(JAX's) on a probe: rel {r_fit:.3e} "
               f"(limit {MIX_FIT_REL})")
        record.update(fit_op_rel=r_fit, port_weights=list(fitted.mix_weights))

    print("mixture 8.4: NLML and raw gradients vs JAX on the CPU (median init, JAX's weights, same probes)")
    model.zero_grad(set_to_none=True)
    stats = {}
    loss = model.nlml(x, y, probes=probes(golden["seed_init"]), stats=stats)
    loss.backward()
    dl = abs(float(loss.detach()) - float(golden["loss_init"]))
    expect(dl <= NLML_ATOL, f"NLML {float(loss.detach()):.6f} vs JAX {float(golden['loss_init']):.6f} "
           f"(|diff| {dl:.2e}, limit {NLML_ATOL}); CG iterations {stats['cg_iters']}")
    for k in RAW_NAMES:
        a = getattr(model, k).grad.detach().cpu().numpy().astype(np.float64).ravel()
        b = golden[f"grad_init_{k}"].astype(np.float64).ravel()
        c, r = cosine(a, b), float(np.linalg.norm(a - b) / np.linalg.norm(b))
        expect(c >= GRAD_COS and r <= GRAD_REL, f"d/d{k} cos {c:.6f} (limit {GRAD_COS}), rel {r:.2e} "
               f"(limit {GRAD_REL})")
        record[f"grad_rel_{k}"] = r
    record["nlml_diff"] = dl
    first = [loss.detach().clone()] + [getattr(model, k).grad.detach().clone() for k in RAW_NAMES]
    model.zero_grad(set_to_none=True)
    with k12_engine():
        k12_stats = {}
        k12_loss = model.nlml(x, y, probes=probes(golden["seed_init"]), stats=k12_stats)
        k12_loss.backward()
    k12_grads = {k: getattr(model, k).grad.detach().cpu().numpy().astype(np.float64).ravel() for k in RAW_NAMES}
    routes = dict(nlml_chain=float(first[0]), nlml_k12=float(k12_loss.detach()),
                  nlml_diff=abs(float(first[0]) - float(k12_loss.detach())), cg_iters_chain=stats["cg_iters"],
                  cg_iters_k12=k12_stats["cg_iters"],
                  grad_rel={k: float(np.linalg.norm(g_.cpu().numpy().astype(np.float64).ravel() - k12_grads[k])
                                     / np.linalg.norm(k12_grads[k])) for k, g_ in zip(RAW_NAMES, first[1:])})
    print(f"    K12's stacked route on the same inputs: NLML {routes['nlml_k12']:.6f} (|diff| from the chain route "
          f"{routes['nlml_diff']:.2e}), CG iterations {routes['cg_iters_k12']}; raw gradients rel "
          + ", ".join(f"{k} {v:.2e}" for k, v in routes["grad_rel"].items()))
    record["routes"] = routes
    del k12_loss
    model.zero_grad(set_to_none=True)
    loss = model.nlml(x, y, probes=probes(golden["seed_init"]))
    loss.backward()
    second = [loss.detach()] + [getattr(model, k).grad.detach() for k in RAW_NAMES]
    repeats = all(torch.equal(a_, b_) for a_, b_ in zip(first, second))
    expect(repeats, f"the mixture NLML and its raw gradients twice: bit-equal {repeats}")
    record["nlml_and_gradients_repeat"] = repeats

    print("mixture 8.5: three Adam steps (fit_adam, lr 0.1) vs the JAX trajectory")
    steps = iter([probes(golden["seed_adam"] + e) for e in range(3)])
    hist = simplex_gp_torch.fit_adam(lambda _gen: model.nlml(x, y, probes=next(steps)), model.parameters(), epochs=3,
                                     lr=0.1)
    dl = float(np.abs(np.array(hist["loss"]) - golden["adam_loss"]).max())
    expect(dl <= ADAM_LOSS_ATOL, f"Adam losses {hist['loss']} vs JAX {golden['adam_loss'].tolist()} "
           f"(max |diff| {dl:.2e}, limit {ADAM_LOSS_ATOL})")
    dp = max(float(np.abs(getattr(model, k).detach().cpu().numpy() - golden[f"adam_{k}"][-1]).max())
             for k in RAW_NAMES)
    expect(dp <= ADAM_PARAM_ATOL, f"raw parameters after 3 steps: max |diff| {dp:.2e} (limit {ADAM_PARAM_ATOL})")
    record.update(adam_loss_diff=dl, adam_param_diff=dp, adam_step_ms=hist["step_ms"])

    print("mixture 8.6: one warm step and its stages")
    model.load_raw(convert.raw_params_from_numpy(init, device=dev))
    opt = torch.optim.Adam(model.parameters(), lr=0.1)
    z = probes(golden["seed_init"])
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    opt.zero_grad(set_to_none=True)
    with torch.no_grad():  # the forward's stages, one by one, as mll._solve_system runs them
        ev[0].record()
        params = model.constrained()
        ref = x * params["inv_ell"]
        splan = F.build_plan_any(ref, dk)
        ev[1].record()
        P = mll.build_precond(dk, cfg, params, ref, n)
        ev[2].record()
        s, noise = params["outputscale"], params["noise"]
        res = cg_solve(lambda V: s * F.apply_plan_any(splan, V, dk) + noise * V,
                       torch.cat([(y - params["mean"])[:, None], precond_sqrt(P, z)], dim=-1),
                       tol=cfg.cg_tolerance, max_iters=cfg.max_cg_iterations, precond=lambda V: precond_solve(P, V),
                       tridiag_m=100)
        ev[3].record()
        logdet_from_cg_tridiag(res.alphas[:, 1:], res.betas[:, 1:], res.tmask[:, 1:], (z * z).sum(0))
        ev[4].record()
    loss = model.nlml(x, y, probes=z)
    ev[5].record()
    loss.backward()
    ev[6].record()
    torch.cuda.synchronize()
    stages = {nm: ev[i].elapsed_time(ev[i + 1])
              for i, nm in enumerate(("plan", "preconditioner", "cg", "slq", "forward", "backward"))}
    stages["cg_iters"] = res.iterations
    # The CG's MVM at c = 11 on the J chain plans and on K12's stacked plan of the same positions, graph-replayed.
    with torch.no_grad():
        kplan = L.build_plan_mixture(ref, dk.alphas, dk.base.coeffs, dk.base.variance)
        v11 = res.x.contiguous()
        mvm = dict(chain_ms=graph_ms(lambda: F.apply_plan_any(splan, v11, dk), 10),
                   k12_ms=graph_ms(lambda: F.apply_plan_any(kplan, v11, dk), 10))
        r_mvm = rel(F.apply_plan_any(splan, v11, dk), F.apply_plan_any(kplan, v11, dk))
        del kplan
    expect(r_mvm <= LARGE_N_REL, f"the CG's MVM (c = 11) on the J chain plans vs K12's stacked plan: rel "
           f"{r_mvm:.3e} (limit {LARGE_N_REL}, the chain-vs-join bound)")
    chain_path = (K.lattice_geometry, *chain_kernels(), KC.chain_axes_transpose, K.lattice_filter_grad, pivot_column)
    off_path = (K.lattice_dedup_neighbors, K.join_rows, KM.lattice_mixture_apply)
    for fn in (*chain_path, *off_path):
        fn.launches = 0
    warm = timer(lambda: train_step(model, opt, x, y, z), 5)
    step_launches = {fn.__name__: fn.launches / 6 for fn in (*chain_path, *off_path)}  # warm-up + 5 timed steps
    expect(all(step_launches[fn.__name__] > 0 for fn in chain_path)
           and not any(step_launches[fn.__name__] for fn in off_path),
           f"the mixture step's launches: the chain's kernels on its J plans, no K2, join rows or K12: "
           f"{step_launches}")
    with k12_engine():
        warm_k12 = timer(lambda: train_step(model, opt, x, y, z), 5)
    warm_again = timer(lambda: train_step(model, opt, x, y, z), 5)
    print(f"    warm mixture training step {warm:.2f} ms, again {warm_again:.2f} ms (CUDA events); on K12's stacked "
          f"route {warm_k12:.2f} ms; the CG's MVM at c = 11 graph-replayed {mvm['chain_ms']:.4f} ms on the J chain "
          f"plans, {mvm['k12_ms']:.4f} ms by K12 (rel {r_mvm:.3e}); launches a step {step_launches}; stages (ms): "
          + json.dumps({k: round(v, 3) for k, v in stages.items()}))
    record.update(step_ms=warm, step_ms_again=warm_again, step_ms_k12=warm_k12, mvm_c11=mvm, mvm_route_rel=r_mvm,
                  stages=stages, step_launches=step_launches)
    path = (*chain_path, *off_path)

    print("mixture 8.7: posterior_cache + predict_from_cache (model_best.pkl, JAX's weights refit there)")
    best = {k: golden[f"best_{k}"] for k in RAW_NAMES}
    smodel = convert.mixture_model_from_jax(best, golden["serve_weights"], **kw)
    smodel.predict_from_cache(smodel.posterior_cache(x, y, generator=torch.Generator(device=dev)), x, xt)  # warm
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    cache = smodel.posterior_cache(x, y, generator=torch.Generator(device=dev).manual_seed(0))
    ev[1].record()
    mean, var = smodel.predict_from_cache(cache, x, xt)
    ev[2].record()
    torch.cuda.synchronize()
    cache_ms, predict_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    mean_np, var_np = mean.cpu().numpy(), var.cpu().numpy()
    err_ = mean_np - ds.test_y
    rmse = float(np.sqrt((err_**2).mean()))
    nll = float(0.5 * (np.log(2 * np.pi * var_np) + err_**2 / var_np).mean())
    mean_j, _ = smodel.predict_from_cache(dict(cache, alpha=torch.from_numpy(golden["alpha"]).to(dev)), x, xt)
    dpred = float(np.abs(mean_j.cpu().numpy() - golden["mean"]).max())
    mean_rms = float(np.sqrt(((mean_np - golden["mean"]) ** 2).mean()))
    print(f"    posterior_cache {cache_ms:.1f} ms, predict_from_cache {predict_ms:.1f} ms (CUDA events); CG "
          f"iterations {cache['cg_iters']} (JAX {int(golden['cg_iters'])}), residual {float(cache['cg_res']):.3e} "
          f"(JAX {float(golden['cg_res']):.3e})")
    expect(bool(np.isfinite(mean_np).all() and np.isfinite(var_np).all() and (var_np > 0).all())
           and mean_np.shape == ds.test_y.shape, "finite mean and positive variance, one per test row")
    expect(abs(rmse - float(golden["rmse"])) <= RMSE_ATOL,
           f"test RMSE {rmse:.4f} vs JAX {float(golden['rmse']):.4f} (limit {RMSE_ATOL})")
    expect(abs(nll - float(golden["nll"])) <= NLL_ATOL,
           f"test NLL {nll:.4f} vs JAX {float(golden['nll']):.4f} (limit {NLL_ATOL})")
    expect(dpred <= PREDICT_MEAN_ATOL, f"predict_from_cache with JAX's alpha vs JAX mean, row by row: max |diff| "
           f"{dpred:.3e} (limit {PREDICT_MEAN_ATOL})")
    expect(mean_rms <= MEAN_RMS_ATOL, f"mean vs JAX row by row: rms diff {mean_rms:.3e} (limit {MEAN_RMS_ATOL})")
    record.update(posterior_cache_ms=cache_ms, predict_ms=predict_ms, cg_iters=cache["cg_iters"],
                  cg_res=float(cache["cg_res"]), rmse=rmse, nll=nll, mean_rms_diff=mean_rms, predict_max_abs_diff=dpred)

    print("mixture 8.8: python -m simplex_gp_torch.train --kernel mixture, two epochs and one eval at elevators")
    for fn in path:
        fn.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        summary = trainer.main(["--dataset", "elevators", "--kernel", "mixture", "--mix-components", "8", "--nu",
                                "1.5", "--order", "1", "--min-noise", "0.1", "--ls-init", "median", "--cg-tol", "1.0",
                                "--epochs", "2", "--log-int", "2", "--out", tmp, "--device", dev.type])
    launches = {fn.__name__: fn.launches for fn in path}
    print(f"    launches on the trainer run: {launches}")
    expect(all(v > 0 for v in launches.values()), "every kernel of the mixture path launched on the trainer run")
    losses, final = [-r["train/mll"] for r in summary["records"]], summary["final"]
    expect(all(np.isfinite(losses)) and np.isfinite(final["test/nll"]) and final["test/rmse"] < ENTRY_RMSE_MAX,
           f"trainer: losses {losses}, test RMSE {final['test/rmse']:.4f} (limit {ENTRY_RMSE_MAX}), NLL "
           f"{final['test/nll']:.4f}")
    record.update(trainer=summary, trainer_launches=launches)

    print("mixture 8.9: python -m simplex_gp_torch.mvm_err --kernel mixture at elevators")
    m = mvm_err.main(["--dataset", "elevators", "--kernel", "mixture", "--order", "1", "--device", dev.type])
    for key in ("rel_err", "cos_err"):
        diff = abs(m[key] - float(golden[f"mvm_{key}"]))
        expect(diff <= MVM_ERR_ATOL, f"elevators mixture {key} {m[key]:.6f} vs JAX {float(golden[f'mvm_{key}']):.6f} "
               f"(|diff| {diff:.2e}, limit {MVM_ERR_ATOL})")
    record.update(mvm_err=m)
    return row, launches["lattice_mixture_apply"], record


class Stages:
    """Device time by stage name, from CUDA event pairs summed after one synchronize."""

    def __init__(self):
        self.pairs = []

    def __call__(self, name: str, fn):
        import torch

        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        self.pairs.append((name, start, end))
        return out

    def totals(self) -> dict:
        import torch

        torch.cuda.synchronize()
        out = {}
        for name, start, end in self.pairs:
            out[name] = out.get(name, 0.0) + start.elapsed_time(end)
        return out


def k13_cost(name: str, m: int, g: int, r: int, k: int) -> tuple:
    """(bytes, ops) of one K13 call on m rows: each input read once, each output written once; the
    multiply-adds of the Khatri-Rao contractions (2 m r^2 k) and of the products beside them."""
    return {
        "ski_interp": (4 * (m + g * r + m * r), 8 * m * r + 30 * m),
        "ski_interp_backward": (4 * (m + m * r + g * r), 8 * m * r + 30 * m),
        "ski_kr_matmul": (4 * (2 * m * r + r * r * k + m * k), 2 * m * r * r * k + 2 * m * r * k),
        "ski_kr_gram": (4 * (m * k + 2 * m * r + k * r * r), 2 * m * k * r * r + m * r * r),
        "ski_kr_adjoint": (4 * (2 * m * r + r * r * k + m * k + 2 * m * r), 2 * m * k * r * r + 4 * m * r * r),
    }[name]


def materialised_hadamard_step(R, F, omega):
    """JAX's Hadamard step as written (ski.py:114-123): M = R (.) F formed as (n, r^2), under autograd."""
    import torch

    from simplex_gp_torch.models.ski import fix_signs

    n, r = R.shape
    M = (R[:, :, None] * F[:, None, :]).reshape(n, -1)
    Q = fix_signs(torch.linalg.qr(M @ omega)[0])
    Ub, sb, _ = torch.linalg.svd(Q.T @ M, full_matrices=False)
    return (Q @ fix_signs(Ub[:, :r])) * sb[:r][None, :]


def baselines_phase(dev, expect, timer):
    """Phase 9: SKIP, SGPR and the exact GP at precipitation.  Returns (K13's rows, their launches, record)."""
    import tempfile

    import torch

    from simplex_gp_torch import convert, train_exact, train_sgpr, train_skip
    from simplex_gp_torch.kernels import ski as KS
    from simplex_gp_torch.models import ski as MS
    from simplex_gp_torch.utils import data

    golden = np.load(PRECIP_GOLDEN)
    full = data.load_dataset("precipitation")
    n, g, r = 65536, 100, 64
    x = torch.from_numpy(full.train_x[:n]).to(dev)
    y = torch.from_numpy(full.train_y[:n]).to(dev)
    xt = torch.from_numpy(full.test_x).to(dev)
    kw = dict(kernel="matern", nu=1.5, min_noise=0.1, device=dev)
    skw = dict(grid_size=g, rank=r, omegas=[golden["omega_1"], golden["omega_2"]], **kw)
    init = {k: golden[f"skip_init_{k}"] for k in RAW_NAMES}
    best = convert.load_jax_params(R5_RUNS / "skip_precipitation_s0" / "model_best.pkl")
    k13 = (KS.ski_interp, KS.ski_interp_backward, KS.ski_kr_matmul, KS.ski_kr_gram, KS.ski_kr_adjoint)
    print(f"precipitation: {full.train_x.shape[0]} training rows ({n} as --max-n), {xt.shape[0]} test rows, d = 3; "
          f"SKIP g = {g}, r = {r}; SGPR m = 512")
    record, rows = {}, {}

    print("baselines 9.1: K13 vs plain (SKIP's first Hadamard step at the median init; the train and joint roots)")
    model = convert.skip_model_from_jax(init, **skw)
    gen = torch.Generator(device=dev).manual_seed(9)
    for tag, xs in (("train", x), ("joint", torch.cat([x, xt]))):
        m = xs.shape[0]
        with torch.no_grad():
            (m0, s0, U0), (m1, s1, U1) = model.grid_factors(model.constrained(), xs, r)[:2]
            x0, x1 = xs[:, 0].contiguous(), xs[:, 1].contiguous()
            R, F = KS.ski_interp(x0, m0, s0, U0), KS.ski_interp(x1, m1, s1, U1)
            W = model.omega(1, r, dev)
            Q = torch.linalg.qr(KS.ski_kr_matmul(R, F, W))[0].contiguous()
            dF, G = (torch.randn((m, r), generator=gen, device=dev) for _ in range(2))
            cases = {
                "ski_interp": (lambda: KS.ski_interp(x1, m1, s1, U1), lambda: KS.interp_plain(x1, m1, s1, U1),
                               None),
                "ski_interp_backward": (lambda: KS.ski_interp_backward(x1, m1, s1, dF, g),
                                        lambda: KS.interp_backward_plain(x1, m1, s1, dF, g), None),
                "ski_kr_matmul": (lambda: KS.ski_kr_matmul(R, F, W), lambda: KS.kr_matmul_plain(R, F, W),
                                  lambda: torch.einsum("ia,ib,abk->ik", R, F, W.view(r, r, r))),
                "ski_kr_gram": (lambda: KS.ski_kr_gram(Q, R, F), lambda: KS.kr_gram_plain(Q, R, F),
                                lambda: torch.einsum("ip,ia,ib->pab", Q, R, F).reshape(r, r * r)),
                "ski_kr_adjoint": (lambda: KS.ski_kr_adjoint(R, F, W, G), lambda: KS.kr_adjoint_plain(R, F, W, G),
                                   None),
            }
            for name, (kern, plain, library) in cases.items():
                got, want = kern(), plain()
                got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
                err = max(rel(a, b) for a, b in zip(got, want))
                expect(err <= K13_REL, f"{name} {tag} ({m} rows): rel {err:.3e} (limit {K13_REL})")
                if name == "ski_interp_backward":  # K13a' sums in a fixed order: its twin's bits, every call
                    same = bool(torch.equal(got[0], want[0]) and torch.equal(kern(), got[0]))
                    expect(same, f"{name} {tag}: bit-equal to its plain version and to a second call")
                else:  # K13a and K13b-d: a fixed order, no atomics
                    again = kern()
                    same = all(torch.equal(a, b) for a, b in zip(again if isinstance(again, tuple) else (again,), got))
                    expect(same, f"{name} {tag}: a second call bit-equal to the first")
                if name == "ski_interp":  # the same float32 sum in tap order; torch's sum over the taps may differ
                    print(f"    {name} {tag}: bit-equal to interp_plain {torch.equal(got[0], want[0])}")
                if library is not None:
                    lib_err = rel(library(), want[0])
                    print(f"    {name} {tag}: the einsum vs plain rel {lib_err:.3e}")
                cell = dict(max_abs_err=max(float((a - b).abs().max()) for a, b in zip(got, want)),
                            ms=timer(kern, 10), plain_ms=timer(plain, 3),
                            # K13a and K13a' take a few microseconds on the card: replayed, without the host's launch
                            graph_ms=graph_ms(kern, 10) if name.startswith("ski_interp") else None,
                            library_ms=None if library is None else timer(library, 3),
                            **bound(*k13_cost(name, m, g, r, r)), shape=f"{tag}: {m} rows, g={g}, r={r}, k={r}")
                print(f"    {name} {tag}: kernel {cell['ms']:.4f} ms (graph {cell['graph_ms']}), plain "
                      f"{cell['plain_ms']:.4f} ms, library "
                      f"{cell['library_ms']} ms, bound {cell['bound_ms']:.4f} ms ({cell['bound_by']})")
                if name in ("ski_kr_matmul", "ski_kr_gram"):  # cuBLAS's f32 rate on the same flops, M W or
                    M = (R[:, :, None] * F[:, None, :]).reshape(m, -1)  # Q^T M: a yardstick the port never calls
                    mm = (lambda: torch.mm(M, W)) if name == "ski_kr_matmul" else (lambda: torch.mm(Q.T, M))
                    mm_ms = timer(mm, 3)
                    flops = 2 * m * r * r * r
                    cell["mm_materialised_ms"] = mm_ms
                    print(f"    {name} {tag}: torch.mm of the materialised (n, r^2) M {mm_ms:.4f} ms "
                          f"({flops / mm_ms / 1e9:.1f} TFLOP/s) against the kernel's {flops / cell['ms'] / 1e9:.1f} "
                          f"and einsum's {flops / cell['library_ms'] / 1e9:.1f}")
                    del M
                if tag == "train":
                    rows[name] = cell
                else:
                    rows[name].update(joint={k: cell[k] for k in ("ms", "graph_ms", "plain_ms", "library_ms",
                                                                   "bound_ms", "mm_materialised_ms") if k in cell},
                                      max_abs_err=max(rows[name]["max_abs_err"], cell["max_abs_err"]))
    del R, F, Q, dF, G

    print("baselines 9.2: SKIP NLML, raw gradients (twice, bit for bit) and R R^T vs JAX on the CPU (golden, JAX's "
          "Omega)")
    for tag, raw in (("init", init), ("best", best)):
        sk = convert.skip_model_from_jax(raw, **skw)
        loss = sk.nlml(x, y)
        loss.backward()
        sk2 = convert.skip_model_from_jax(raw, **skw)
        loss2 = sk2.nlml(x, y)
        loss2.backward()
        same = bool(torch.equal(loss2.detach(), loss.detach())) and all(
            torch.equal(getattr(sk2, k).grad, getattr(sk, k).grad) for k in RAW_NAMES)
        expect(same, f"{tag}: a second SKIP NLML and its raw gradients bit-equal to the first")
        record[f"skip_{tag}_repeat_bit_equal"] = same
        dl = abs(float(loss.detach()) - float(golden[f"skip_loss_{tag}"]))
        expect(dl <= NLML_ATOL, f"{tag}: NLML {float(loss.detach()):.6f} vs JAX {float(golden[f'skip_loss_{tag}']):.6f} "
               f"(|diff| {dl:.2e}, limit {NLML_ATOL}; JAX with LAPACK's own signs "
               f"{float(golden[f'native_skip_loss_{tag}']):.6f})")
        got = {k: getattr(sk, k).grad.detach().cpu().numpy().astype(np.float64).ravel() for k in RAW_NAMES}
        want = {k: golden[f"skip_grad_{tag}_{k}"].astype(np.float64).ravel() for k in RAW_NAMES}
        for k in RAW_NAMES:
            print(f"    d/d{k}: port {np.round(got[k], 6).tolist()}, JAX {np.round(want[k], 6).tolist()}, JAX with "
                  f"LAPACK's signs {np.round(golden[f'native_skip_grad_{tag}_{k}'], 6).tolist()}")
        keys = RAW_NAMES if tag == "init" else ("raw_noise",)
        a, b = (np.concatenate([v[k] for k in keys]) for v in (got, want))
        c, rr = cosine(a, b), float(np.linalg.norm(a - b) / np.linalg.norm(b))
        expect(c >= GRAD_COS and rr <= GRAD_REL, f"{tag}: the gradient in {', '.join(keys)}: cos {c:.6f} "
               f"(limit {GRAD_COS}), rel {rr:.2e} (limit {GRAD_REL})")
        with torch.no_grad():
            R = sk.root(sk.constrained(), x)[:256].cpu().numpy().astype(np.float64)
        Rg = golden[f"skip_root_{tag}"].astype(np.float64)
        r_rrt = float(np.linalg.norm(R @ R.T - Rg @ Rg.T) / np.linalg.norm(Rg @ Rg.T))
        expect(r_rrt <= SKIP_RRT_REL, f"{tag}: R R^T on the first 256 rows rel {r_rrt:.3e} (limit {SKIP_RRT_REL})")
        record[f"skip_{tag}"] = dict(nlml=float(loss.detach()), nlml_diff=dl, grad_cos=c, grad_rel=rr, rrt_rel=r_rrt,
                                     grads={k: v.tolist() for k, v in got.items()})

    def metrics(mean, var, yt):
        err = mean - yt
        return float(np.sqrt((err**2).mean())), float(0.5 * (np.log(2 * np.pi * var) + err**2 / var).mean())

    def serve(mdl, tag, rmse_ref):
        mdl.predict(x, y, xt)  # warm
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        mean, var = mdl.predict(x, y, xt)
        ev[1].record()
        torch.cuda.synchronize()
        mean, var = mean.cpu().numpy(), var.cpu().numpy()
        rmse, nll = metrics(mean, var, full.test_y)
        mean_rms = float(np.sqrt(((mean[:4096] - golden[f"{tag}_mean"]) ** 2).mean()))
        expect(bool(np.isfinite(mean).all() and (var > 0).all()) and mean.shape == full.test_y.shape,
               f"{tag}: finite mean and positive variance, one per test row")
        expect(abs(rmse - rmse_ref) <= BASELINE_RMSE_ATOL,
               f"{tag}: test RMSE {rmse:.4f} vs {rmse_ref:.4f} (limit {BASELINE_RMSE_ATOL}; JAX with the port's signs "
               f"{float(golden[f'{tag}_rmse']):.4f})")
        return dict(predict_ms=ev[0].elapsed_time(ev[1]), rmse=rmse, nll=nll, mean_rms_diff=mean_rms)

    print("baselines 9.3: SKIP serving at model_best.pkl (joint root over the training and all test rows)")
    sk = convert.skip_model_from_jax(best, **skw)
    rec = serve(sk, "skip", float(golden["native_skip_rmse"]))
    expect(rec["mean_rms_diff"] <= SKIP_MEAN_RMS, f"skip: mean vs JAX over 4,096 rows: rms diff "
           f"{rec['mean_rms_diff']:.3e} (limit {SKIP_MEAN_RMS})")
    print(f"    predict {rec['predict_ms']:.1f} ms; test NLL {rec['nll']:.3f} (JAX {float(golden['skip_nll']):.3f}, with "
          f"LAPACK's signs {float(golden['native_skip_nll']):.3f}: the reference's variance, not gated)")
    record["skip_serving"] = rec

    print("baselines 9.4: SGPR NLML, raw gradients and serving at model_best.pkl vs JAX on the CPU (golden)")
    sraw = convert.load_jax_params(R5_RUNS / "sgpr_precipitation_s0" / "model_best.pkl")
    sg = convert.sgpr_model_from_jax(sraw, **kw)
    loss = sg.nlml(x, y)
    loss.backward()
    dl = abs(float(loss.detach()) - float(golden["sgpr_loss_best"]))
    expect(dl <= NLML_ATOL, f"NLML {float(loss.detach()):.6f} vs JAX {float(golden['sgpr_loss_best']):.6f} "
           f"(|diff| {dl:.2e}, limit {NLML_ATOL})")
    keys = (*RAW_NAMES, "inducing")
    a = np.concatenate([getattr(sg, k).grad.detach().cpu().numpy().astype(np.float64).ravel() for k in keys])
    b = np.concatenate([golden[f"sgpr_grad_best_{k}"].astype(np.float64).ravel() for k in keys])
    c, rr = cosine(a, b), float(np.linalg.norm(a - b) / np.linalg.norm(b))
    expect(c >= GRAD_COS and rr <= GRAD_REL, f"the raw gradient, the 512 x 3 inducing rows' included: cos {c:.6f} "
           f"(limit {GRAD_COS}), rel {rr:.2e} (limit {GRAD_REL})")
    srec = serve(sg, "sgpr", float(golden["sgpr_rmse"]))
    expect(abs(srec["nll"] - float(golden["sgpr_nll"])) <= SGPR_NLL_ATOL,
           f"sgpr: test NLL {srec['nll']:.4f} vs JAX {float(golden['sgpr_nll']):.4f} (limit {SGPR_NLL_ATOL})")
    expect(srec["mean_rms_diff"] <= SGPR_MEAN_RMS, f"sgpr: mean vs JAX over 4,096 rows: rms diff "
           f"{srec['mean_rms_diff']:.3e} (limit {SGPR_MEAN_RMS})")
    print(f"    predict {srec['predict_ms']:.1f} ms")
    record["sgpr"] = dict(nlml=float(loss.detach()), nlml_diff=dl, grad_cos=c, grad_rel=rr, serving=srec)

    print("baselines 9.5: one warm SKIP step and one warm SGPR step at 65,536 rows, by stage; SKIP at 402,223 rows")
    sk = convert.skip_model_from_jax(init, **skw)
    opt = torch.optim.Adam(sk.parameters(), lr=0.1)

    def skip_step():
        opt.zero_grad(set_to_none=True)
        sk.nlml(x, y).backward()
        opt.step()

    for fn in k13:
        fn.launches = 0
    step_ms = timer(skip_step, 3)
    step_launches = {fn.__name__: fn.launches / 4 for fn in k13}  # warm-up + 3 timed steps
    st = Stages()
    with torch.no_grad():  # the root's stages, as SKIP.root runs them
        R = None
        factors = st("grid_eigh", lambda: sk.grid_factors(sk.constrained(), x, r))
        for j, (gmin, step, U) in enumerate(factors):
            xj = x[:, j].contiguous()
            F = st("k13", lambda: KS.ski_interp(xj, gmin, step, U))
            if R is None:
                R = F
                continue
            Y = st("k13", lambda: KS.ski_kr_matmul(R, F, sk.omega(j, r, dev)))
            Q = st("qr", lambda: MS.fix_signs(torch.linalg.qr(Y)[0]).contiguous())
            B = st("k13", lambda: KS.ski_kr_gram(Q, R, F))
            R = st("svd", lambda: (lambda u, s: (Q @ MS.fix_signs(u[:, :r])) * s[:r][None, :])(
                *torch.linalg.svd(B, full_matrices=False)[:2]))
    opt.zero_grad(set_to_none=True)
    loss = st("forward", lambda: sk.nlml(x, y))
    st("backward", loss.backward)
    st("adam", opt.step)
    stages = st.totals()
    print(f"    warm SKIP step {step_ms:.2f} ms (CUDA events); launches a step {step_launches}; stages (ms): "
          + json.dumps({k: round(v, 3) for k, v in stages.items()}))
    record["skip_step"] = dict(step_ms=step_ms, stages=stages, launches=step_launches)

    sg = convert.sgpr_model_from_jax(sraw, **kw)
    sopt = torch.optim.Adam(sg.parameters(), lr=0.1)

    def sgpr_step():
        sopt.zero_grad(set_to_none=True)
        sg.nlml(x, y).backward()
        sopt.step()

    sstep_ms = timer(sgpr_step, 3)
    st = Stages()
    with torch.no_grad():
        params = sg.constrained()
        z = params["inducing"]
        st("kernel_matrices", lambda: (sg._k(params, z, z), sg._k(params, z, x)))
        st("factors", lambda: sg._common(params, x, y))
    sopt.zero_grad(set_to_none=True)
    loss = st("forward", lambda: sg.nlml(x, y))
    st("backward", loss.backward)
    st("adam", sopt.step)
    sstages = st.totals()
    print(f"    warm SGPR step {sstep_ms:.2f} ms (CUDA events); stages (ms): "
          + json.dumps({k: round(v, 3) for k, v in sstages.items()}))
    record["sgpr_step"] = dict(step_ms=sstep_ms, stages=sstages)

    xf = torch.from_numpy(full.train_x).to(dev)
    yf = torch.from_numpy(full.train_y).to(dev)
    big, kernel_step = {}, MS.SKIP.hadamard_step
    for path in ("k13", "materialised"):
        sk = convert.skip_model_from_jax(init, **skw)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if path == "materialised":
            MS.SKIP.hadamard_step = staticmethod(materialised_hadamard_step)
        try:
            st = Stages()
            loss = st("forward", lambda: sk.nlml(xf, yf))
            st("backward", loss.backward)
            big[path] = dict(nlml=float(loss.detach()), peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                             **st.totals())
        except torch.cuda.OutOfMemoryError:
            big[path] = dict(fits=False)
        finally:
            MS.SKIP.hadamard_step = staticmethod(kernel_step)
        del sk, loss
        print(f"    {path}: NLML + backward at {xf.shape[0]} rows: {big[path]}")
    expect("nlml" in big["k13"] and np.isfinite(big["k13"]["nlml"]), "SKIP NLML + backward through K13 at the full "
           "402,223 training rows: finite")
    record["skip_full_n"] = big

    print("baselines 9.6: python -m simplex_gp_torch.train_{skip,sgpr,exact}, two epochs and one eval each")
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        common = [*BASELINE_FLAGS, "--epochs", "2", "--log-int", "2", "--out", tmp, "--device", dev.type]
        for fn in k13:
            fn.launches = 0
        runs["skip"] = train_skip.main([*common, "--max-n", "65536"])
        launches = {fn.__name__: fn.launches for fn in k13}
        runs["sgpr"] = train_sgpr.main([*common, "--max-n", "65536"])
        runs["exact"] = train_exact.main([*common, "--max-n", "16384", "--patience", "30"])
    print(f"    K13 launches on the SKIP trainer run: {launches}")
    expect(all(v > 0 for v in launches.values()), "every K13 kernel launched on the SKIP trainer run")
    for name, summary in runs.items():
        losses = [-rec_["train/mll"] for rec_ in summary["records"]]
        val = summary["records"][-1].get("val/rmse", float("nan"))
        final = summary["final"]
        expect(len(losses) == 2 and all(np.isfinite(losses)) and np.isfinite(val)
               and all(np.isfinite(final[k]) for k in ("test/rmse", "test/nll")),
               f"{name} trainer: losses {losses}, val RMSE {val:.4f}, test RMSE {final['test/rmse']:.4f}, NLL "
               f"{final['test/nll']:.4f}, a step {summary['records'][-1]['train/loss_ts'] * 1e3:.1f} ms")
        record[f"trainer_{name}"] = dict(losses=losses, val_rmse=val, final=final,
                                         step_s=[rec_["train/loss_ts"] for rec_ in summary["records"]])
    return rows, launches, record


def splat_cost(plan, c: int) -> tuple:
    """(bytes, ops) of K3'b: the plan's points and weights and v (n, c) in, the live table out; a
    multiply-add per contribution and column."""
    N, n = plan.splat_points.shape[0], plan.weights.shape[0]
    live = min(int(plan.n_lattice), plan.cnt.shape[0])
    return 4 * (2 * N + live + n * c + live * c), 2 * N * c


def chain_build_cost(plan) -> tuple:
    """(bytes, ops) of K3'a: h1, h2, s, w in; splat points, weights and slice_idx (N each), cnt, gathers and
    taps of the live rows out.  The hash table, sorts and prefix sums inside are the build's own traffic."""
    N, Mc = plan.splat_points.shape[0], plan.cnt.shape[0]
    d, r = plan.gather.shape[0], plan.tapw.shape[1]
    live = min(int(plan.n_lattice), Mc)
    return 4 * (4 * N + 3 * N + live * (1 + d + (d + 1) * r)), 0


def chain_splat_csr(plan):
    """K3'b's function as one sparse CSR matrix S (Mc, n) of the splat weights, for the library yardstick."""
    import torch

    crow = torch.cat([plan.cnt.new_zeros(1), plan.cnt]).long()
    return torch.sparse_csr_tensor(crow, plan.splat_points.long(), plan.splat_weights,
                                   size=(plan.cnt.shape[0], plan.weights.shape[0]))


def chain_library_ops(plan, taps):
    """One sparse CSR matrix per K3'b-d function, for the library yardstick: S (Mc, n) with the splat
    weights, axis 0's stencil with its transition gather (Mc, Mc), and SLICE_NORM S^T (n, Mc)."""
    import torch

    Mc, r = plan.cnt.shape[0], plan.tapw.shape[1]
    dev = plan.cnt.device
    live = min(int(plan.n_lattice), Mc)
    splat = chain_splat_csr(plan)
    q = torch.arange(live, device=dev)
    p = plan.gather[0, :live].long()
    rows, cols, vals = [q], [p], [torch.full((live,), taps[r], device=dev)]
    for k in range(1, r + 1):
        w = plan.tapw[0, k - 1]
        fwd, bwd = p + k < live, p - k >= 0
        rows += [q[fwd], q[bwd]]
        cols += [p[fwd] + k, p[bwd] - k]
        vals += [w[p[fwd]], w[p[bwd] - k]]
    axis = torch.sparse_coo_tensor(torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals),
                                   size=(Mc, Mc)).coalesce().to_sparse_csr()
    return splat, axis, chain_slice_csr(plan)


def chain_slice_csr(plan):
    """K3'd's function as one sparse CSR matrix SLICE_NORM S^T (n, Mc), for the library yardstick."""
    import torch

    from simplex_gp_torch.ops import lattice as L

    n, dp1 = plan.weights.shape
    prow = torch.arange(0, n * dp1 + 1, dp1, device=plan.weights.device)
    return torch.sparse_csr_tensor(prow, plan.slice_idx.reshape(-1).long(),
                                   plan.weights.reshape(-1) * L.SLICE_NORM(dp1 - 1), size=(n, plan.cnt.shape[0]))


def slice_cost(plan, c: int) -> tuple:
    """(bytes, ops) of K3'd: the live table, slice_idx and weights in, the (n, c) output out; a multiply-add
    per contribution and column."""
    n, dp1 = plan.weights.shape
    live = min(int(plan.n_lattice), plan.cnt.shape[0])
    return 4 * (live * c + 2 * n * dp1 + n * c), 2 * n * dp1 * c


def sharded_chain_cost(plan, c: int, P: int) -> tuple:
    """(bytes, ops) of one rank's sharded chain apply: its contributions' points and weights, its run ends,
    the live rows' taps and transitions, its slice_idx and weights, and v (n_loc, c) in, the output out (the
    partial tables, blocks and collectives are the apply's own traffic); a multiply-add per contribution and
    column in the splat and the slice, and (2r+1) taps per live row, column of its block and axis."""
    N, n = plan.splat_points.shape[0], plan.weights.shape[0]
    nl, d, r = plan.cnt.shape[0], plan.gather.shape[0], plan.tapw.shape[1]
    nbytes = 4 * (2 * N + nl + nl * ((d + 1) * r + d) + 2 * n * (d + 1) + 2 * n * c)
    return nbytes, 2 * N * c + 2 * (2 * r + 1) * (d + 1) * nl * -(-c // P) + 2 * n * (d + 1) * c


def sharded_chain_checks(plan, v, dk, axis) -> dict:
    """One rank's sharded chain apply (kernels/chain.py::chain_apply_sharded) at c = v's columns: against its
    plain version forward and transposed, outputs and final-order tables, bit for bit, and a second call;
    its time by CUDA events (forward and transposed), the plain version's, and with the device synchronised
    around each collective the whole and the transport apart, the bytes a collective, the bound; and with
    P > 1 the unblock alone on the apply's block shape against its twin and torch.cat of the blocks' column
    slices (the library's one call for it), timed beside both and its bound."""
    import torch

    from simplex_gp_torch.kernels import chain as KC
    from simplex_gp_torch.ops import lattice as L

    taps, norm = list(dk.coeffs), L.SLICE_NORM(plan.weights.shape[1] - 1)
    c, nl = v.shape[1], plan.cnt.shape[0]
    res = dict(equal=True, rel=0.0, max_abs_err=0.0, n_lattice=nl, rows=v.shape[0], c=c, ranks=axis.size)
    for transpose in (False, True):
        kout, ktab = KC.chain_apply_sharded(plan, v, taps, norm, axis, transpose, True)
        again, atab = KC.chain_apply_sharded(plan, v, taps, norm, axis, transpose, True)
        pout, ptab = KC.chain_apply_sharded_plain(plan, v, taps, norm, axis, transpose, True)
        res["equal"] &= bool(torch.equal(kout, pout) and torch.equal(ktab, ptab) and torch.equal(again, kout)
                             and torch.equal(atab, ktab))
        res["rel"] = max(res["rel"], rel(kout, pout), rel(ktab, ptab))
        res["max_abs_err"] = max(res["max_abs_err"], float((kout - pout).abs().max()))
    res["ms"] = cuda_ms(lambda: KC.chain_apply_sharded(plan, v, taps, norm, axis), 20)
    res["transposed_ms"] = cuda_ms(lambda: KC.chain_apply_sharded(plan, v, taps, norm, axis, True), 20)
    res["plain_ms"] = cuda_ms(lambda: KC.chain_apply_sharded_plain(plan, v, taps, norm, axis), 5)
    axis.timing = True
    axis.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        KC.chain_apply_sharded(plan, v, taps, norm, axis)
    torch.cuda.synchronize()
    res.update(timed_ms=1e3 * (time.perf_counter() - t0) / 5, transport_ms=1e3 * axis.stats["seconds"] / 5,
               collectives=axis.stats["calls"] / 5,
               bytes_per_collective=axis.stats["bytes"] / max(1, axis.stats["calls"]),
               **bound(*sharded_chain_cost(plan, c, axis.size)))
    axis.timing = False
    if axis.size > 1:
        cb = -(-c // axis.size)
        blocks = torch.randn((axis.size, nl, cb), generator=torch.Generator(device=v.device).manual_seed(5),
                             device=v.device)
        # The library's one call: torch.cat of the blocks' column slices (views), the padding left out.
        parts = [blocks[b, :, :min(cb, c - b * cb)] for b in range(axis.size) if b * cb < c]
        table = KC.chain_unblock(blocks, c)
        res["unblock"] = dict(equal=bool(torch.equal(table, KC.chain_unblock_plain(blocks, c))
                                         and torch.equal(table, torch.cat(parts, dim=1))),
                              ms=cuda_ms(lambda: KC.chain_unblock(blocks, c), 50),
                              plain_ms=cuda_ms(lambda: KC.chain_unblock_plain(blocks, c), 20),
                              library_ms=cuda_ms(lambda: torch.cat(parts, dim=1), 50),
                              **bound(8 * nl * c, 0), shape=f"({axis.size}, {nl}, {cb}) blocks, c={c}")
    return res


def chain_phase(dev, ds, expect, timer, stage_times):
    """Phase 10: the sort-chain plan K3' (build, splat, axis stencils, slice).

    Returns (kernel rows, launches per training step, the record).
    """
    import torch

    import simplex_gp_torch
    from simplex_gp_torch import convert
    from simplex_gp_torch import train as trainer
    from simplex_gp_torch.kernels import chain as KC
    from simplex_gp_torch.kernels import lattice as K
    from simplex_gp_torch.linalg import mll
    from simplex_gp_torch.linalg.cg import cg_solve
    from simplex_gp_torch.linalg.pivoted_cholesky import precond_solve, precond_sqrt
    from simplex_gp_torch.models.components import init_raw_params
    from simplex_gp_torch.ops import lattice as L
    from simplex_gp_torch.utils import data

    tg = np.load(TRAIN_GOLDEN)
    cfg = mll.BBMMConfig(cg_tolerance=1.0, max_cg_iterations=500, max_lanczos_iterations=100, precond_rank=100,
                         num_probes=10)
    model = simplex_gp_torch.SimplexGP(num_dims=18, kernel="matern", nu=1.5, order=1, min_noise=0.1, bbmm=cfg,
                                       eval_cg_tolerance=0.01, device=dev)
    dk = model.dk
    taps, order = [float(t) for t in dk.coeffs], dk.order
    x = torch.from_numpy(ds.train_x).to(dev)
    y = torch.from_numpy(ds.train_y).to(dev)
    n = x.shape[0]
    init = {k: tg[f"init_{k}"] for k in RAW_NAMES}
    best = convert.raw_params_from_numpy(convert.load_jax_params(PARAMS), device=dev)
    z = torch.from_numpy(np.random.default_rng(int(tg["seed_init"])).choice(
        [-1.0, 1.0], size=(n, cfg.num_probes)).astype(np.float32)).to(dev)

    def positions(raw):
        model.load_raw(raw)
        with torch.no_grad():
            return (x * model.constrained()["inv_ell"]).contiguous()

    house = data.load_dataset("houseelectric")
    xh = torch.from_numpy(house.train_x).to(dev) / trainer.median_lengthscale(house.train_x)
    cases = (("elevators, median init", positions(init), None),
             ("elevators, trained", positions(best), None),
             ("houseelectric, median init", xh.contiguous(), int(np.load(HOUSE_GOLDEN)["full_capacity"])))
    del xh
    record, gen = {}, torch.Generator(device=dev).manual_seed(10)
    print("chain 10.1: K3'a-d vs plain, vs the join plan on the same positions, two builds and applies")
    errs = dict(chain_build=0, chain_splat=0.0, chain_axis=0.0, chain_slice=0.0)
    main_case = None
    for name, pts, cap in cases:
        nd = pts.shape[1]
        E = torch.from_numpy(L.build_rotation(nd, dk.variance)).to(dev)
        a = torch.from_numpy(L._hash_vectors(nd)).to(dev)
        consts = torch.from_numpy(L._chain_consts(nd)).to(dev)
        h1, h2, w, sums = K.lattice_geometry(pts, E, a, with_s=True)
        # K1's team of lanes a point against its plain twin and the first kernel (a thread a point), field by
        # field, and the two kernels' times beside K1's bound (x in; h1, h2, w, s out).
        k1_plain = K.geometry_plain(pts, E, a, with_s=True)
        k1_thread = K._geometry_per_thread(pts, E, a, with_s=True)
        k1_same = [bool(torch.equal(u.reshape(-1), v.reshape(-1)) and torch.equal(u.reshape(-1), q.reshape(-1)))
                   for u, v, q in zip((h1, h2, w, sums), k1_plain, k1_thread)]
        expect(all(k1_same), f"{name}: K1 (team) h1, h2, w, s torch.equal to plain and to the per-thread kernel "
               f"{k1_same}")
        del k1_plain, k1_thread
        np_, dp_ = pts.shape
        k1 = dict(team_ms=timer(lambda: K.lattice_geometry(pts, E, a, with_s=True), 10),
                  per_thread_ms=timer(lambda: K._geometry_per_thread(pts, E, a, with_s=True), 10),
                  team_graph_ms=graph_ms(lambda: K.lattice_geometry(pts, E, a, with_s=True), 5),
                  per_thread_graph_ms=graph_ms(lambda: K._geometry_per_thread(pts, E, a, with_s=True), 5),
                  equal=all(k1_same),
                  **bound(4 * np_ * dp_ + 16 * np_ * (dp_ + 1), geometry_ops(np_, dp_)))
        print(f"    {name}: K1 team {k1['team_ms']:.4f} ms (graph {k1['team_graph_ms']:.4f}), per thread "
              f"{k1['per_thread_ms']:.4f} (graph {k1['per_thread_graph_ms']:.4f}), bound {k1['bound_ms']:.5f}")
        kplan = KC.chain_build(h1, h2, sums, w, consts, taps, cap)
        pplan = KC.chain_build_plain(h1, h2, sums, w, consts, taps, cap)
        again = KC.chain_build(h1, h2, sums, w, consts, taps, cap)
        differ = [f for f in KC.ChainPlan._fields if not torch.equal(getattr(kplan, f), getattr(pplan, f))]
        errs["chain_build"] += len(differ)
        nl, Mc = int(kplan.n_lattice), kplan.cnt.shape[0]
        expect(not differ, f"{name}: K3'a == plain in every field (n_lattice {nl}, Mc {Mc}, "
               f"{int(kplan.n_long)} runs past {KC.PIECE} in {int(kplan.n_pieces)} pieces); differing: {differ}")
        expect(all(torch.equal(u, v) for u, v in zip(kplan, again)), f"{name}: two K3'a builds bit-equal")
        jplan = L.build_plan_join(pts, dk.coeffs, dk.variance, cap)
        njl = int(jplan.n_lattice)
        if name.startswith("elevators"):
            expect(nl == njl, f"{name}: n_lattice chain {nl} = join {njl}")
        else:
            print(f"    {name}: n_lattice chain {nl}, join {njl}")
        live = min(nl, Mc)
        case = dict(n_lattice=nl, join_n_lattice=njl, capacity=Mc, long_runs=int(kplan.n_long),
                    pieces=int(kplan.n_pieces), mid_runs=int(kplan.n_mid), k1=k1)
        csr, slice_csr = chain_splat_csr(kplan), chain_slice_csr(kplan)
        for c in (1, 11):
            v = torch.randn((pts.shape[0], c), generator=gen, device=dev)
            splat_equal = torch.equal(KC.chain_splat(kplan, v)[:live], KC.chain_splat_plain(pplan, v)[:live])
            expect(splat_equal, f"{name} c={c}: K3'b == plain bit for bit over the {live} live rows")
            # K3'd on this case's final table, gated bit for bit, timed beside its bound and the CSR product
            final = KC.chain_axes(KC.chain_splat(kplan, v), kplan, taps)
            slice_equal = torch.equal(KC.chain_slice(final, kplan, L.SLICE_NORM(nd)), KC.chain_slice_plain(
                final, kplan.slice_idx, kplan.weights, kplan.n_lattice, L.SLICE_NORM(nd)))
            expect(slice_equal, f"{name} c={c}: K3'd == plain bit for bit")
            kout = L.apply_plan_chain(kplan, v, dk.coeffs)
            pout = KC.chain_apply_plain(pplan, v, taps, L.SLICE_NORM(nd))
            r = rel(kout, pout)
            expect(torch.equal(kout, pout), f"{name} c={c}: K3'b-d apply == plain bit for bit (rel {r:.3e})")
            expect(torch.equal(kout, L.apply_plan_chain(kplan, v, dk.coeffs)), f"{name} c={c}: two applies bit-equal")
            # The join's operator in float64 (its plain version on K2's plan): K3's float32 atomic sums over
            # houseelectric's long rows (up to 1.17M contributions) err by ~1e-5 themselves.
            exact = K.apply_plain(jplan.seg_ids, jplan.weights, jplan.neighbors, v.double(), taps,
                                  L.SLICE_NORM(nd), n_lattice=jplan.n_lattice)
            jout = L.apply_plan_join(jplan, v, dk.coeffs)
            rj, rx = rel(kout.double(), exact), rel(jout.double(), exact)
            expect(rj <= LARGE_N_REL, f"{name} c={c}: chain vs the join's operator (float64) rel {rj:.3e} (limit "
                   f"{LARGE_N_REL}); K3 (float32) vs it {rx:.3e}, chain vs K3 {rel(kout, jout):.3e}")
            del exact
            case[f"c{c}"] = dict(
                plain_rel=r, plain_bit_equal=torch.equal(kout, pout), join_rel=rj, k3_join_rel=rx,
                chain_k3_rel=rel(kout, jout),
                apply_ms=timer(lambda: L.apply_plan_chain(kplan, v, dk.coeffs), 20),
                k3_ms=timer(lambda: L.apply_plan_join(jplan, v, dk.coeffs), 20),
                apply_graph_ms=graph_ms(lambda: L.apply_plan_chain(kplan, v, dk.coeffs), 10),
                k3_graph_ms=graph_ms(lambda: L.apply_plan_join(jplan, v, dk.coeffs), 10),
                splat_bit_equal=splat_equal, splat_ms=timer(lambda: KC.chain_splat(kplan, v), 50),
                splat_graph_ms=graph_ms(lambda: KC.chain_splat(kplan, v), 10),
                splat_csr_ms=timer(lambda: csr @ v, 20),
                **{f"splat_{k}": x_ for k, x_ in bound(*splat_cost(kplan, c)).items()},
                slice_bit_equal=slice_equal,
                slice_ms=timer(lambda: KC.chain_slice(final, kplan, L.SLICE_NORM(nd)), 20),
                slice_graph_ms=graph_ms(lambda: KC.chain_slice(final, kplan, L.SLICE_NORM(nd)), 10),
                slice_csr_graph_ms=graph_ms(lambda: slice_csr @ final, 10),
                **{f"slice_{k}": x_ for k, x_ in bound(*slice_cost(kplan, c)).items()})
            del final
        build_call = lambda: KC.chain_build(h1, h2, sums, w, consts, taps, cap)  # noqa: E731
        case.update(build_ms=timer(lambda: L.build_plan_chain(pts, dk.coeffs, dk.variance, cap), 5),
                    join_build_ms=timer(lambda: L.build_plan_join(pts, dk.coeffs, dk.variance, cap), 5),
                    k1_ms=timer(lambda: K.lattice_geometry(pts, E, a, with_s=True), 10),
                    k3a_ms=timer(build_call, 10), k3a_stages=KC.chain_build_stage_times(build_call),
                    **{f"k3a_{k}": x_ for k, x_ in bound(*chain_build_cost(kplan)).items()})
        print(f"    {name}: K3'a {case['k3a_ms']:.3f} ms (bound {case['k3a_bound_ms']:.4f}) by stage (device / host ms) "
              + ", ".join(f"{k} {v_['device_ms']:.3f} / {v_['host_ms']:.3f}" for k, v_ in case["k3a_stages"].items()))
        print(f"    {name}: build {case['build_ms']:.3f} ms (K1 {case['k1_ms']:.3f}) vs K1 + K2 "
              f"{case['join_build_ms']:.3f} ms; apply (events / graph replay, ms) "
              + "; ".join(f"c={c}: chain {case[f'c{c}']['apply_ms']:.4f} / {case[f'c{c}']['apply_graph_ms']:.4f} "
                          f"(K3'b {case[f'c{c}']['splat_ms']:.4f} / {case[f'c{c}']['splat_graph_ms']:.4f}, CSR "
                          f"{case[f'c{c}']['splat_csr_ms']:.4f}, bound {case[f'c{c}']['splat_bound_ms']:.4f}; K3'd "
                          f"{case[f'c{c}']['slice_ms']:.4f} / {case[f'c{c}']['slice_graph_ms']:.4f}, CSR "
                          f"{case[f'c{c}']['slice_csr_graph_ms']:.4f}, bound {case[f'c{c}']['slice_bound_ms']:.4f}"
                          f"), K3 "
                          f"{case[f'c{c}']['k3_ms']:.4f} / {case[f'c{c}']['k3_graph_ms']:.4f}" for c in (1, 11)))
        record[name] = case
        if main_case is None:
            main_case = (pts, h1, h2, sums, w, consts, kplan, pplan)
        del kplan, pplan, again, jplan, h1, h2, w, sums, csr, slice_csr

    # Houseelectric untrimmed (Mc = N = 15.7M rows, ~20k live), and elevators (median init) and houseelectric
    # one row short of the occupancy (the slice's guard): the plan, the splat and the apply against their
    # plain versions, bit for bit, and the apply all NaN past the capacity.
    for name, pts, cap in (
            ("houseelectric, untrimmed", cases[2][1], None),
            ("elevators, overflowing", cases[0][1], record["elevators, median init"]["n_lattice"] - 1),
            ("houseelectric, overflowing", cases[2][1], record["houseelectric, median init"]["n_lattice"] - 1)):
        E = torch.from_numpy(L.build_rotation(pts.shape[1], dk.variance)).to(dev)
        a = torch.from_numpy(L._hash_vectors(pts.shape[1])).to(dev)
        consts = torch.from_numpy(L._chain_consts(pts.shape[1])).to(dev)
        h1, h2, w, sums = K.lattice_geometry(pts, E, a, with_s=True)
        kplan = KC.chain_build(h1, h2, sums, w, consts, taps, cap)
        pplan = KC.chain_build_plain(h1, h2, sums, w, consts, taps, cap)
        differ = [f for f in KC.ChainPlan._fields if not torch.equal(getattr(kplan, f), getattr(pplan, f))]
        errs["chain_build"] += len(differ)
        Mc = kplan.cnt.shape[0]
        live = min(int(kplan.n_lattice), Mc)
        expect(not differ, f"{name}: K3'a == plain in every field (n_lattice {int(kplan.n_lattice)}, Mc {Mc}); "
               f"differing: {differ}")
        case = dict(n_lattice=int(kplan.n_lattice), capacity=Mc, mid_runs=int(kplan.n_mid),
                    long_runs=int(kplan.n_long), pieces=int(kplan.n_pieces))
        for c in (1, 11):
            v = torch.randn((pts.shape[0], c), generator=gen, device=dev)
            splat_equal = torch.equal(KC.chain_splat(kplan, v)[:live], KC.chain_splat_plain(pplan, v)[:live])
            expect(splat_equal, f"{name} c={c}: K3'b == plain bit for bit over the {live} live rows")
            kout = L.apply_plan_chain(kplan, v, dk.coeffs)
            pout = KC.chain_apply_plain(pplan, v, taps, L.SLICE_NORM(pts.shape[1]))
            if cap is None:
                expect(torch.equal(kout, pout), f"{name} c={c}: K3'b-d apply == plain bit for bit")
            else:
                expect(bool(torch.isnan(kout).all() and torch.isnan(pout).all()),
                       f"{name} c={c}: the apply past the capacity is all NaN, kernel and plain")
            case[f"c{c}"] = dict(splat_bit_equal=splat_equal, splat_ms=timer(lambda: KC.chain_splat(kplan, v), 10))
        print(f"    {name}: n_lattice {case['n_lattice']}, Mc {Mc}; K3'b "
              + ", ".join(f"c={c} {case[f'c{c}']['splat_ms']:.4f} ms" for c in (1, 11)))
        record[name] = case
        del kplan, pplan, h1, h2, w, sums

    print("chain 10.2: each kernel vs plain and its yardstick (elevators, median init, c=11)")
    pts, h1, h2, sums, w, consts, plan, pplan = main_case
    d, N = pts.shape[1], h1.shape[0]
    nl, Mc = int(plan.n_lattice), plan.cnt.shape[0]
    v = torch.randn((n, 11), generator=gen, device=dev)
    tk = KC.chain_splat(plan, v)
    tp = KC.chain_splat_plain(plan, v)
    errs["chain_splat"] = float((tk[:nl] - tp[:nl]).abs().max())
    expect(torch.equal(tk[:nl], tp[:nl]), "K3'b == plain bit for bit on the timed input")
    ak = KC.chain_axis(tp, plan.tapw[0], plan.gather[0], plan.n_lattice, taps)
    ap = KC.chain_axis_plain(tp, plan.tapw[0], plan.gather[0], taps)
    errs["chain_axis"] = float((ak[:nl] - ap[:nl]).abs().max())
    final = tp.clone()
    sk = KC.chain_slice(final, plan, L.SLICE_NORM(d))
    sp = KC.chain_slice_plain(final, plan.slice_idx, plan.weights, plan.n_lattice, L.SLICE_NORM(d))
    errs["chain_slice"] = float((sk - sp).abs().max())
    for key in ("chain_splat", "chain_axis"):
        expect(errs[key] <= CHAIN_REL * 10, f"{key} vs plain on the same input: max |diff| {errs[key]:.3e}")
    expect(torch.equal(sk, sp), "K3'd == plain bit for bit on the timed input")
    s_splat, s_axis, s_slice = chain_library_ops(plan, taps)
    lib_err = max(rel(s_splat @ v, tp[:Mc]), rel((s_axis @ tp)[:nl], ap[:nl]), rel(s_slice @ final, sp))
    expect(lib_err <= 1e-5, f"the CSR yardsticks compute the same functions: rel {lib_err:.3e}")
    r = order
    rows = {
        "chain_build": dict(
            max_abs_err=errs["chain_build"],  # fields that differ from the plain build
            ms=timer(lambda: KC.chain_build(h1, h2, sums, w, consts, taps), 10),
            plain_ms=timer(lambda: KC.chain_build_plain(h1, h2, sums, w, consts, taps), 3),
            **bound(*chain_build_cost(plan)), library_ms=None, shape=f"N={N}, d={d}, n_lattice={nl}",
            join_build_ms=record["elevators, median init"]["join_build_ms"],
            by_case={name: {k: record[name][k] for k in ("k3a_ms", "k3a_bound_ms", "k1_ms", "build_ms",
                                                          "join_build_ms", "k3a_stages")}
                     for name in ("elevators, median init", "elevators, trained", "houseelectric, median init")}),
        "chain_splat": dict(
            max_abs_err=errs["chain_splat"], ms=timer(lambda: KC.chain_splat(plan, v), 50),
            plain_ms=timer(lambda: KC.chain_splat_plain(plan, v), 5),
            **bound(*splat_cost(plan, 11)), library_ms=timer(lambda: s_splat @ v, 20),
            shape=f"N={N}, c=11, n_lattice={nl}",
            by_case={f"{name}, c={c}": {k: record[name][f"c{c}"][k] for k in
                                         ("splat_ms", "splat_graph_ms", "splat_csr_ms", "splat_bound_ms")}
                     for name in ("elevators, median init", "elevators, trained", "houseelectric, median init")
                     for c in (1, 11)}),
        "chain_axis": dict(
            max_abs_err=errs["chain_axis"],
            ms=timer(lambda: KC.chain_axis(tp, plan.tapw[0], plan.gather[0], plan.n_lattice, taps), 50),
            plain_ms=timer(lambda: KC.chain_axis_plain(tp, plan.tapw[0], plan.gather[0], taps), 5),
            # one axis: the live table, its taps and gather in, the table out
            **bound(4 * (2 * nl * 11 + r * nl + nl), 2 * (2 * r + 1) * nl * 11),
            library_ms=timer(lambda: s_axis @ tp, 20), shape=f"one axis, c=11, n_lattice={nl}"),
        "chain_slice": dict(
            max_abs_err=errs["chain_slice"], ms=timer(lambda: KC.chain_slice(final, plan, L.SLICE_NORM(d)), 50),
            plain_ms=timer(lambda: KC.chain_slice_plain(final, plan.slice_idx, plan.weights, plan.n_lattice,
                                                        L.SLICE_NORM(d)), 5),
            **bound(*slice_cost(plan, 11)), library_ms=timer(lambda: s_slice @ final, 20), shape=f"n={n}, c=11",
            by_case={f"{name}, c={c}": {k: record[name][f"c{c}"][k] for k in
                                         ("slice_ms", "slice_graph_ms", "slice_csr_graph_ms", "slice_bound_ms")}
                     for name in ("elevators, median init", "houseelectric, median init") for c in (1, 11)}),
    }
    rows["chain_splat"]["graph_ms"] = graph_ms(lambda: KC.chain_splat(plan, v), 20)
    rows["chain_axis"]["graph_ms"] = graph_ms(
        lambda: KC.chain_axis(tp, plan.tapw[0], plan.gather[0], plan.n_lattice, taps), 20)
    rows["chain_slice"]["graph_ms"] = graph_ms(lambda: KC.chain_slice(final, plan, L.SLICE_NORM(d)), 20)
    for key, row in rows.items():
        print(f"    {key}: {row['ms']:.4f} ms (graph replay {row.get('graph_ms', float('nan')):.4f}), plain "
              f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms, library {row['library_ms']} ms")
    del s_splat, s_axis, s_slice, main_case, pplan

    print("chain 10.3: launches in one training step (elevators, median init, exact mode)")
    model.load_raw(init)
    opt = torch.optim.Adam(model.parameters(), lr=0.1)
    train_step(model, opt, x, y, z)  # warm-up
    model.load_raw(init)
    for fn in (*chain_kernels(), KC.chain_axes_transpose, KC.chain_axis):
        fn.launches = 0
    train_step(model, opt, x, y, z)
    launches = {fn.__name__: fn.launches for fn in (*chain_kernels(), KC.chain_axes_transpose)}
    print(f"    launches: {launches}; the per-axis chain_axis {KC.chain_axis.launches}")
    expect(all(v_ > 0 for v_ in launches.values()), "every K3' kernel launched in the training step")
    launches["chain_axis"] = KC.chain_axis.launches  # off the path: the fused axes run instead

    print("chain 10.4: repeatability (the NLML and the eval CG gated; the build and the apply in 10.1)")
    model.load_raw(init)
    runs = []
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        stats = {}
        loss = model.nlml(x, y, probes=z, stats=stats)
        loss.backward()
        runs.append((loss.detach().clone(), stats["cg_iters"],
                     torch.cat([getattr(model, k).grad.reshape(-1) for k in RAW_NAMES])))
    with torch.no_grad():
        params = model.constrained()
        ref = (x * params["inv_ell"]).contiguous()
        P = [mll.build_precond(dk, cfg, params, ref, n) for _ in range(2)]
        sy = [mll._solve_system(dk, cfg, params, x, y - params["mean"], z) for _ in range(2)]
    rep = dict(
        nlml_bit_equal=torch.equal(runs[0][0], runs[1][0]), nlml=[float(r_[0]) for r_ in runs],
        cg_iters=[r_[1] for r_ in runs],
        grad_rel_diff=rel(runs[1][2], runs[0][2]),
        preconditioner_bit_equal=all(torch.equal(u, v_) for u, v_ in zip(P[0], P[1])),
        cg_solves_bit_equal=torch.equal(sy[0].solves, sy[1].solves),
        slq_logdet_bit_equal=torch.equal(sy[0].logdet, sy[1].logdet))
    print(f"    NLML at the median init twice: bit-equal {rep['nlml_bit_equal']} ({rep['nlml']}), CG iterations "
          f"{rep['cg_iters']}; stages bit-equal: preconditioner {rep['preconditioner_bit_equal']}, CG "
          f"{rep['cg_solves_bit_equal']}, SLQ {rep['slq_logdet_bit_equal']}; gradients rel diff "
          f"{rep['grad_rel_diff']:.3e} (gated bit for bit in phase 11.3)")
    model.load_raw(best)
    caches = [model.posterior_cache(x, y, generator=torch.Generator(device=dev).manual_seed(0)) for _ in range(2)]
    rep.update(eval_cg_iters=[c_["cg_iters"] for c_ in caches],
               eval_alpha_bit_equal=torch.equal(caches[0]["alpha"], caches[1]["alpha"]),
               eval_alpha_rel_diff=rel(caches[1]["alpha"], caches[0]["alpha"]))
    if not rep["eval_alpha_bit_equal"]:
        with torch.no_grad():
            params = model.constrained()
            ref = (x * params["inv_ell"]).contiguous()
            P = [mll.build_precond(dk, cfg, params, ref, n) for _ in range(2)]
            plan = L.build_plan_chain(ref, dk.coeffs, dk.variance)
            sol = [cg_solve(lambda V: params["outputscale"] * L.apply_plan_chain(plan, V, dk.coeffs)
                            + params["noise"] * V, (y - params["mean"])[:, None], tol=0.01, max_iters=500,
                            precond=lambda V, P_=P_: precond_solve(P_, V)).x for P_ in P]
        rep.update(eval_preconditioner_bit_equal=all(torch.equal(u, v_) for u, v_ in zip(P[0], P[1])),
                   eval_cg_bit_equal=torch.equal(sol[0], sol[1]))
    expect(rep["nlml_bit_equal"] and rep["cg_iters"][0] == rep["cg_iters"][1],
           f"the NLML at the median init twice: bit-equal, CG iterations {rep['cg_iters']}")
    expect(rep["slq_logdet_bit_equal"], "the SLQ log-det of two identical solves bit-equal (K14)")
    expect(rep["eval_cg_iters"][0] == rep["eval_cg_iters"][1] and rep["eval_alpha_bit_equal"],
           f"posterior_cache at model_best.pkl twice: eval CG iterations {rep['eval_cg_iters']}, alpha bit-equal")
    print(f"    posterior_cache at model_best.pkl twice: eval CG iterations {rep['eval_cg_iters']}, alpha bit-equal "
          f"{rep['eval_alpha_bit_equal']} (rel diff {rep['eval_alpha_rel_diff']:.3e})"
          + ("" if rep["eval_alpha_bit_equal"] else f"; preconditioner bit-equal "
             f"{rep['eval_preconditioner_bit_equal']}, CG bit-equal {rep['eval_cg_bit_equal']}"))
    record["repeatability"] = rep

    print("chain 10.5: one CG on the chain plan and on the join plan of the same positions, in turns")
    house_model = simplex_gp_torch.SimplexGP(num_dims=11, kernel="matern", nu=1.5, order=1, min_noise=0.1,
                                             bbmm=cfg, eval_cg_tolerance=0.01, device=dev)
    house_model.load_raw(init_raw_params(11, lengthscale=trainer.median_lengthscale(house.train_x)))
    model.load_raw(init)
    turns = {}
    for tag, m_, xs, ys, cap, tol in (
            ("elevators training CG (median init, c=11)", model, x, y, None, cfg.cg_tolerance),
            ("houseelectric eval CG (median init, capacity 32,768, c=1)", house_model,
             torch.from_numpy(house.train_x).to(dev), torch.from_numpy(house.train_y).to(dev), cases[2][2], 0.01)):
        with torch.no_grad():
            params = m_.constrained()
            ref = (xs * params["inv_ell"]).contiguous()
            P = mll.build_precond(dk, cfg, params, ref, xs.shape[0])
            rhs = (ys - params["mean"])[:, None]
            if xs.shape[0] == n:  # training: [y | P^1/2 z]
                rhs = torch.cat([rhs, precond_sqrt(P, z)], dim=-1)
            plans = dict(chain=L.build_plan_chain(ref, dk.coeffs, dk.variance, cap),
                         join=L.build_plan_join(ref, dk.coeffs, dk.variance, cap))
            runs = []
            for engine in ("chain", "join", "join", "chain"):
                plan = plans[engine]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = cg_solve(lambda V: params["outputscale"] * L.apply_plan(plan, V, dk.coeffs) + params["noise"] * V,
                               rhs, tol=tol, max_iters=500, precond=lambda V: precond_solve(P, V))
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0)
                runs.append(dict(engine=engine, ms=ms, iterations=res.iterations, ms_per_iteration=ms / res.iterations))
        turns[tag] = runs
        print(f"    {tag}: " + "; ".join(f"{r_['engine']} {r_['ms']:.1f} ms / {r_['iterations']} it = "
                                         f"{r_['ms_per_iteration']:.3f}" for r_ in runs))
    record["cg_turns"] = turns
    del house_model, plans, P

    print("chain 10.6: stage times with the chain as the CG plan (phases 3, 4.5 and 6.5)")
    for key, val in stage_times.items():
        print(f"    {key}: " + json.dumps(val))
    record["stage_times"] = stage_times
    return rows, launches, record


def k10_cost(name: str, n: int, t: int, k: int, nb: int, better_cols: int, ranks: int = 1, nbu: int = 1) -> tuple:
    """(bytes, ops) of one K10 kernel at (n, t): each vector read once and written once, the block partials
    and the state counted with them (every rank's partials read, for K10' at ``ranks`` > 1; the passes over
    U write nbu block partials); cg_step_p writes the best iterate of the columns that improved."""
    vec, part = 4 * n * t, 4 * nb * t
    return {
        "cg_dot": (3 * vec + part, 5 * n * t),  # p, K p in; A p out; s K p + noise p, the products and sums
        "cg_step_x": (6 * vec + (ranks + 1) * part, 6 * n * t),  # x, r, p, A p in; x, r out
        "cg_utr": u_pass_cost("cg_utr", n, k, t, nbu),
        "cg_fold": (4 * (ranks * nbu * k * t + k + k * t), ranks * nbu * k * t + k * t),  # partials, w in; G2 out
        "cg_precond": u_pass_cost("cg_precond", n, k, t, nbu),
        "cg_step_p": (3 * vec + 8 * n * better_cols + 2 * ranks * part, 2 * n * t),  # z, p in; p out; x -> x_best
        "cg_init": (2 * ranks * part, 3 * t),  # the two dots' partials in
    }[name]


def k10_sharded_pairs(loop, axis, reps: int) -> dict:
    """Phase 7.3's K10' check on one rank: cg_step_x, cg_step_p and cg_init given every rank's block partials,
    and cg_fold given every rank's U^T r (each rank's own partials folded first), all-gathered as the sharded
    loop gathers them, against their plain twins from ``loop``'s saved state (a sharded CGLoop some
    iterations in), bit for bit; each timed beside its twin (CUDA events).

    Every rank must call it at the same point: the MVM and the gathers are collectives.
    """
    import torch

    from simplex_gp_torch.kernels import cg as K10

    S = {k_: getattr(loop, k_).clone() for k_ in ("x", "r", "p", "x_best", "fs", "is_", "A", "B", "TM", "z",
                                                  "part_rr", "G2")}
    kp = loop.matmul(S["p"]).contiguous()
    ap, part_pap = torch.empty_like(kp), torch.empty_like(loop.part_pap)
    K10.cg_dot(S["p"], kp, part_pap, loop.scale, loop.noise, ap)
    pap = axis.all_gather_blocks(part_pap)  # (P, nb, t)
    rr, rz = axis.all_gather_blocks(loop.part2).transpose(0, 1)  # two (P, NB, t) views, the ranks' r . r and r . z
    rr, rz = rr[:, :loop.nb], rz[:, :loop.nb_rz]
    # The ranks' U^T r: each rank's partials folded with w = 1, then every rank's G gathered (P, 1, k, t).
    K10.cg_utr(loop.U, S["r"], loop.part_g)
    K10.cg_fold(loop.part_g, loop.ones, loop.G)
    gs = axis.all_gather_blocks(loop.G)[:, None]
    quiet = loop.rules._replace(tol=0.0, floor=2 ** 30, max_iters=2 ** 30, stall_window=0)
    calls = {
        "cg_step_x": (K10.cg_step_x, K10.cg_step_x_plain, ("x", "r", "fs", "is_", "part_rr"),
                      lambda f, T, R: f(pap, T["x"], T["r"], T["p"], ap, T["fs"], T["is_"], T["part_rr"])),
        "cg_step_p": (K10.cg_step_p, K10.cg_step_p_plain, ("p", "x_best", "fs", "is_", "A", "B", "TM"),
                      lambda f, T, R: f(rz, rr, T["x"], T["z"], T["p"], T["x_best"], T["fs"], T["is_"], T["A"],
                                        T["B"], T["TM"], R)),
        "cg_init": (K10.cg_init, K10.cg_init_plain, ("fs", "is_"),
                    lambda f, T, R: f(rr, rz, T["fs"], T["is_"], R.max_iters)),
        "cg_fold": (K10.cg_fold, K10.cg_fold_plain, ("G2",), lambda f, T, R: f(gs, loop.w, T["G2"])),
    }
    n, t = S["x"].shape
    nb = loop.part_pap.shape[0]
    # The fold's one PyTorch call: every rank's G summed and scaled by w (einsum's own order).
    fold_lib = lambda: torch.einsum("j,pbjc->jc", loop.w, gs)
    out = {}
    for name, (kernel, plain, mutable, call) in calls.items():
        copy = lambda: {k_: (v.clone() if k_ in mutable else v) for k_, v in S.items()}
        Kk, Pp = copy(), copy()
        call(kernel, Kk, loop.rules)
        call(plain, Pp, loop.rules)
        torch.cuda.synchronize()
        better = int((K10.state_views(Kk["fs"], Kk["is_"]).res_best < K10.state_views(S["fs"], S["is_"]).res_best
                      ).sum()) if name == "cg_step_p" else 0
        Tk, Tp = copy(), copy()
        out[name] = dict(
            bit_equal=all(torch.equal(Kk[k_], Pp[k_]) for k_ in mutable),
            max_abs_err=max(float((Kk[k_].double() - Pp[k_].double()).abs().nan_to_num().max()) for k_ in mutable),
            ms=cuda_ms(lambda: call(kernel, Tk, quiet), reps), plain_ms=cuda_ms(lambda: call(plain, Tp, quiet), 3),
            **bound(*k10_cost(name, n, t, loop.U.shape[1], nb, better, axis.size, nbu=1)),
            library_ms=cuda_ms(fold_lib, reps) if name == "cg_fold" else None,
            shape=f"n={n} a rank, c={t}, P = {axis.size} ({axis.transport}), nb={nb}")
        if name == "cg_fold":
            out[name].update(library_rel=rel(fold_lib(), Kk["G2"]))
    return out


def k10_pairs(loop, timer, reps: int) -> dict:
    """Phase 11.1: each K10 kernel against its plain twin from ``loop``'s saved state, bit for bit.

    One iteration in the solver's order from one state; each kernel and its twin get equal copies of
    their inputs, and the kernel's outputs feed the next step.  Then the kernel's time (CUDA events) and
    its twin's on the same inputs, with stop rules that cannot end the timed repeats.
    """
    import torch

    from simplex_gp_torch.kernels import cg as K10

    def same(a, b):
        if a.is_floating_point():
            nan = torch.isnan(a)
            return bool(torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan]))
        return bool(torch.equal(a, b))

    def err(a, b):
        return float((a.double() - b.double()).abs().nan_to_num().max()) if a.numel() else 0.0

    rules, quiet = loop.rules, loop.rules._replace(tol=0.0, floor=2 ** 30, max_iters=2 ** 30, stall_window=0)
    # b . b's partials stand in as r . r's (the loop keeps b . b in r . r's half until its first iteration).
    S = dict(x=loop.x, r=loop.r, p=loop.p, x_best=loop.x_best, fs=loop.fs, is_=loop.is_, part_pap=loop.part_pap,
             part_rr=loop.part_rr, part_rz=loop.part_rz, part_bb=loop.part_rr, A=loop.A, B=loop.B, TM=loop.TM,
             part_g=loop.part_g, G2=loop.G2, z=loop.z, ap=loop.ap)
    S = {k_: (v.clone() if v is not None else None) for k_, v in S.items()}
    S["kp"] = loop.matmul(S["p"]).contiguous()
    steps = (
        ("cg_dot", K10.cg_dot, K10.cg_dot_plain, ("part_pap", "ap"),
         lambda f, S, R: f(S["p"], S["kp"], S["part_pap"], loop.scale, loop.noise, S["ap"])),
        ("cg_step_x", K10.cg_step_x, K10.cg_step_x_plain, ("x", "r", "fs", "is_", "part_rr"),
         lambda f, S, R: f(S["part_pap"], S["x"], S["r"], S["p"], S["ap"], S["fs"], S["is_"], S["part_rr"])),
        ("cg_utr", K10.cg_utr, K10.cg_utr_plain, ("part_g",),
         lambda f, S, R: f(loop.U, S["r"], S["part_g"])),
        ("cg_fold", K10.cg_fold, K10.cg_fold_plain, ("G2",),
         lambda f, S, R: f(S["part_g"], loop.w, S["G2"])),
        ("cg_precond", K10.cg_precond, K10.cg_precond_plain, ("z", "part_rz"),
         lambda f, S, R: f(loop.U, S["G2"], S["r"], loop.p_noise, S["z"], S["part_rz"])),
        ("cg_step_p", K10.cg_step_p, K10.cg_step_p_plain, ("p", "x_best", "fs", "is_", "A", "B", "TM"),
         lambda f, S, R: f(S["part_rz"], S["part_rr"], S["x"], S["z"], S["p"], S["x_best"], S["fs"], S["is_"],
                           S["A"], S["B"], S["TM"], R)),
        ("cg_init", K10.cg_init, K10.cg_init_plain, ("fs", "is_"),
         lambda f, S, R: f(S["part_bb"], S["part_rz"], S["fs"], S["is_"], R.max_iters)),
    )
    n, t = S["x"].shape
    k = loop.U.shape[1]
    rp, nb = K10.cg_layout(n, t)
    nbu = K10.u_layout(n, k, t).nb
    # cuBLAS's products for the same shapes, the two the iteration ran before K10 read U itself.
    G, H = torch.empty((k, t), device=S["x"].device), torch.empty_like(S["x"])
    # cg_fold's: one einsum over the block partials, the sum and the scaling by w in one call.
    library = {"cg_utr": (lambda: torch.mm(loop.U.T, S["r"], out=G), u_pass_cost("mm_utr", n, k, t, nbu)),
               "cg_fold": (lambda: torch.einsum("j,bjc->jc", loop.w, S["part_g"]), k10_cost("cg_fold", n, t, k, nb,
                                                                                         0, nbu=nbu)),
               "cg_precond": (lambda: torch.mm(loop.U, S["G2"], out=H), u_pass_cost("mm_ug", n, k, t, nbu))}
    out = {}
    for name, kernel, plain, mutable, call in steps:
        copy = lambda: {k_: (v.clone() if k_ in mutable and v is not None else v) for k_, v in S.items()}
        Kk, Pp = copy(), copy()
        call(kernel, Kk, rules)
        call(plain, Pp, rules)
        torch.cuda.synchronize()
        keys = [k_ for k_ in mutable if Kk[k_] is not None]
        better = int((K10.state_views(Kk["fs"], Kk["is_"]).res_best < K10.state_views(S["fs"], S["is_"]).res_best
                      ).sum()) if name == "cg_step_p" else 0
        Tk, Tp, Tg = copy(), copy(), copy()
        out[name] = dict(
            bit_equal=all(same(Kk[k_], Pp[k_]) for k_ in keys), max_abs_err=max(err(Kk[k_], Pp[k_]) for k_ in keys),
            ms=timer(lambda: call(kernel, Tk, quiet), reps), plain_ms=timer(lambda: call(plain, Tp, quiet), 3),
            graph_ms=graph_ms(lambda: call(kernel, Tg, quiet), 10),
            **bound(*k10_cost(name, n, t, k, nb, better, nbu=nbu)))
        if name in library:
            lib, cost = library[name]
            out[name].update(library_ms=timer(lib, reps), library_graph_ms=graph_ms(lib, 10),
                             library_bound_ms=bound(*cost)["bound_ms"])
            if name == "cg_fold":
                out[name].update(library_rel=rel(lib(), Kk["G2"]))
        S.update({k_: Kk[k_] for k_ in mutable})
    return out


def cg_phase(dev, ds, expect, timer):
    """Phase 11: K10, the CG body (csrc/cg.cu), and the deterministic exact backward.

    Returns (kernel rows, launches on the main path, the record).
    """
    import dataclasses

    import torch

    import simplex_gp_torch
    from simplex_gp_torch import convert
    from simplex_gp_torch import train as trainer
    from simplex_gp_torch.kernels import cg as K10
    from simplex_gp_torch.kernels import lattice as K
    from simplex_gp_torch.linalg import cg as CG
    from simplex_gp_torch.linalg import mll
    from simplex_gp_torch.linalg.pivoted_cholesky import precond_sqrt
    from simplex_gp_torch.models.components import init_raw_params
    from simplex_gp_torch.models.exact_gp import rademacher
    from simplex_gp_torch.ops.filter import apply_plan_any, build_plan_any
    from simplex_gp_torch.utils import data

    tg = np.load(TRAIN_GOLDEN)
    cfg = mll.BBMMConfig(cg_tolerance=1.0, max_cg_iterations=500, max_lanczos_iterations=100, precond_rank=100,
                         num_probes=10)
    model = simplex_gp_torch.SimplexGP(num_dims=18, kernel="matern", nu=1.5, order=1, min_noise=0.1, bbmm=cfg,
                                       eval_cg_tolerance=0.01, device=dev)
    dk = model.dk
    x = torch.from_numpy(ds.train_x).to(dev)
    y = torch.from_numpy(ds.train_y).to(dev)
    n = x.shape[0]
    init = {k: tg[f"init_{k}"] for k in RAW_NAMES}
    best = convert.raw_params_from_numpy(convert.load_jax_params(PARAMS), device=dev)
    z = torch.from_numpy(np.random.default_rng(int(tg["seed_init"])).choice(
        [-1.0, 1.0], size=(n, cfg.num_probes)).astype(np.float32)).to(dev)
    house = data.load_dataset("houseelectric")
    cap = int(np.load(HOUSE_GOLDEN)["full_capacity"])
    hcfg = dataclasses.replace(cfg, plan_capacity=cap)
    hmodel = simplex_gp_torch.SimplexGP(num_dims=11, kernel="matern", nu=1.5, order=1, min_noise=0.1, bbmm=hcfg,
                                        eval_cg_tolerance=0.01, device=dev)
    hinit = init_raw_params(11, lengthscale=trainer.median_lengthscale(house.train_x))
    xh, yh = torch.from_numpy(house.train_x).to(dev), torch.from_numpy(house.train_y).to(dev)
    zh = rademacher((xh.shape[0], 10), torch.Generator(device=dev).manual_seed(7), dev)
    record, rows = {}, {}

    def system(m_, xs, ys, probes, capacity):
        """The main path's CG problem at m_'s parameters: (matmul, rhs, P, shift) as _solve_system and
        posterior_cache pose it (probes None: the eval solve)."""
        with torch.no_grad():
            params = m_.constrained()
            ref = (xs * params["inv_ell"]).contiguous()
            plan = build_plan_any(ref, dk, capacity)
            P = mll.build_precond(dk, m_.bbmm, params, ref, xs.shape[0])
            rhs = (ys - params["mean"])[:, None]
            if probes is not None:
                rhs = torch.cat([rhs, precond_sqrt(P, probes)], dim=-1)
        return (lambda V: apply_plan_any(plan, V, dk)), rhs.contiguous(), P, (params["outputscale"], params["noise"])

    model.load_raw(init)
    hmodel.load_raw(hinit)
    cases = (("elevators training CG (median init, c=11, record 100)", model, x, y, z, None, cfg.cg_tolerance, 100),
             ("houseelectric eval CG (median init, capacity 32,768, c=1)", hmodel, xh, yh, None, cap, 0.01, 0))
    print("cg 11.1: each K10 kernel vs its plain twin from one saved iteration state")
    for tag, m_, xs, ys, probes, capacity, tol, m in cases:
        mv, rhs, P, shift = system(m_, xs, ys, probes, capacity)
        loop = CG.CGLoop(mv, rhs, tol=tol, max_iters=500, precond=P, tridiag_m=m, shift=shift)
        for _ in range(3):
            loop.iteration()
        pairs = k10_pairs(loop, timer, 20)
        for name, row in pairs.items():
            expect(row["bit_equal"], f"{tag}: {name} == plain bit for bit (max |diff| {row['max_abs_err']:.3e})")
        print(f"    {tag}: " + "; ".join(f"{k_} {v['ms']:.4f} ms (graph {v['graph_ms']:.4f}, plain "
                                         f"{v['plain_ms']:.3f}, bound {v['bound_ms']:.4f})"
                                         for k_, v in pairs.items()))
        record[tag] = dict(kernels=pairs)
        if m_ is model:
            rows = pairs  # the JSON rows: the training CG's shape, the step's own

        # 11.2 the graph solve against the eager kernel loop, in turns; the capture's cost; launches an iteration
        runs = []
        for graph in (False, True, True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = CG.cg_solve(mv, rhs, tol=tol, max_iters=500, precond=P, tridiag_m=m, shift=shift, graph=graph)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            runs.append(dict(graph=graph, ms=ms, iterations=res.iterations, ms_per_iteration=ms / res.iterations,
                             x=res.x.clone()))
        equal = all(r_["iterations"] == runs[0]["iterations"] and torch.equal(r_["x"], runs[0]["x"]) for r_ in runs)
        expect(equal, f"{tag}: the graph solve == the eager kernel loop (iterations "
               f"{[r_['iterations'] for r_ in runs]}, x bit for bit)")
        loop = CG.CGLoop(mv, rhs, tol=tol, max_iters=500, precond=P, tridiag_m=m, shift=shift)
        counters = (K10.cg_dot, K10.cg_step_x, K10.cg_utr, K10.cg_fold, K10.cg_precond, K10.cg_step_p,
                    *chain_kernels())
        for fn in counters:
            fn.launches = 0
        loop.iteration()
        per_it = {fn.__name__: fn.launches for fn in counters}
        # 11.5: one iteration's device kernels by name (torch.profiler): no cuBLAS GEMM or GEMV, and no
        # allocation (the allocator's count of allocations does not move).
        torch.cuda.synchronize()
        allocs = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            loop.iteration()
            torch.cuda.synchronize()
        names = sorted({e.key for e in prof.key_averages() if e.self_device_time_total > 0})
        blas = [nm for nm in names if any(w_ in nm.lower() for w_ in ("gemm", "gemv", "cublas", "cutlass"))]
        iter_allocs = torch.cuda.memory_stats().get("allocation.all.allocated", 0) - allocs
        expect(not blas, f"{tag}: one iteration's kernels hold no cuBLAS product ({len(names)} kernels: "
               f"{[nm[:40] for nm in names]}; GEMM/GEMV {blas})")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph_obj = CG.capture(loop.iteration)
        torch.cuda.synchronize()
        capture_ms = 1e3 * (time.perf_counter() - t0)
        del graph_obj
        mvm_ms = graph_ms(lambda: mv(loop.p), 10)
        # The passes over U beside cuBLAS's products of the same shapes (graph replays, in turns) and their bound.
        (n_, t_), k_ = rhs.shape, P.U.shape[1]
        G_, H_ = torch.empty((k_, t_), device=dev), torch.empty_like(rhs)
        pz, pr = torch.empty_like(loop.z), torch.empty_like(loop.part_rz)
        u_passes = dict(
            cg_utr=graph_ms(lambda: K10.cg_utr(loop.U, loop.r, loop.part_g), 10),
            mm_utr=graph_ms(lambda: torch.mm(loop.U.T, loop.r, out=G_), 10),
            cg_precond=graph_ms(lambda: K10.cg_precond(loop.U, loop.G2, loop.r, loop.p_noise, pz, pr), 10),
            mm_ug=graph_ms(lambda: torch.mm(loop.U, loop.G2, out=H_), 10),
            cg_fold=graph_ms(lambda: K10.cg_fold(loop.part_g, loop.w, G_), 10),
            einsum_fold=graph_ms(lambda: torch.einsum("j,bjc->jc", loop.w, loop.part_g), 10))
        u_passes.update({f"{nm}_bound_ms": bound(*u_pass_cost(nm, n_, k_, t_, loop.nb_rz))["bound_ms"]
                         for nm in ("cg_utr", "cg_precond", "mm_utr", "mm_ug")})
        it_bound = bound(cg_iteration_bytes(rhs.shape[0], rhs.shape[1], P.U.shape[1]), 0)
        for r_ in runs:
            del r_["x"]
        record[tag].update(solves=runs, capture_ms=capture_ms, mvm_graph_ms=mvm_ms, u_passes_graph_ms=u_passes,
                           launches_per_iteration=per_it, iteration_kernels=names, iteration_allocations=iter_allocs,
                           iteration_bound_ms=it_bound["bound_ms"])
        print(f"    {tag}: " + "; ".join(f"{'graph' if r_['graph'] else 'eager'} {r_['ms']:.1f} ms / "
                                         f"{r_['iterations']} it = {r_['ms_per_iteration']:.4f}" for r_ in runs)
              + f"; capture {capture_ms:.2f} ms; MVM {mvm_ms:.4f} ms; U^T r {u_passes['cg_utr']:.4f} ms (cuBLAS "
              f"{u_passes['mm_utr']:.4f}, bound {u_passes['cg_utr_bound_ms']:.4f}), r / noise - U G2 "
              f"{u_passes['cg_precond']:.4f} (cuBLAS's U G2 alone {u_passes['mm_ug']:.4f}, bound "
              f"{u_passes['cg_precond_bound_ms']:.4f}), fold {u_passes['cg_fold']:.4f} (einsum "
              f"{u_passes['einsum_fold']:.4f}) (graph); bound "
              f"{it_bound['bound_ms']:.4f} ms an iteration; launches an iteration {per_it}, no GEMM; "
              f"allocations in a launched iteration {iter_allocs}")
        del loop, mv, rhs, P

    print("cg 11.3: two NLML gradients bit for bit (the exact backward on the CG's chain plan)")
    grads_equal = {}
    for tag, m_, xs, ys, probes, raw in (("elevators, median init", model, x, y, z, init),
                                         ("elevators, model_best.pkl", model, x, y, z, best),
                                         ("houseelectric, median init, capacity 32,768", hmodel, xh, yh, zh, hinit)):
        m_.load_raw(raw)
        outs = []
        for _ in range(2):
            m_.zero_grad(set_to_none=True)
            loss = m_.nlml(xs, ys, probes=probes)
            loss.backward()
            outs.append((loss.detach().clone(), torch.cat([getattr(m_, k_).grad.reshape(-1) for k_ in RAW_NAMES])))
        eq = torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
        grads_equal[tag] = dict(bit_equal=eq, grad_rel_diff=rel(outs[1][1], outs[0][1]))
        expect(eq, f"{tag}: NLML and raw gradients twice, bit-equal (rel diff {grads_equal[tag]['grad_rel_diff']:.3e})")
    record["gradients_repeat"] = grads_equal

    print("cg 11.4: two houseelectric evals after one Adam step from the median init")
    evals = []
    for _ in range(2):
        hmodel.load_raw(hinit)
        opt = torch.optim.Adam(hmodel.parameters(), lr=0.1)
        train_step(hmodel, opt, xh, yh, zh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache = hmodel.posterior_cache(xh, yh, generator=torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        evals.append((cache["cg_iters"], cache["alpha"].clone(), 1e3 * (time.perf_counter() - t0)))
        del cache
    same_eval = evals[0][0] == evals[1][0] and torch.equal(evals[0][1], evals[1][1])
    expect(same_eval, f"two houseelectric evals after one Adam step: CG iterations {[e[0] for e in evals]}, "
           f"alpha bit-equal")
    record["houseelectric_evals_after_a_step"] = dict(cg_iters=[e[0] for e in evals], ms=[e[2] for e in evals],
                                                      alpha_bit_equal=same_eval)
    print(f"    CG iterations {[e[0] for e in evals]}, posterior_cache {[round(e[2], 1) for e in evals]} ms")

    print("cg 11.5: launches on the main path (one elevators training step, one posterior_cache)")
    k10 = (K10.cg_dot, K10.cg_step_x, K10.cg_utr, K10.cg_fold, K10.cg_precond, K10.cg_step_p, K10.cg_init)
    model.load_raw(init)
    opt = torch.optim.Adam(model.parameters(), lr=0.1)
    train_step(model, opt, x, y, z)  # warm
    model.load_raw(init)
    for fn in (*k10, K.lattice_apply, K.lattice_apply_cols, K.join_rows):
        fn.launches = 0
    replays = CG.cg_solve.graph_replays
    train_step(model, opt, x, y, z)
    step_k3 = K.lattice_apply.launches
    model.load_raw(best)
    model.posterior_cache(x, y, generator=torch.Generator(device=dev).manual_seed(0))
    launches = {fn.__name__: fn.launches for fn in k10}
    record["main_path"] = dict(k10_launches=launches, graph_replays=CG.cg_solve.graph_replays - replays,
                               backward_k3_launches=step_k3, backward_k9_launches=K.lattice_apply_cols.launches,
                               join_rows=K.join_rows.launches)
    print(f"    {json.dumps(record['main_path'])}")
    expect(all(v_ > 0 for v_ in launches.values()), "every K10 kernel launched on the main path")
    expect(step_k3 == 0, f"the training step's backward ran no atomic K3 ({step_k3} launches)")
    expect(record["main_path"]["backward_k9_launches"] == 2,
           f"K9 {record['main_path']['backward_k9_launches']} times on the step and the posterior_cache: expected the "
           f"range sketch's two applies only (the step's backward runs on the chain plan)")
    return rows, launches, record


def factor_cost(n: int, dim: int, k: int) -> tuple:
    """(bytes, ops) of a rank-k factor: per pivot j, ref and L[:, :j] read, the diagonal read and written,
    L[:, j] written; the squared distance, the kernel value, the dot and the update."""
    return (sum(4 * n * (dim + j + 3) for j in range(k)), sum(n * (3 * dim + 2 * j + 12) for j in range(k)))


def axes_cost(nl: int, d: int, c: int, order: int) -> tuple:
    """(bytes, ops) of the d+1 axes as one function: the live table read once and written once, each
    axis's taps and each transition's gather read once (the tables between axes are the function's own
    traffic, not counted); each axis's stencil on every element."""
    return (4 * (2 * nl * c + (d + 1) * order * nl + d * nl), (d + 1) * 2 * (2 * order + 1) * nl * c)


def factor_axes_phase(dev, ds, expect, timer):
    """Phase 12: K6's factor (a column-major L, the argmax fused into each step, one host call) and K3'c's
    fused axes (one launch for the d+1 axes), each against the way it ran before (a loop over a row-major L;
    d+1 per-axis launches) and its plain twin.

    Returns (kernel rows, launches, the record).
    """
    import torch

    import simplex_gp_torch
    from simplex_gp_torch import convert
    from simplex_gp_torch import train as trainer
    from simplex_gp_torch.kernels import chain as KC
    from simplex_gp_torch.kernels import pivot as KP
    from simplex_gp_torch.linalg import mll
    from simplex_gp_torch.linalg.pivoted_cholesky import make_preconditioner
    from simplex_gp_torch.models.components import init_raw_params
    from simplex_gp_torch.ops import lattice as L
    from simplex_gp_torch.utils import data

    tg = np.load(TRAIN_GOLDEN)
    cfg = mll.BBMMConfig(cg_tolerance=1.0, max_cg_iterations=500, max_lanczos_iterations=100, precond_rank=100,
                         num_probes=10)
    kw = dict(kernel="matern", nu=1.5, order=1, min_noise=0.1, bbmm=cfg, eval_cg_tolerance=0.01, device=dev)
    model = simplex_gp_torch.SimplexGP(num_dims=18, **kw)
    house_model = simplex_gp_torch.SimplexGP(num_dims=11, **kw)
    dk, k = model.dk, cfg.precond_rank
    taps, order = [float(t) for t in dk.coeffs], dk.order
    x, y = torch.from_numpy(ds.train_x).to(dev), torch.from_numpy(ds.train_y).to(dev)
    init = {k_: tg[f"init_{k_}"] for k_ in RAW_NAMES}
    best = convert.raw_params_from_numpy(convert.load_jax_params(PARAMS), device=dev)
    house = data.load_dataset("houseelectric")
    xh = torch.from_numpy(house.train_x).to(dev)
    house_model.load_raw(init_raw_params(11, lengthscale=trainer.median_lengthscale(house.train_x)))

    def scaled(m, xs, raw=None):
        if raw is not None:
            m.load_raw(raw)
        with torch.no_grad():
            p = m.constrained()
            return p, (xs * p["inv_ell"]).contiguous()

    cases = (("elevators, median init", model, x, init), ("elevators, model_best.pkl", model, x, best),
             ("houseelectric, median init", house_model, xh, None))
    gen = torch.Generator(device=dev).manual_seed(12)
    record, rows = {}, {}
    print("factor 12.1: K6's factor (a launch a pivot from one host call) vs the same kernel's loop over a "
          "row-major L (torch.argmax and a launch a pivot), the plain loop and its steps")
    for name, m, xs, raw in cases:
        params, ref = scaled(m, xs, raw)
        s, noise, nu = params["outputscale"].reshape(()).contiguous(), params["noise"], m.dk.nu
        n, dim = ref.shape
        diag = s * torch.ones(n, device=dev)
        refc = KP.column_major(ref)
        Lf, pf = KP.pivot_factor(ref, diag, s, nu, k)

        def row_major():
            Lr, pr = torch.zeros((n, k), device=dev), torch.zeros(k, dtype=torch.int64, device=dev)
            d_, d0_ = diag.clone(), diag.max()
            for j in range(k):
                d_ = KP.pivot_column(ref, Lr, d_, torch.argmax(d_), j, s, d0_, nu, pr)
            return Lr, pr

        Lr, pr = row_major()
        Lp, pp = KP.pivot_factor_plain(refc, diag, s, nu, k)
        # Each step from the kernel's own state: the one-step kernel (the fused argmax on) and the plain step.
        Ls, ps = torch.zeros((k, n), device=dev).T, torch.zeros(k, dtype=torch.int64, device=dev)
        d, d0 = diag.clone(), diag.max()
        piv, nxt = torch.argmax(d), torch.zeros((), dtype=torch.int64, device=dev)
        worst, argmax_differs, states = 0.0, [], {}
        for j in range(k):
            if j in (0, k // 2, k - 1):
                states[j] = (Ls.T.clone().T, d.clone(), piv.clone())
            Lq, pq = Ls.T.clone().T, ps.clone()
            dq = KP.pivot_column_plain(refc, Lq, d, piv, j, s, d0, nu, pq)
            d = KP.pivot_column(refc, Ls, d, piv, j, s, d0, nu, ps, next_piv=nxt)
            worst = max(worst, rel(Ls[:, j], Lq[:, j]) if float(Lq[:, j].norm()) > 0 else 0.0,
                        rel(d, dq) if float(dq.norm()) > 0 else 0.0)
            if int(torch.argmax(dq)) != int(nxt):
                argmax_differs.append(j)
            piv = nxt.clone()
            del Lq, pq, dq
        torch.cuda.synchronize()
        bits = dict(steps=torch.equal(Lf, Ls) and torch.equal(pf, ps),
                    row_major=torch.equal(Lf, Lr) and torch.equal(pf, pr))
        same = int((pf == pp).sum())
        z = torch.randn((n, 4), generator=gen, device=dev)
        r_llt = rel(Lf @ (Lf.T @ z), Lp @ (Lp.T @ z))
        expect(all(bits.values()), f"{name}: the factor == its own steps and the row-major loop, L and pivots "
               f"bit for bit: {bits}")
        expect(same == k or r_llt <= K6_LLT_REL,
               f"{name}: vs the plain loop {same} of {k} pivots equal, L L^T z rel {r_llt:.3e} (limit {K6_LLT_REL}); "
               + ("the same pivots" if same == k else "a near-tie swapped a pivot, L L^T held"))
        expect(worst <= K6_STEP_REL, f"{name}: each step from the kernel's state vs the plain step: rel "
               f"{worst:.3e} (limit {K6_STEP_REL}); plain argmax differs from the fused one at steps {argmax_differs}")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            KP.pivot_factor(ref, diag, s, nu, k)
            no_sync = True
        except RuntimeError as e:
            no_sync = f"{e}"[:200]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        expect(no_sync is True, f"{name}: the factor makes no host sync (set_sync_debug_mode('error')): {no_sync}")
        big = n > 100_000
        reps = 3 if big else 10
        Lc = Lf.contiguous()
        case = dict(
            n=n, dim=dim, factor_ms=timer(lambda: KP.pivot_factor(ref, diag, s, nu, k), reps),
            row_major_loop_ms=timer(row_major, reps), plain_loop_ms=timer(lambda: KP.pivot_factor_plain(
                refc, diag, s, nu, k), 1), **bound(*factor_cost(n, dim, k)),
            make_preconditioner_ms=timer(lambda: make_preconditioner(Lf, noise, n), 5),
            make_preconditioner_contiguous_L_ms=timer(lambda: make_preconditioner(Lc, noise, n), 5),
            build_precond_ms=timer(lambda: mll.build_precond(m.dk, cfg, params, ref, n), reps),
            pivots_equal_plain=same, llt_rel_plain=r_llt, step_rel_max=worst, argmax_differs_at=argmax_differs,
            bit_equal=bits, no_host_sync=no_sync is True, max_abs_err=float((Lf - Lp).abs().max()))
        # One pivot at j = 0, 50, 99 from the factor's states: the column-major step (the fused argmax on) and
        # the same kernel on a row-major L with no argmax, each beside its bound.
        for j, (Lj, dj, pj) in states.items():
            Lrow = Lj.contiguous()
            case[f"pivot_j{j}"] = dict(
                ms=timer(lambda: KP.pivot_column(refc, Lj, dj, pj, j, s, d0, nu, ps, next_piv=nxt), 20),
                row_major_ms=timer(lambda: KP.pivot_column(ref, Lrow, dj, pj, j, s, d0, nu, ps), 20),
                **bound(4 * n * (dim + j + 3), n * (3 * dim + 2 * j + 12)))
            del Lrow
        print(f"    {name}: n={n}; factor {case['factor_ms']:.3f} ms, "
              f"the row-major loop {case['row_major_loop_ms']:.3f}, plain {case['plain_loop_ms']:.1f}, bound "
              f"{case['bound_ms']:.4f} ({case['bound_by']}); make_preconditioner {case['make_preconditioner_ms']:.3f} "
              f"(contiguous L {case['make_preconditioner_contiguous_L_ms']:.3f}), build_precond "
              f"{case['build_precond_ms']:.3f}; a pivot at j = 0 / {k // 2} / {k - 1}: "
              + " / ".join(f"{case[f'pivot_j{j}']['ms']:.4f} (row-major {case[f'pivot_j{j}']['row_major_ms']:.4f}, bound "
                           f"{case[f'pivot_j{j}']['bound_ms']:.4f})" for j in states)
              + f"; {same}/{k} pivots equal to plain, step rel {worst:.2e}")
        record[name] = case
        tag = "houseelectric" if big else "elevators" if raw is best else None
        if tag is not None:  # K6's row: the one-call factor beside the row-major loop and the bound
            rows.setdefault("pivot_column", {}).update({
                f"{tag}_factor_ms": case["factor_ms"], f"{tag}_factor_row_major_loop_ms": case["row_major_loop_ms"],
                f"{tag}_factor_bound_ms": case["bound_ms"]})
        del Lf, Lr, Lp, Ls, Lc, states, ref, refc
    del xh

    print("axes 12.2: K3'c fused (one launch for the d+1 axes) vs its plain twin and the d+1 per-axis launches")
    _, href = scaled(house_model, torch.from_numpy(house.train_x).to(dev))
    _, eref = scaled(model, x, init)
    plans = (("elevators, median init", L.build_plan_chain(eref, dk.coeffs, dk.variance)),
             ("houseelectric, capacity 32,768", L.build_plan_chain(href, dk.coeffs, dk.variance,
                                                                    int(np.load(HOUSE_GOLDEN)["full_capacity"]))))
    del href
    for name, plan in plans:
        d = plan.gather.shape[0]
        nl, Mc = int(plan.n_lattice), plan.cnt.shape[0]
        live = min(nl, Mc)

        def loop(t):
            for j in range(d + 1):
                t = KC.chain_axis(t, plan.tapw[j], plan.gather[j] if j < d else None, plan.n_lattice, taps)
            return t

        for c in (1, 11):
            v = torch.randn((plan.weights.shape[0], c), generator=gen, device=dev)
            table = KC.chain_splat(plan, v)
            fused = KC.chain_axes(table.clone(), plan, taps)
            want = KC.chain_axes_plain(table, plan, taps)
            per_axis = loop(table)
            apply_equal = torch.equal(L.apply_plan_chain(plan, v, dk.coeffs),
                                      KC.chain_apply_plain(plan, v, taps, L.SLICE_NORM(d)))
            equal = torch.equal(fused[:live], want[:live]) and torch.equal(fused[:live], per_axis[:live])
            expect(equal and apply_equal, f"{name} c={c}: the fused axes == plain and == the {d + 1} per-axis "
                   f"launches over the {live} live rows: {equal}; the apply == plain: {apply_equal}")
            work = table.clone()
            case = dict(n_lattice=nl, capacity=Mc, bit_equal=equal and apply_equal,
                        fused_ms=timer(lambda: KC.chain_axes(work, plan, taps), 50),
                        fused_graph_ms=graph_ms(lambda: KC.chain_axes(work, plan, taps), 20),
                        per_axis_ms=timer(lambda: loop(table), 20), per_axis_graph_ms=graph_ms(lambda: loop(table), 10),
                        plain_ms=timer(lambda: KC.chain_axes_plain(table, plan, taps), 3),
                        apply_ms=timer(lambda: L.apply_plan_chain(plan, v, dk.coeffs), 50),
                        apply_graph_ms=graph_ms(lambda: L.apply_plan_chain(plan, v, dk.coeffs), 20),
                        # Each per-axis launch as its own function: the table in and out, the taps, the gather.
                        per_axis_bound_ms=(d + 1) * bound(4 * live * (2 * c + order + 1),
                                                          2 * (2 * order + 1) * live * c)["bound_ms"],
                        **bound(*axes_cost(live, d, c, order)))
            print(f"    {name} c={c}: fused {case['fused_ms']:.4f} ms (graph {case['fused_graph_ms']:.4f}), {d + 1} "
                  f"per-axis launches {case['per_axis_ms']:.4f} (graph {case['per_axis_graph_ms']:.4f}), bound "
                  f"{case['bound_ms']:.4f} (the per-axis launches' {case['per_axis_bound_ms']:.4f}); the apply "
                  f"{case['apply_ms']:.4f} (graph {case['apply_graph_ms']:.4f})")
            record[f"axes, {name}, c={c}"] = case
            if name.startswith("elevators") and c == 11:
                rows["chain_axes"] = dict(
                    max_abs_err=float((fused[:live] - want[:live]).abs().max()), ms=case["fused_ms"],
                    plain_ms=case["plain_ms"], bound_ms=case["bound_ms"], bound_by=case["bound_by"], library_ms=None,
                    shape=f"the {d + 1} axes, c=11, n_lattice={nl}", graph_ms=case["fused_graph_ms"],
                    per_axis_launches_ms=case["per_axis_ms"], per_axis_graph_ms=case["per_axis_graph_ms"])
            del table, fused, want, per_axis, work
    del plans

    print("axes 12.3: K3'c's launches in one elevators training step (median init, exact mode)")
    model.load_raw(init)
    opt = torch.optim.Adam(model.parameters(), lr=0.1)
    z = torch.from_numpy(np.random.default_rng(int(tg["seed_init"])).choice(
        [-1.0, 1.0], size=(x.shape[0], cfg.num_probes)).astype(np.float32)).to(dev)
    counters = (KC.chain_splat, KC.chain_axes, KC.chain_axis, KC.chain_slice, KP.pivot_column)
    for fn in counters:
        fn.launches = 0
    train_step(model, opt, x, y, z)
    step = {fn.__name__: fn.launches for fn in counters}
    print(f"    launches: {step}; K3'c {step['chain_axes']} fused launches (each all {eref.shape[1] + 1} axes) against "
          f"190 per-axis launches before the fusion; K6 {step['pivot_column']} one-step launches")
    expect(step["chain_axes"] > 0 and step["chain_axis"] == 0 and step["pivot_column"] > 0
           and step["pivot_column"] % k == 0,
           f"the training step runs the fused axes and whole factors of {k} one-step launches: {step}")
    record["training_step_launches"] = step
    return rows, step, record


def axes_transpose_cost(nl: int, d: int, c: int, order: int) -> tuple:
    """(bytes, ops) of K3'c transposed as one function: the live table read once and written once, each axis's
    taps and each of the d + 1 maps (the d inverse transitions and G) read once; each axis's stencil on every
    element (axes_cost with one map more)."""
    return (4 * (2 * nl * c + (d + 1) * order * nl + (d + 1) * nl), (d + 1) * 2 * (2 * order + 1) * nl * c)


def backward_routes(model, x, y, z, route: str) -> dict:
    """The exact backward's route-dependent gradients of the NLML, from one forward (mll._solve_system) at the
    model's parameters: on the CG's chain plan ("chain", the path's) or on a join plan of the same positions
    and capacity with its row lists ("join", the route before).  Returns grad_inv_ell and grad_s, the two
    gradients the route reaches (grad_noise = (U V).sum() does not depend on it), each as the backward of
    LatticeInvQuadLogdet computes it with a = b = 1 / (2 n) (the NLML's weights of inv_quad and logdet)."""
    import torch

    from simplex_gp_torch.linalg import mll
    from simplex_gp_torch.ops.filter import apply_plan_any, build_wide_plan_any, filter_backward

    with torch.no_grad():
        params = model.constrained()
        n = x.shape[0]
        sys_ = mll._solve_system(model.dk, model.bbmm, params, x, y - params["mean"], z)
        p = sys_.probes_right.shape[-1]
        a = b = 0.5 / n
        U = torch.cat([(-a) * sys_.solves[:, :1], (b / p) * sys_.solves[:, 1:]], dim=-1)
        V = torch.cat([sys_.solves[:, :1], sys_.probes_right], dim=-1).contiguous()
        ref = (x * params["inv_ell"]).contiguous()
        plan = sys_.plan if route == "chain" else build_wide_plan_any(ref, model.dk, model.bbmm.plan_capacity)
        KV, table_f = apply_plan_any(plan, V, model.dk, return_table=True)
        _, grad_ref = filter_backward(plan, ref, model.dk, V, params["outputscale"] * U, table_f)
        return dict(inv_ell=(x * grad_ref).sum(dim=0), outputscale=(U * KV).sum(), cg_iters=sys_.iterations)


def chain_backward_phase(dev, ds, expect, timer):
    """Phase 14: the exact backward on the CG's chain plan (the sort chain's reverse mode).  K3'c transposed
    and its maps against their plain twins, the transposed chain apply against its plain version (outputs and
    final-order tables), the chain backward's gradients against the join backward's (the route before), two
    chain gradients bit for bit, and the launches of one training step.  Returns (kernel rows, launches,
    record)."""
    import torch

    import simplex_gp_torch
    from simplex_gp_torch import train as trainer
    from simplex_gp_torch.kernels import chain as KC
    from simplex_gp_torch.kernels import lattice as K
    from simplex_gp_torch.linalg import mll
    from simplex_gp_torch.models.components import init_raw_params
    from simplex_gp_torch.ops import lattice as L
    from simplex_gp_torch.utils import data

    tg = np.load(TRAIN_GOLDEN)
    cap_h = int(np.load(HOUSE_GOLDEN)["full_capacity"])
    kw = dict(kernel="matern", nu=1.5, order=1, min_noise=0.1, eval_cg_tolerance=0.01, device=dev)
    cfg = dict(cg_tolerance=1.0, max_cg_iterations=500, max_lanczos_iterations=100, precond_rank=100, num_probes=10)
    model = simplex_gp_torch.SimplexGP(num_dims=18, bbmm=mll.BBMMConfig(**cfg), **kw)
    house_model = simplex_gp_torch.SimplexGP(num_dims=11, bbmm=mll.BBMMConfig(plan_capacity=cap_h, **cfg), **kw)
    model.load_raw({k_: tg[f"init_{k_}"] for k_ in RAW_NAMES})
    house = data.load_dataset("houseelectric")
    house_model.load_raw(init_raw_params(11, lengthscale=trainer.median_lengthscale(house.train_x)))
    dk = model.dk
    taps, order = [float(t) for t in dk.coeffs], dk.order
    x, y = torch.from_numpy(ds.train_x).to(dev), torch.from_numpy(ds.train_y).to(dev)
    xh, yh = torch.from_numpy(house.train_x).to(dev), torch.from_numpy(house.train_y).to(dev)

    def probes(n, seed):
        return torch.from_numpy(np.random.default_rng(seed).choice([-1.0, 1.0], size=(n, 10)).astype(
            np.float32)).to(dev)

    z, zh = probes(x.shape[0], int(tg["seed_init"])), probes(xh.shape[0], 7)
    cases = (("elevators, median init", model, x, y, z, None), ("houseelectric, capacity 32,768", house_model, xh,
                                                                  yh, zh, cap_h))
    gen = torch.Generator(device=dev).manual_seed(14)
    record, rows = {}, {}

    print("chain backward 14.1: K3'c transposed and its maps vs plain, the transposed chain apply vs plain "
          "(c = 1, 11)")
    for name, m, xs, _, _, cap in cases:
        with torch.no_grad():
            ref = (xs * m.constrained()["inv_ell"]).contiguous()
        plan = L.build_plan_chain(ref, dk.coeffs, dk.variance, cap)
        del ref
        d, nl, Mc = plan.gather.shape[0], int(plan.n_lattice), plan.cnt.shape[0]
        live, norm = min(nl, Mc), L.SLICE_NORM(plan.gather.shape[0])
        tmap = KC.chain_maps(plan)
        maps_equal = torch.equal(tmap, KC.chain_maps_plain(plan.gather))
        for c in (1, 11):
            g = torch.randn((plan.weights.shape[0], c), generator=gen, device=dev)
            table = KC.chain_splat(plan, g)
            got = KC.chain_axes_transpose(table.clone(), plan, taps, tmap)
            want = KC.chain_axes_transpose_plain(table, plan, taps, tmap)
            again = KC.chain_axes_transpose(table.clone(), plan, taps, tmap)
            out, tb = L.apply_plan_chain(plan, g, dk.coeffs, transpose=True, return_table=True)
            pout, ptb = KC.chain_apply_plain(plan, g, taps, norm, transpose=True, return_table=True)
            out2 = L.apply_plan_chain(plan, g, dk.coeffs, transpose=True)
            axes_equal = torch.equal(got[:live], want[:live]) and torch.equal(again[:live], got[:live])
            apply_equal = torch.equal(out, pout) and torch.equal(tb[:live], ptb[:live]) and torch.equal(out2, out)
            expect(maps_equal and axes_equal and apply_equal,
                   f"{name} c={c}: the maps == plain {maps_equal}; K3'c transposed == plain and a second call over "
                   f"the {live} live rows {axes_equal}; the transposed apply and its table == plain and a second "
                   f"call {apply_equal}")
            work = table.clone()
            case = dict(n_lattice=nl, capacity=Mc, bit_equal=maps_equal and axes_equal and apply_equal,
                        max_abs_err=float((got[:live] - want[:live]).abs().max()),
                        ms=timer(lambda: KC.chain_axes_transpose(work, plan, taps, tmap), 50),
                        graph_ms=graph_ms(lambda: KC.chain_axes_transpose(work, plan, taps, tmap), 20),
                        plain_ms=timer(lambda: KC.chain_axes_transpose_plain(table, plan, taps, tmap), 3),
                        forward_axes_ms=timer(lambda: KC.chain_axes(work, plan, taps), 50),
                        maps_ms=timer(lambda: KC.chain_maps(plan), 50),
                        transpose_apply_ms=timer(lambda: L.apply_plan_chain(plan, g, dk.coeffs, transpose=True,
                                                                            return_table=True), 20),
                        transpose_apply_graph_ms=graph_ms(
                            lambda: L.apply_plan_chain(plan, g, dk.coeffs, transpose=True, return_table=True), 10),
                        forward_apply_ms=timer(lambda: L.apply_plan_chain(plan, g, dk.coeffs, return_table=True), 20),
                        transpose_apply_plain_ms=timer(
                            lambda: KC.chain_apply_plain(plan, g, taps, norm, transpose=True, return_table=True), 2),
                        **bound(*axes_transpose_cost(live, d, c, order)))
            print(f"    {name} c={c}: K3'c transposed {case['ms']:.4f} ms (graph {case['graph_ms']:.4f}; the forward "
                  f"axes {case['forward_axes_ms']:.4f}), plain {case['plain_ms']:.3f}, bound {case['bound_ms']:.4f}; "
                  f"maps {case['maps_ms']:.4f}; the transposed apply {case['transpose_apply_ms']:.4f} (graph "
                  f"{case['transpose_apply_graph_ms']:.4f}) against the forward's {case['forward_apply_ms']:.4f}")
            record[f"transpose, {name}, c={c}"] = case
            if name.startswith("elevators") and c == 11:
                rows["chain_axes_transpose"] = dict(
                    max_abs_err=case["max_abs_err"], ms=case["ms"], plain_ms=case["plain_ms"],
                    bound_ms=case["bound_ms"], bound_by=case["bound_by"], library_ms=None,
                    shape=f"the {d + 1} axes transposed, c=11, n_lattice={nl}", graph_ms=case["graph_ms"],
                    maps_ms=case["maps_ms"])
            del table, got, want, again, out, tb, pout, ptb, out2, work
        rows["chain_axes_transpose"].setdefault("by_case", {}).update(
            {f"{name}, c={c}": {k_: record[f"transpose, {name}, c={c}"][k_] for k_ in
                                 ("ms", "graph_ms", "bound_ms", "transpose_apply_graph_ms")} for c in (1, 11)})
        del plan, tmap

    print("chain backward 14.2: the chain backward against the join backward (one forward each; the bounds of "
          "the gradients against JAX: cos 0.999, rel 2e-2) and twice bit for bit")
    for name, m, xs, ys, zs, _ in cases:
        chain = backward_routes(m, xs, ys, zs, "chain")
        chain2 = backward_routes(m, xs, ys, zs, "chain")
        join = backward_routes(m, xs, ys, zs, "join")
        c_ = cosine(chain["inv_ell"].cpu().numpy().astype(np.float64), join["inv_ell"].cpu().numpy().astype(np.float64))
        r_ell, r_s = rel(chain["inv_ell"], join["inv_ell"]), rel(chain["outputscale"], join["outputscale"])
        same = torch.equal(chain["inv_ell"], chain2["inv_ell"]) and torch.equal(chain["outputscale"],
                                                                               chain2["outputscale"])
        expect(c_ >= GRAD_COS and r_ell <= GRAD_REL and r_s <= GRAD_REL and same,
               f"{name}: the chain backward vs the join backward, d/d inv_ell cos {c_:.7f} (limit {GRAD_COS}) rel "
               f"{r_ell:.3e}, d/d outputscale rel {r_s:.3e} (limit {GRAD_REL}); two chain backwards bit-equal {same}; "
               f"CG iterations {chain['cg_iters']} / {join['cg_iters']}")
        record[f"routes, {name}"] = dict(inv_ell_cos=c_, inv_ell_rel=r_ell, outputscale_rel=r_s, bit_equal=same,
                                         chain_inv_ell=chain["inv_ell"].tolist(),
                                         join_inv_ell=join["inv_ell"].tolist(),
                                         chain_outputscale=float(chain["outputscale"]),
                                         join_outputscale=float(join["outputscale"]))
        del chain, chain2, join

    print("chain backward 14.3: launches in one training step (elevators, median init, exact mode)")
    counters = (K.lattice_geometry, K.lattice_dedup_neighbors, K.join_rows, K.lattice_apply_cols, K.lattice_apply,
                K.lattice_filter_grad, KC.chain_build, KC.chain_splat, KC.chain_axes, KC.chain_maps,
                KC.chain_axes_transpose, KC.chain_slice)
    opt = torch.optim.Adam(model.parameters(), lr=0.1)
    train_step(model, opt, x, y, z)  # warm-up
    model.load_raw({k_: tg[f"init_{k_}"] for k_ in RAW_NAMES})
    for fn in counters:
        fn.launches = 0
    train_step(model, opt, x, y, z)
    torch.cuda.synchronize()
    step = {fn.__name__: fn.launches for fn in counters}
    print(f"    launches: {step}")
    expect(step["lattice_dedup_neighbors"] == step["join_rows"] == step["lattice_apply_cols"] == 0
           and step["lattice_apply"] == 0 and step["lattice_geometry"] == step["chain_build"] == 1
           and step["chain_maps"] == step["chain_axes_transpose"] == step["lattice_filter_grad"] == 1,
           "the step's backward runs on the CG's chain plan: no join plan (K2, its rows), K9 or K3; one K1 and one "
           "K3'a (the CG's plan), one transposed chain apply (its maps, K3'c transposed) and one K5")
    record["training_step_launches"] = step
    return rows, step, record


def sparse_relevant_dims(name: str, seed: int = 0) -> np.ndarray:
    """The input dims ``utils/data.py::_synthetic_uci`` draws as relevant for ``<name>_sparse``, by replaying
    its draws in order (as tests/fixtures/make_elevators_sparse_screened_golden.py does)."""
    import zlib

    from simplex_gp_torch.utils.data import UCI_SHAPES

    n, d = UCI_SHAPES[name]
    rng = np.random.default_rng(zlib.crc32((name + "_sp").encode()) + seed)
    rng.normal(size=(50, d))
    rng.integers(0, 50, size=n)
    rng.normal(size=(n, d))
    rank = min(3, d)
    rng.normal(size=(d, rank))
    rng.normal(size=(rank,))
    return np.sort(rng.permutation(d)[: min(4, d)])


def screened_path_kernels() -> tuple:
    """The wrappers a screened posterior_cache and predict launch: K1, K2 and the row lists, K9, K6, K3'a-d,
    K10's seven kernels, and K3 (to be launched no time)."""
    from simplex_gp_torch.kernels import cg as K10
    from simplex_gp_torch.kernels import lattice as K
    from simplex_gp_torch.kernels.pivot import pivot_column

    return (K.lattice_geometry, K.lattice_dedup_neighbors, K.join_rows, K.lattice_apply_cols, K.lattice_apply,
            pivot_column, *chain_kernels(), K10.cg_dot, K10.cg_step_x, K10.cg_utr, K10.cg_fold, K10.cg_precond,
            K10.cg_step_p, K10.cg_init)


def screened_eval_stages(model, x, y, xv, seed: int, expect=None, y_val=None) -> dict:
    """One screened eval by stage, between CUDA events: the screening (the host read of the lengthscales and
    the column subset), the chain plan (K1 + K3'a), the preconditioner, the eval CG (graph-replayed), the range
    sketch (its own wide filter: a join plan and K9 by windows, or above _JOIN_MAX_ROWS the chunked chain) and
    the val predict, as posterior_cache_screened and predict_from_cache_screened run them.  Given ``expect``
    and the val targets, also K9's route for the sketch and the predict on the same inputs, held against the
    path's by :func:`wide_routes_check`, its times and peak beside the path's.  Returns (the stage times in ms
    with the eval CG's count, residual and ms an iteration, the peak device memory and the screened plan's
    occupancy and capacity; the chain plan)."""
    import torch

    from simplex_gp_torch.linalg import mll
    from simplex_gp_torch.linalg.cg import cg_solve
    from simplex_gp_torch.ops.filter import apply_plan_any, build_plan_any, lattice_filter_rect, make_wide_filter

    n = x.shape[0]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        ev[0].record()
        sub, _, keep = model.screened()
        idx = torch.from_numpy(keep).to(x.device)
        xs, xvs = x[:, idx], xv[:, idx]
        ev[1].record()
        params, dk, cfg = sub.constrained(), sub.dk, sub.bbmm
        ref = xs * params["inv_ell"]
        plan = build_plan_any(ref, dk, cfg.plan_capacity)
        ev[2].record()
        P = mll.build_precond(dk, cfg, params, ref, n)
        ev[3].record()
        s, noise = params["outputscale"], params["noise"]
        sol = cg_solve(lambda V: apply_plan_any(plan, V, dk), (y - params["mean"])[:, None],
                       tol=sub.eval_cg_tolerance, max_iters=cfg.max_cg_iterations, precond=P, shift=(s, noise),
                       graph=True)
        ev[4].record()
        peak = torch.cuda.max_memory_allocated() / 1e9
        omega = torch.randn((n, cfg.max_lanczos_iterations), generator=torch.Generator(device=x.device)
                            .manual_seed(seed), device=x.device)
        ref_val, alpha = xvs * params["inv_ell"], sol.x[:, :1]
        chain = sketch_and_predict(lambda: make_wide_filter(ref, dk, cfg.plan_capacity),
                                   lambda c, a, b: lattice_filter_rect(c, a, b, dk), params, omega, alpha, ref,
                                   ref_val)
    names = ("screen", "plan", "preconditioner", "eval_cg")
    stages = {nm: ev[i].elapsed_time(ev[i + 1]) for i, nm in enumerate(names)}
    stages.update(range_sketch=chain["range_sketch"], predict_val=chain["predict"])
    stages.update(eval_cg_iters=sol.iterations, eval_cg_ms_per_iteration=stages["eval_cg"] / max(sol.iterations, 1),
                  eval_cg_res=float(sol.residual_norm.mean()),
                  peak_gb=max(peak, chain["base_gb"] + chain["extra_peak_gb"]),
                  sketch_predict_extra_peak_gb=chain["extra_peak_gb"], screened_dims=len(keep),
                  plan_n_lattice=int(plan.n_lattice), plan_capacity=cfg.plan_capacity,
                  plan_rows=int(plan.cnt.shape[0]),
                  sketch_contribution_rows=n * (len(keep) + 1),
                  predict_contribution_rows=(n + xv.shape[0]) * (len(keep) + 1))
    if expect is not None:
        with torch.no_grad():
            chain_host = {k_: chain.pop(k_).cpu() for k_ in ("Y", "root_inv")}
            k9 = sketch_and_predict(lambda: k9_wide_filter(ref, dk, cfg.plan_capacity),
                                    lambda c, a, b: k9_rect(c, a, b, dk), params, omega, alpha, ref, ref_val)
            k9["Y"], k9["root_inv"] = k9["Y"].cpu(), k9["root_inv"].cpu()
            stages.update(range_sketch_k9=k9["range_sketch"], predict_val_k9=k9["predict"],
                          peak_gb_k9_route=max(peak, k9["base_gb"] + k9["extra_peak_gb"]),
                          sketch_predict_extra_peak_gb_k9=k9["extra_peak_gb"])
            cols = torch.cat([alpha, chain_host["root_inv"].to(x.device)], dim=-1)
            stages["routes"] = wide_routes_check(dict(chain, **chain_host), k9, cols, ref, ref_val, dk, y_val,
                                                 expect, "houseelectric_sparse screened eval")
    return stages, plan


def screened_slice(plan, dk, n: int, dev, expect, timer, name: str) -> dict:
    """K3'd on a screened chain plan (d'+1 columns of slice_idx: the kernel's generic path) and the chain
    apply, against their plain twins with torch.equal at c = 1 and 11, with K3'd's time and bound."""
    import torch

    from simplex_gp_torch.kernels import chain as KC
    from simplex_gp_torch.ops import lattice as L

    dp1 = plan.weights.shape[1]
    norm, taps = L.SLICE_NORM(dp1 - 1), [float(t) for t in dk.coeffs]
    gen = torch.Generator(device=dev).manual_seed(13)
    out = {"d_plus_1": dp1}
    for c in (1, 11):
        v = torch.randn((n, c), generator=gen, device=dev)
        table = KC.chain_splat_plain(plan, v)
        sk = KC.chain_slice(table, plan, norm)
        sp = KC.chain_slice_plain(table, plan.slice_idx, plan.weights, plan.n_lattice, norm)
        ak, ap = L.apply_plan_chain(plan, v, dk.coeffs), KC.chain_apply_plain(plan, v, taps, norm)
        same = [bool(torch.equal(sk, sp)), bool(torch.equal(ak, ap)), bool(torch.equal(ak, L.apply_plan_chain(
            plan, v, dk.coeffs)))]
        expect(all(same), f"{name} c={c}: K3'd at d'+1 = {dp1} (the generic path) torch.equal to its plain twin, "
               f"the chain apply to its plain twin and to a second apply {same}")
        out[f"c{c}"] = dict(slice_ms=timer(lambda: KC.chain_slice(table, plan, norm), 20),
                            slice_graph_ms=graph_ms(lambda: KC.chain_slice(table, plan, norm), 10),
                            slice_plain_ms=timer(lambda: KC.chain_slice_plain(table, plan.slice_idx, plan.weights,
                                                                              plan.n_lattice, norm), 3),
                            slice_bound_ms=bound(*slice_cost(plan, c))["bound_ms"],
                            apply_graph_ms=graph_ms(lambda: L.apply_plan_chain(plan, v, dk.coeffs), 10))
    return out


def run_entry_point(name: str, expect, fn):
    """``fn()``'s value, or None with the failure recorded (the phase goes on to the next entry point)."""
    import traceback

    try:
        return fn()
    except Exception:  # noqa: BLE001 -- any error of an entry point is this phase's failure
        traceback.print_exc()
        expect(False, f"{name} raised")
        return None


def screening_phase(dev, expect, timer):
    """Phase 13: ARD screening (the screened cache and predict, eval_checkpoint) and the last entry points.

    Returns (the screened path's launches, the record).
    """
    import os
    import pickle
    import tempfile

    import torch

    import simplex_gp_torch
    from simplex_gp_torch import asymptotics, convert, quality_gap
    from simplex_gp_torch import train as trainer
    from simplex_gp_torch.linalg.mll import BBMMConfig
    from simplex_gp_torch.models.components import init_raw_params
    from simplex_gp_torch.ops.lattice import count_lattice_points
    from simplex_gp_torch.utils import data

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    record = {}

    def sparse_model(raw, capacity=None):
        cfg = BBMMConfig(cg_tolerance=1.0, max_cg_iterations=500, max_lanczos_iterations=100, precond_rank=100,
                         num_probes=10, plan_capacity=capacity)
        model = simplex_gp_torch.SimplexGP(num_dims=raw["raw_lengthscale"].shape[0], kernel="matern", nu=1.5,
                                           order=1, min_noise=0.1, bbmm=cfg, eval_cg_tolerance=0.01,
                                           prune_thresh=PRUNE_THRESH, device=dev)
        return model.load_raw(raw)

    def metrics(mean, var, y_np):
        return trainer.regression_metrics(mean.cpu().numpy(), var.cpu().numpy(), y_np)

    # ---- 13.1 elevators_sparse at full width, against JAX -------------------------------------------------
    print("screening 13.1: elevators_sparse (10,623 rows, d = 18) screened at 0.3 vs the JAX golden file")
    golden = np.load(SPARSE_GOLDEN)
    ds = data.load_dataset("elevators_sparse")
    x, y = torch.from_numpy(ds.train_x).to(dev), torch.from_numpy(ds.train_y).to(dev)
    xt = torch.from_numpy(ds.test_x).to(dev)
    model = sparse_model({k: golden[k] for k in RAW_NAMES})
    model.predict_from_cache_screened(model.posterior_cache_screened(x, y, generator=torch.Generator(device=dev)),
                                      x, xt)  # warm
    kernels = screened_path_kernels()
    for fn in kernels:
        fn.launches = 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    cache = model.posterior_cache_screened(x, y, generator=torch.Generator(device=dev).manual_seed(0))
    ev[1].record()
    mean, var = model.predict_from_cache_screened(cache, x, xt)
    ev[2].record()
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in kernels}
    keep = cache["keep"]
    scr = metrics(mean, var, ds.test_y)
    full_cache = model.posterior_cache(x, y, generator=torch.Generator(device=dev).manual_seed(0))
    full = metrics(*model.predict_from_cache(full_cache, x, xt), ds.test_y)
    with torch.no_grad():
        sub = cache["sub"]
        occ = int(count_lattice_points(x[:, torch.from_numpy(keep).to(dev)] * sub.constrained()["inv_ell"],
                                       sub.dk.variance, sub.dk.coeffs))
    g_occ = int(golden["occupancy"])
    expect(keep is not None and np.array_equal(keep, golden["keep"]),
           f"kept dims {None if keep is None else keep.tolist()} (JAX {golden['keep'].tolist()})")
    expect(bool(torch.isfinite(mean).all() and (var > 0).all()) and mean.shape == (ds.test_x.shape[0],),
           "finite screened mean and positive variance, one per test row")
    expect(abs(scr["rmse"] - float(golden["rmse"])) <= RMSE_ATOL,
           f"screened test RMSE {scr['rmse']:.4f} vs JAX {float(golden['rmse']):.4f} (limit {RMSE_ATOL})")
    expect(abs(scr["nll"] - float(golden["nll"])) <= NLL_ATOL,
           f"screened test NLL {scr['nll']:.4f} vs JAX {float(golden['nll']):.4f} (limit {NLL_ATOL})")
    expect(abs(occ - g_occ) <= OCCUPANCY_REL * g_occ,
           f"screened occupancy (K8 at d' = {len(keep)}) {occ} vs JAX {g_occ} (rel limit {OCCUPANCY_REL})")
    expect(all(v > 0 for k_, v in launches.items() if k_ != "lattice_apply") and launches["lattice_apply"] == 0,
           f"every kernel of the screened path launched, K3 never: {launches}")
    print(f"  eval CG {cache['cg_iters']} iterations, residual {float(cache['cg_res']):.3e} (JAX "
          f"{int(golden['cg_iters'])}, {float(golden['cg_res']):.3e}); screened RMSE / NLL {scr['rmse']:.4f} / "
          f"{scr['nll']:.4f} against unscreened {full['rmse']:.4f} / {full['nll']:.4f} (JAX "
          f"{float(golden['rmse_unscreened']):.4f} / {float(golden['nll_unscreened']):.4f})")
    stages, plan = screened_eval_stages(model, x, y, torch.from_numpy(ds.val_x).to(dev), 8)
    record["elevators_sparse"] = dict(
        keep=keep.tolist(), rmse=scr["rmse"], nll=scr["nll"], unscreened=full,
        jax=dict(rmse=float(golden["rmse"]), nll=float(golden["nll"]), cg_iters=int(golden["cg_iters"]),
                 occupancy=g_occ, rmse_unscreened=float(golden["rmse_unscreened"]),
                 nll_unscreened=float(golden["nll_unscreened"])),
        cg_iters=cache["cg_iters"], cg_res=float(cache["cg_res"]), occupancy=occ,
        posterior_cache_ms=ev[0].elapsed_time(ev[1]), predict_ms=ev[1].elapsed_time(ev[2]), launches=launches,
        stages=stages, k3d=screened_slice(plan, model.dk, x.shape[0], dev, expect, timer, "elevators_sparse"))
    del cache, full_cache, plan, x, y, xt

    # ---- 13.2 houseelectric_sparse at full n through eval_checkpoint ------------------------------------------
    print("screening 13.2: houseelectric_sparse (1,311,539 rows, d = 11) through eval_checkpoint at 0.3")
    ds = data.load_dataset("houseelectric_sparse")
    n, d = ds.train_x.shape
    ell = trainer.median_lengthscale(ds.train_x)
    raw = init_raw_params(d, lengthscale=ell)
    relevant = torch.from_numpy(sparse_relevant_dims("houseelectric"))
    raw["raw_lengthscale"] = torch.full((d,), IRRELEVANT_RAW_LENGTHSCALE).index_copy(
        0, relevant, raw["raw_lengthscale"][relevant])
    with tempfile.TemporaryDirectory() as tmp:
        with open(pathlib.Path(tmp) / "model_final.pkl", "wb") as f:
            pickle.dump(convert.raw_params_to_numpy(raw), f)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "simplex_gp_torch.eval_checkpoint", "--run-dir", tmp,
                               "--dataset", "houseelectric_sparse", *SPARSE_FLAGS, "--plan-capacity", "-1",
                               "--prune-thresh", str(PRUNE_THRESH)],
                              capture_output=True, text=True, env=env, cwd=tmp, timeout=600)
        wall = time.perf_counter() - t0
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    expect(proc.returncode == 0, f"python -m simplex_gp_torch.eval_checkpoint exit code {proc.returncode} "
           f"({wall:.1f} s)")
    if proc.returncode != 0:
        print(proc.stderr[-3000:])
    by_key = {k_: line for line in lines for k_ in line}
    out = by_key.get("cache_ts", {})
    finite = bool(out) and all(np.isfinite(out[f"{sp}/{k_}"]) for sp in ("val", "test") for k_ in ("rmse", "nll"))
    screened = by_key.get("screened_dims")
    occ_line = by_key.get("screened_occupancy", {})
    cap = by_key.get("worst_case", {}).get("plan_capacity")
    expect(finite, f"eval_checkpoint's record finite: {out}")
    expect(screened == {"screened_dims": 4, "of": d}, f"eval_checkpoint's screened_dims line {screened}")
    expect(bool(occ_line) and occ_line["screened_occupancy"] <= occ_line["plan_capacity"],
           f"the screened occupancy at or below the capacity: {occ_line} (counted at d = {d}: "
           f"{by_key.get('worst_case')})")
    print("  eval_checkpoint: " + json.dumps(lines))

    x, y = torch.from_numpy(ds.train_x).to(dev), torch.from_numpy(ds.train_y).to(dev)
    xv = torch.from_numpy(ds.val_x).to(dev)
    model = sparse_model({k_: v.to(dev) for k_, v in raw.items()}, cap)
    omega = torch.randn((n, 100), generator=torch.Generator(device=dev).manual_seed(555), device=dev)
    for fn in kernels:
        fn.launches = 0
    cache = model.posterior_cache_screened(x, y, omega=omega)
    mean, var = model.predict_from_cache_screened(cache, x, xv)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in kernels}
    # Above _JOIN_MAX_ROWS (6.56M sketch rows, 8.2M predict rows at d' = 4) the wide filters run the chunked chain.
    join_route = ("lattice_dedup_neighbors", "join_rows", "lattice_apply_cols", "lattice_apply")
    expect(all(v > 0 for k_, v in launches.items() if k_ not in join_route)
           and not any(launches[k_] for k_ in join_route),
           f"every kernel of the screened path launched; K2, the join rows, K9 and K3 never: {launches}")
    sub, _, keep = model.screened()
    hand = sub.posterior_cache(x[:, torch.from_numpy(keep).to(dev)], y, omega=omega)
    same = {k_: bool(torch.equal(cache[k_], hand[k_])) for k_ in ("alpha", "root_inv")}
    expect(all(same.values()) and cache["cg_iters"] == hand["cg_iters"],
           f"the screened cache torch.equal to sub.posterior_cache on the hand-subset columns, the same omega: "
           f"{same}, CG iterations {cache['cg_iters']} / {hand['cg_iters']}")
    expect(bool(torch.isfinite(mean).all() and (var > 0).all()), "finite val mean and positive variance")
    del cache, hand
    stages, plan = screened_eval_stages(model, x, y, xv, 8, expect, torch.from_numpy(ds.val_y).to(dev))
    expect(stages["plan_n_lattice"] <= stages["plan_capacity"],
           f"the screened plan's occupancy {stages['plan_n_lattice']} at or below its capacity "
           f"{stages['plan_capacity']}")
    print("  stages (ms): " + json.dumps(stages))
    record["houseelectric_sparse"] = dict(
        eval_checkpoint=lines, eval_checkpoint_wall_s=wall, launches=launches, cache_equal=same,
        val=metrics(mean, var, ds.val_y), stages=stages, median_ell=ell, relevant=relevant.tolist(),
        k3d=screened_slice(plan, model.dk, n, dev, expect, timer, "houseelectric_sparse"))
    del plan, x, y, xv, mean, var, ds

    # ---- 13.3 the entry points ------------------------------------------------------------------------------
    print("screening 13.3: the entry points, each once and small")
    entry_points = {}
    with tempfile.TemporaryDirectory() as tmp:
        # The sweep's run, a process of its own, goes on while the in-process entry points run.
        t_sweep = time.perf_counter()
        sweep = subprocess.Popen([sys.executable, "-m", "simplex_gp_torch.sweep",
                                  str(ROOT / "configs" / "simplexgp.yml"), "--limit", "1", "--epochs", "1"],
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=tmp)
        try:
            t0 = time.perf_counter()
            summary = run_entry_point("train --prune-thresh 0.3", expect, lambda: trainer.main(
                ["--dataset", "elevators_sparse", *SPARSE_FLAGS, "--ls-init", "median", "--epochs", "2",
                 "--log-int", "1", "--prune-thresh", str(PRUNE_THRESH), "--out", tmp]))
            ok = summary is not None and len(summary["records"]) == 2 and all(
                np.isfinite(r["val/rmse"]) for r in summary["records"]) and np.isfinite(summary["final"]["test/rmse"])
            expect(ok, "simplex_gp_torch.train --prune-thresh 0.3: two epochs, each with its val record, and the "
                   "test record, finite")
            entry_points["train"] = dict(s=time.perf_counter() - t0, final=summary and summary["final"])
            t0 = time.perf_counter()
            records = run_entry_point("quality_gap", expect, lambda: quality_gap.main(
                ["--dataset", "elevators_sparse", *SPARSE_FLAGS, "--max-n", "2048", "--epochs", "5", "--ls-init",
                 "median", "--prune-thresh", str(PRUNE_THRESH), "--out", tmp]))
            combos = [r["combo"] for r in records or [] if "combo" in r]
            expect(len(combos) == 6 and all(np.isfinite(v) for r in records for v in r.values()
                                            if isinstance(v, float)),
                   f"simplex_gp_torch.quality_gap: six finite combos {combos}")
            entry_points["quality_gap"] = dict(s=time.perf_counter() - t0, records=records)
            t0 = time.perf_counter()
            asym = run_entry_point("asymptotics", expect, lambda: asymptotics.main([]))
            expect(asym is not None and np.isfinite(asym["exponent_n"]) and np.isfinite(asym["exponent_d"]),
                   f"simplex_gp_torch.asymptotics at its defaults: {asym}")
            entry_points["asymptotics"] = dict(s=time.perf_counter() - t0, record=asym)
            _, err = sweep.communicate(timeout=600)
        finally:
            if sweep.poll() is None:
                sweep.kill()
                sweep.wait()
        results = pathlib.Path(tmp) / "runs" / "torch" / "sweep_simplexgp" / "sweep_results.jsonl"
        recs = [json.loads(line) for line in results.read_text().splitlines()] if results.exists() else []
        expect(sweep.returncode == 0 and len(recs) == 1 and recs[0]["returncode"] == 0
               and np.isfinite((recs[0]["summary"] or {}).get("test/rmse", float("nan"))),
               f"python -m simplex_gp_torch.sweep configs/simplexgp.yml --limit 1 --epochs 1: exit code "
               f"{sweep.returncode}, {recs}")
        if sweep.returncode != 0:
            print(err[-3000:])
        entry_points["sweep"] = dict(s=time.perf_counter() - t_sweep, results=recs)
    for name, rec in entry_points.items():
        print(f"  {name}: {rec['s']:.1f} s")
    record["entry_points"] = entry_points
    return record


def chunked_chain_phase(dev, expect, timer):
    """Phase 15: the sort chain at the chunked chain's shapes, houseelectric at the median init.

    Two plans, as the eval builds them above _JOIN_MAX_ROWS: the range sketch's of the 1,311,539 training rows
    at the autotrimmed capacity (15.7M contributions), and the rect predict's of the 1,639,424 [train; val]
    rows, untrimmed (19.7M contributions).  Each K3'a build against its plain twin in every field; on each
    plan a block of 8 columns (JAX's width) and of 16 (the port's) through K3'b, the fused K3'c, K3'd, the
    maps and K3'c transposed, and the fused apply forward and transposed, each torch.equal to its plain
    twin, timed beside its bound; the block loop at c = 100 (101 for the predict) in blocks of 16 and of 8
    columns, torch.equal to each other and timed in turns, beside K9 on the join plan of the same positions
    and width.  Returns (the rows' entries by kernel, the
    record).
    """
    import torch

    from simplex_gp_torch import train as trainer
    from simplex_gp_torch.kernels import chain as KC
    from simplex_gp_torch.kernels import lattice as K
    from simplex_gp_torch.ops import filter as F
    from simplex_gp_torch.ops import lattice as L
    from simplex_gp_torch.ops.kernels import matern_kernel
    from simplex_gp_torch.utils import data

    ds = data.load_dataset("houseelectric")
    dk = matern_kernel(1.5, 1)
    ell = trainer.median_lengthscale(ds.train_x)
    xtr = (torch.from_numpy(ds.train_x).to(dev) / ell).contiguous()
    xjoint = torch.cat([xtr, torch.from_numpy(ds.val_x).to(dev) / ell]).contiguous()
    n, d = xtr.shape
    taps, norm, order = [float(t) for t in dk.coeffs], L.SLICE_NORM(d), dk.order
    E, a, _, _, consts = L._constants_on(d, order, float(dk.variance), L._device_key(dev))
    cap = trainer.trim_capacity(int(K.lattice_count(xtr, E, a)), n, d)
    gen = torch.Generator(device=dev).manual_seed(15)
    entries, record = {}, {}

    def entry(kernel, case, **fields):
        entries.setdefault(kernel, {})[case] = fields

    for case, pts, cp, wide in (("sketch", xtr, cap, 100), ("rect_predict", xjoint, None, 101)):
        rows_, N = pts.shape[0], pts.shape[0] * (d + 1)
        print(f"chunked chain 15 ({case}): {rows_} points, {N} contributions, capacity {cp}")
        h1, h2, w, sums = K.lattice_geometry(pts, E, a, with_s=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        kplan = KC.chain_build(h1, h2, sums, w, consts, taps, cp)
        torch.cuda.synchronize()
        build_extra_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        plan_gb = sum(t.numel() * t.element_size() for t in kplan) / 1e9
        pplan = KC.chain_build_plain(h1, h2, sums, w, consts, taps, cp)
        differ = [f for f in KC.ChainPlan._fields if not torch.equal(getattr(kplan, f), getattr(pplan, f))]
        nl, Mc = int(kplan.n_lattice), kplan.cnt.shape[0]
        live = min(nl, Mc)
        expect(not differ, f"{case}: K3'a == plain in every field at {N} contributions (n_lattice {nl}, Mc {Mc}, "
               f"{int(kplan.n_long)} runs past {KC.PIECE} in {int(kplan.n_pieces)} pieces); differing: {differ}")
        del pplan
        build_call = lambda: KC.chain_build(h1, h2, sums, w, consts, taps, cp)  # noqa: E731
        entry("chain_build", case, shape=f"N={N}, capacity {cp}, n_lattice {nl}", max_abs_err=len(differ),
              ms=timer(build_call, 3), plain_ms=timer(lambda: KC.chain_build_plain(h1, h2, sums, w, consts, taps, cp),
                                                      1),
              peak_extra_gb=build_extra_gb, plan_gb=plan_gb, stages=KC.chain_build_stage_times(build_call),
              **bound(*chain_build_cost(kplan)))
        del h1, h2, w, sums
        same, apply_ms = {}, {}
        for c in (8, 16):  # JAX's block width and the port's (F._WIDE_CHUNK)
            v, g = (torch.randn((rows_, c), generator=gen, device=dev) for _ in range(2))
            ks, ps = KC.chain_splat(kplan, v), KC.chain_splat_plain(kplan, v)
            ka, pa = KC.chain_axes(ks.clone(), kplan, taps), KC.chain_axes_plain(ps, kplan, taps)
            kd = KC.chain_slice(pa, kplan, norm)
            pd = KC.chain_slice_plain(pa, kplan.slice_idx, kplan.weights, kplan.n_lattice, norm)
            km, pm = KC.chain_maps(kplan), KC.chain_maps_plain(kplan.gather)
            kt = KC.chain_axes_transpose(ps.clone(), kplan, taps, km)
            pt = KC.chain_axes_transpose_plain(ps, kplan, taps, pm)
            fwd_k, fwd_p = L.apply_plan_chain(kplan, v, dk.coeffs), KC.chain_apply_plain(kplan, v, taps, norm)
            tr_k = L.apply_plan_chain(kplan, g, dk.coeffs, transpose=True)
            tr_p = KC.chain_apply_plain(kplan, g, taps, norm, transpose=True)
            same[c] = dict(splat=torch.equal(ks[:live], ps[:live]), axes=torch.equal(ka[:live], pa[:live]),
                           slice=torch.equal(kd, pd), maps=torch.equal(km, pm),
                           axes_transpose=torch.equal(kt[:live], pt[:live]), apply=torch.equal(fwd_k, fwd_p),
                           apply_transpose=torch.equal(tr_k, tr_p))
            expect(all(same[c].values()), f"{case}, c = {c}: each chain kernel torch.equal to its plain twin "
                   f"{same[c]}")
            shape = f"houseelectric {case}, n={rows_}, c={c}, n_lattice {nl} of Mc {Mc}"
            key = f"{case}_c{c}"
            buf = ks.clone()  # the fused axes overwrite their input: timed on one scratch table
            entry("chain_splat", key, shape=shape, max_abs_err=float((ks[:live] - ps[:live]).abs().max()),
                  ms=timer(lambda: KC.chain_splat(kplan, v), 10),
                  plain_ms=timer(lambda: KC.chain_splat_plain(kplan, v), 1), **bound(*splat_cost(kplan, c)))
            entry("chain_axes", key, shape=shape, max_abs_err=float((ka[:live] - pa[:live]).abs().max()),
                  ms=timer(lambda: KC.chain_axes(buf, kplan, taps), 10),
                  plain_ms=timer(lambda: KC.chain_axes_plain(ps, kplan, taps), 1),
                  **bound(*axes_cost(live, d, c, order)))
            entry("chain_slice", key, shape=shape, max_abs_err=float((kd - pd).abs().max()),
                  ms=timer(lambda: KC.chain_slice(pa, kplan, norm), 10),
                  plain_ms=timer(lambda: KC.chain_slice_plain(pa, kplan.slice_idx, kplan.weights, kplan.n_lattice,
                                                              norm), 1), **bound(*slice_cost(kplan, c)))
            entry("chain_axes_transpose", key, shape=shape, max_abs_err=float((kt[:live] - pt[:live]).abs().max()),
                  ms=timer(lambda: KC.chain_axes_transpose(buf, kplan, taps, km), 10),
                  plain_ms=timer(lambda: KC.chain_axes_transpose_plain(ps, kplan, taps, pm), 1),
                  **bound(*axes_transpose_cost(live, d, c, order)))
            apply_ms[c] = dict(ms=timer(lambda: L.apply_plan_chain(kplan, v, dk.coeffs), 10),
                               graph_ms=graph_ms(lambda: L.apply_plan_chain(kplan, v, dk.coeffs), 5))
            del ks, ps, ka, pa, kd, pd, km, pm, kt, pt, fwd_k, fwd_p, tr_k, tr_p, v, g, buf
        # The block loop at the width the eval applies, in blocks of 16 columns (the path's) and of 8 (JAX's) in
        # turns 16, 8, 8, 16, and K9 on the join plan.
        V = torch.randn((rows_, wide), generator=gen, device=dev)
        path_width = F._WIDE_CHUNK

        def blocks(width):
            try:
                F._WIDE_CHUNK = width
                return F._apply_chain_blocks(kplan, V, dk.coeffs)
            finally:
                F._WIDE_CHUNK = path_width

        out16, out8 = blocks(16), blocks(8)
        equal_widths = torch.equal(out16, out8)
        expect(equal_widths, f"{case}, c = {wide}: the blocks of 8 and of 16 columns torch.equal")
        del out8
        times = {16: [], 8: []}
        for width in (16, 8, 8, 16):
            times[width].append(timer(lambda: blocks(width), 3))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        F._apply_chain_blocks(kplan, V, dk.coeffs)
        torch.cuda.synchronize()
        blocks_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        jplan = L.build_wide_plan_join(pts, dk.coeffs, dk.variance, cp)
        k9 = lambda: L.apply_plan_cols(jplan, V, dk.coeffs, F._WIDE_CHUNK)  # noqa: E731
        r9 = rel(out16, k9())
        expect(r9 <= LARGE_N_REL, f"{case}, c = {wide}: the chunked chain vs K9 on the join plan rel {r9:.3e} "
               f"(limit {LARGE_N_REL})")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        k9()
        torch.cuda.synchronize()
        k9_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        k9_ms = timer(k9, 3)
        record[case] = dict(points=rows_, contributions=N, capacity=cp, n_lattice=nl, rows=Mc, bit_equal=same,
                            apply_ms=apply_ms, width=wide, blocks16_ms=times[16], blocks8_ms=times[8],
                            blocks_equal=equal_widths, blocks_extra_peak_gb=blocks_gb, k9_ms=k9_ms,
                            k9_extra_peak_gb=k9_gb, k9_rel=r9, build_ms=entries["chain_build"][case]["ms"],
                            plan_gb=plan_gb)
        print(f"    {case}: K3'a {entries['chain_build'][case]['ms']:.3f} ms (plain "
              f"{entries['chain_build'][case]['plain_ms']:.3f}; peak above the inputs {build_extra_gb:.3f} GB, the "
              f"plan {plan_gb:.3f} GB); the apply at c = 8 / 16 {apply_ms[8]['ms']:.4f} / {apply_ms[16]['ms']:.4f} ms "
              f"(graph {apply_ms[8]['graph_ms']:.4f} / {apply_ms[16]['graph_ms']:.4f}); c = {wide}: blocks of 16 "
              f"{times[16]} ms, of 8 {times[8]} ms (torch.equal {equal_widths}), K9 {k9_ms:.3f} ms (rel {r9:.2e}); "
              f"peak above the inputs: blocks of 16 {blocks_gb:.3f} GB, K9 {k9_gb:.3f} GB")
        del kplan, jplan, V, out16
    return entries, record


def train_step(model, opt, x, y, z):
    opt.zero_grad(set_to_none=True)
    model.nlml(x, y, probes=z).backward()
    opt.step()


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ranks", type=int, default=1,
                        help="P > 1: only phase 7.3-7.5, over P NCCL ranks, one per card (needs P cards)")
    args = parser.parse_args(argv)
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

    t_start = time.perf_counter()
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
    if args.ranks > 1:
        _, _, par = ranks_phase(dev, ds, expect, args.ranks, "nccl")
        print("parallel: " + json.dumps(par))
        return finish(t_start, failures, card, None)
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
    print("K1 lattice_geometry (a team of lanes a point) vs plain and vs the first kernel (a thread a point)")
    a = torch.from_numpy(L._hash_vectors(d)).to(dev)
    E = torch.from_numpy(L.build_rotation(d, dk.variance)).to(dev)
    errs = []
    for name, pts in (("train", ref), ("joint", joint)):
        kh1, kh2, kw, ks = K.lattice_geometry(pts, E, a, with_s=True)
        ph1, ph2, pw, ps = K.geometry_plain(pts, E, a, with_s=True)
        th = K._geometry_per_thread(pts, E, a, with_s=True)
        same = [torch.equal(u.reshape(-1), v.reshape(-1)) for u, v in zip((kh1, kh2, kw, ks), (ph1, ph2, pw, ps))]
        same_thread = [torch.equal(u.reshape(-1), v.reshape(-1)) for u, v in zip((kh1, kh2, kw, ks), th)]
        expect(all(same) and all(same_thread), f"{name}: K1 h1, h2, w, s torch.equal to plain {same} and to the "
               f"per-thread kernel {same_thread}")
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
        graph_ms=graph_ms(lambda: K.lattice_geometry(ref, E, a), 10),
        per_thread_ms=cuda_ms(lambda: K._geometry_per_thread(ref, E, a), 20),
        per_thread_graph_ms=graph_ms(lambda: K._geometry_per_thread(ref, E, a), 10),
        plain_ms=cuda_ms(lambda: K.geometry_plain(ref, E, a), 5),
        **bound(4 * n * d + 12 * n * (d + 1), geometry_ops(n, d)),  # x in; h1, h2, weights out
        library_ms=None,
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
            k2_case, train_nl = (h1, h2), int(knl)
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
        **bound(dedup_bytes(h1.shape[0], h1.shape[0], d + 1, order), 0),
        library_ms=None,
        # torch.unique with the inverse: the seg ids alone, not the neighbours.
        unique_ms=cuda_ms(lambda: torch.unique(K._pack(h1, h2), return_inverse=True), 5),
        shape=f"N={h1.shape[0]} hash pairs",
    )
    rows["lattice_apply"] = dict(
        max_abs_err=k3_err, ms=k3_ms[1], plain_ms=k3_plain_ms[1],
        **bound(*apply_cost(n, d, 1, train_nl, order)), library_ms=None,
        shape=f"train, c=1, n_lattice={train_nl}", ms_by_c=k3_ms, plain_ms_by_c=k3_plain_ms,
        bound_ms_by_c={c: bound(*apply_cost(n, d, c, train_nl, order))["bound_ms"] for c in (1, 100)},
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
        # ref, L[:, :j] and the diagonal in; L[:, j] and the diagonal out; d2, the kernel, the dot.
        **bound(4 * (n * d + n * (k - 1) + 3 * n), n * (3 * d + 2 * (k - 1) + 12)),
        library_ms=None,
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
    slice_kernels = (K.lattice_geometry, K.lattice_dedup_neighbors, K.lattice_apply, K.join_rows, K.lattice_apply_cols,
                     pivot_column, *chain_kernels())
    for fn in slice_kernels:
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
    launches = {fn.__name__: fn.launches for fn in slice_kernels}
    launches_slice = dict(launches)
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
    expect(all(v > 0 for k_, v in launches.items() if k_ != "lattice_apply") and launches["lattice_apply"] == 0,
           "every kernel of the slice launched, K3 never")
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
    route = (K.lattice_apply, K.lattice_apply_cols, K.join_rows)
    before = [fn.launches for fn in route]
    again = model.posterior_cache(x, y, generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    route = {fn.__name__: fn.launches - b for fn, b in zip(route, before)}
    # The range sketch's two MVMs run K9 by windows on the join plan's row lists (one build), never K3.
    expect(route == {"lattice_apply": 0, "lattice_apply_cols": 2, "join_rows": 1},
           f"posterior_cache's range sketch: launches {route} (K3 0, K9 2, one row build)")
    cache_repeats = {k_: bool(torch.equal(cache[k_], again[k_])) for k_ in ("alpha", "root_inv")}
    expect(all(cache_repeats.values()) and again["cg_iters"] == cache["cg_iters"],
           f"posterior_cache twice: alpha and root_inv bit-equal {cache_repeats}, CG iterations "
           f"{cache['cg_iters']} / {again['cg_iters']}")
    del again
    sketch = sketch_apply(dev, ref, dk, expect)
    print("  range sketch: " + json.dumps(sketch))

    t_train = time.perf_counter()
    rows["lattice_filter_grad"], training = training_phase(dev, ds, expect, cuda_ms)
    launches["lattice_filter_grad"] = training["trainer_launches"]["lattice_filter_grad"]
    launches["slq_quadrature"] = training["trainer_launches"]["slq_quadrature"]
    rows["slq_quadrature"] = dict(training["slq"], record_100=training["slq_100"])
    print(f"training phase: {time.perf_counter() - t_train:.1f} s")
    print("training: " + json.dumps(training))

    t_once = time.perf_counter()
    once_rows, once_launches, oneshot = oneshot_phase(dev, ds, expect, cuda_ms)
    rows.update(once_rows)
    launches.update(once_launches)
    print(f"one-shot phase: {time.perf_counter() - t_once:.1f} s")
    print("one-shot: " + json.dumps(oneshot))

    t_large = time.perf_counter()
    large_rows, large_launches, large = large_n_phase(dev, expect, cuda_ms)
    rows.update(large_rows)
    # K9 and the join rows launch on the elevators slice (its range sketch); at houseelectric the wide filters run
    # the chunked chain, and no path of the script's trims a join plan (the bounded K2: 0).
    launches["lattice_dedup_neighbors_bounded"] = large_launches["lattice_dedup_neighbors_bounded"]
    for name in ("lattice_apply_cols", "join_rows"):
        rows[name]["houseelectric_trainer_launches"] = large_launches[name]
    rows["lattice_filter_grad"]["houseelectric"] = large["k5"]
    rows["slq_quadrature"]["houseelectric"] = large["slq"]
    print(f"large-n phase: {time.perf_counter() - t_large:.1f} s")
    print("large n: " + json.dumps(large))

    t_par = time.perf_counter()
    par_rows, par_launches, par = parallel_phase(dev, ds, expect, cuda_ms)
    rows.update(par_rows)
    launches.update({k: par_launches[k] for k in par_rows})
    print(f"parallel phase: {time.perf_counter() - t_par:.1f} s")
    print("parallel: " + json.dumps(par))

    t_mix = time.perf_counter()
    rows["lattice_mixture_apply"], launches["lattice_mixture_apply"], mix = mixture_phase(dev, ds, expect, cuda_ms)
    print(f"mixture phase: {time.perf_counter() - t_mix:.1f} s")
    print("mixture: " + json.dumps(mix))

    t_base = time.perf_counter()
    base_rows, base_launches, base = baselines_phase(dev, expect, cuda_ms)
    rows.update(base_rows)
    launches.update(base_launches)
    print(f"baselines phase: {time.perf_counter() - t_base:.1f} s")
    print("baselines: " + json.dumps(base))

    t_chain = time.perf_counter()
    stage_times = {
        "elevators warm training step, exact (ms)": dict(step=training.get("step_ms"), **training.get("stages", {})),
        "elevators serving eval (ms)": dict(posterior_cache=cache_ms, predict=predict_ms, eval_cg_iters=cache["cg_iters"]),
        "houseelectric warm training step, capacity 32,768 (ms)": large["step_stages"],
        "houseelectric eval (ms)": large["eval_stages"]}
    chain_rows, chain_launches, chain = chain_phase(dev, ds, expect, cuda_ms, stage_times)
    rows.update(chain_rows)
    rows["lattice_geometry"]["by_case_with_s"] = {nm: c_["k1"] for nm, c_ in chain.items()
                                                   if isinstance(c_, dict) and "k1" in c_}
    launches.update(chain_launches)
    print(f"chain phase: {time.perf_counter() - t_chain:.1f} s")
    print("chain: " + json.dumps(chain))

    t_cg = time.perf_counter()
    cg_rows, cg_launches, cg_record = cg_phase(dev, ds, expect, cuda_ms)
    for name, row in cg_rows.items():
        rows[name] = {"library_ms": None, "shape": f"elevators training CG, n={n}, c=11", **row}
        launches[name] = cg_launches[name]
    print(f"cg phase: {time.perf_counter() - t_cg:.1f} s")
    print("cg: " + json.dumps(cg_record))

    t_fa = time.perf_counter()
    fa_rows, _, fa_record = factor_axes_phase(dev, ds, expect, cuda_ms)
    for name, row in fa_rows.items():
        rows.setdefault(name, {}).update(row)
    print(f"factor and axes phase: {time.perf_counter() - t_fa:.1f} s")
    print("factor and axes: " + json.dumps(fa_record))

    t_scr = time.perf_counter()
    screening = screening_phase(dev, expect, cuda_ms)
    print(f"screening and entry points phase: {time.perf_counter() - t_scr:.1f} s")
    print("screening: " + json.dumps(screening))

    t_back = time.perf_counter()
    back_rows, back_launches, back_record = chain_backward_phase(dev, ds, expect, cuda_ms)
    rows.update(back_rows)
    launches["chain_axes_transpose"] = back_launches["chain_axes_transpose"]
    print(f"chain backward phase: {time.perf_counter() - t_back:.1f} s")
    print("chain backward: " + json.dumps(back_record))

    t_chunk = time.perf_counter()
    chunk_entries, chunk_record = chunked_chain_phase(dev, expect, cuda_ms)
    for name, by_case in chunk_entries.items():
        rows[name]["chunked_chain"] = by_case
    print(f"chunked chain phase: {time.perf_counter() - t_chunk:.1f} s")
    print("chunked chain: " + json.dumps(chunk_record))

    # One iteration's time (the MVM included) from the stage times of 4.5 and 6.5, against the bound of
    # K10's vector updates and the Woodbury solve's two reads of U.
    k10 = {}
    for tag, stage_ms, iters, n_, c_ in (
            ("elevators training, c=11", training["stages"]["cg"], training["stages"]["cg_iters"], n, 11),
            ("houseelectric eval, c=1", large["eval_stages"]["eval_cg"], large["eval_stages"]["eval_cg_iters"],
             large["houseelectric_n"], 1)):
        k10[tag] = dict(iteration_ms=stage_ms / iters, iterations=iters,
                        **bound(cg_iteration_bytes(n_, c_, 100), 0))
    print("K10 cg iteration: " + json.dumps(k10))

    # The sort chain's kernels on the two gloo ranks' data-parallel NLML step (phase 7.3), beside their
    # launches in one single-device training step (the row's own count).
    for name in ("lattice_geometry", "chain_build", "chain_splat", "chain_axes", "chain_axes_transpose", "chain_slice",
                 "lattice_filter_grad"):
        rows[name]["dp_step_launches"] = par["launches"][name]
    kernels = []
    for name, (source, replaces) in KERNEL_ROWS.items():
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=launches[name], **rows[name]))
    print("slice: " + json.dumps(dict(
        posterior_cache_ms=cache_ms, predict_ms=predict_ms, cg_iters=cache["cg_iters"],
        cg_res=float(cache["cg_res"]), rmse=rmse, nll=nll, mean_rms_diff=mean_rms,
        predict_max_abs_diff=dpred, slice_launches=launches_slice, posterior_cache_launches=route,
        posterior_cache_repeats=cache_repeats, range_sketch=sketch)))
    return finish(t_start, failures, card, kernels)


def finish(t_start, failures, card, kernels) -> int:
    """The closing lines: the time, then the failures (exit 1) or the kernels line, the card and ok."""
    import torch

    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the kernel build included")
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed:", *failures, sep="\n  ", file=sys.stderr)
        return 1
    if kernels is not None:
        print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
