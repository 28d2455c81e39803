"""Time the plan and apply kernels at the elevators shapes, for an A/B between two trees.

    PYTHONPATH=<tree> python simplex_gp_torch/kernel_times.py

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
    main()
