"""Predict requests against one cache built in set-up: each predict_from_cache of a batch of held-out rows,
results on the host."""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import counts as C
from ..cell import Cell, pred_gaps, sample
from ..data import seed_of
from ..reference import gp as RG
from ..reference.lattice import tf32, vertex_hashes

__all__ = ["Driver"]


class Driver(Cell):
    def setup(self) -> None:
        self._data()
        self.point = self.points[0]
        self.model = self._model()
        self.model.load_raw(self.point)
        self.m = min(self.cfg["root_rank"], self.x.shape[0])
        g = torch.Generator(device=self.dev).manual_seed(seed_of(self.seed, "omega"))
        self.omega_state = g.get_state()
        with self.span("posterior_cache"):
            self.cache = self.model.posterior_cache(
                self.x, self.y, omega=torch.randn((self.x.shape[0], self.m), generator=g, device=self.dev))
        self.pool = torch.cat([self.data[f"{s}_x"] for s in self.traffic["pool"]])
        b = self.traffic["batch"]
        self.sizes = np.unique(np.round(np.exp(np.linspace(np.log(b["min"]), np.log(b["max"]), b["sizes"])))
                               ).astype(np.int64)
        self.rng = np.random.default_rng(seed_of(self.seed, "batches"))
        self.gpool = torch.Generator(device=self.dev).manual_seed(seed_of(self.seed, "pool"))
        self.queue, self.perm, self.ptr = [], None, self.pool.shape[0]
        for bsz in sorted(self.sizes)[::-1][:self.traffic["warm"]]:
            self.request(self._rows(int(bsz)))
        self.records.clear()

    def _rows(self, bsz: int) -> torch.Tensor:
        """The next ``bsz`` pool rows of a permutation drawn from the seed, a new one when it runs out."""
        if self.ptr + bsz > self.pool.shape[0]:
            self.perm = torch.randperm(self.pool.shape[0], generator=self.gpool, device=self.dev)
            self.ptr = 0
        rows = self.perm[self.ptr:self.ptr + bsz]
        self.ptr += bsz
        return rows

    def request(self, rows: torch.Tensor) -> dict:
        t0 = time.perf_counter()
        with self.span("request"):
            mean, var = self.model.predict_from_cache(self.cache, self.x, self.pool[rows])
            mean, var = mean.cpu(), var.cpu()
        rec = {"rows": rows, "mean": mean, "var": var, "latency": time.perf_counter() - t0}
        self.records.append(rec)
        return rec

    def op(self) -> bool:
        if not self.queue:
            self.queue = self.rng.permutation(self.sizes).tolist()
        rec = self.request(self._rows(int(self.queue.pop())))
        return bool(torch.isfinite(rec["mean"]).all() and torch.isfinite(rec["var"]).all())

    def costs(self, idx) -> list:
        c, n, d = self.cfg, self.x.shape[0], self.cfg["d"]
        inv = self._params(self.point)["inv_ell"]
        train = vertex_hashes(self.x * inv, self.variance)
        out = []
        for i in idx:
            rows = self.records[i]["rows"]
            new = vertex_hashes(self.pool[rows] * inv, self.variance)
            found = train[torch.searchsorted(train, new).clamp(max=train.shape[0] - 1)] == new
            nl, b = train.shape[0] + int((~found).sum()), rows.shape[0]
            N, blocks = (n + b) * (d + 1), [min(16, 1 + self.m - c0) for c0 in range(0, 1 + self.m, 16)]
            splat = [C.splat_cost(N, n + b, cb, nl) for cb in blocks]
            out.append({"total": C.predict_cost(n, d, b, nl, self.m, c["order"]),
                        "splat": (sum(s[0] for s in splat), sum(s[1] for s in splat))})
        return out

    def _omega(self) -> torch.Tensor:
        g = torch.Generator(device=self.dev)
        g.set_state(self.omega_state)
        return torch.randn((self.x.shape[0], self.m), generator=g, device=self.dev)

    def program_records(self) -> dict:
        return {"alpha": self.cache["alpha"],
                "requests": {i: self.records[i] for i in sample(self.seed, self.traffic["sample"], len(self.records))}}

    def control_records(self) -> dict:
        """The cache and the sampled requests made by the reference with every product's operands in TF32."""
        p = self._params(self.point)
        alpha, _, R = RG.posterior(self.cfg, self.taps, self.variance, p, self.x, self.y, self._omega(), tf32)
        reqs = {}
        for i in sample(self.seed, self.traffic["sample"], len(self.records)):
            mean, var = RG.predict(self.taps, self.variance, p, self.x, self.pool[self.records[i]["rows"]], alpha, R,
                                   tf32)
            reqs[i] = {"mean": mean, "var": var}
        return {"alpha": alpha, "requests": reqs}

    def check(self, prog: dict) -> dict:
        """Each sampled request's means from the cache's alpha and its variances against the reference's (its own
        root).  The alpha is the program's: its residual gap is not compared here, since the eval CG stalls at
        this size and the gap then does not tell float32 from TF32 (elevators.cache compares it)."""
        p = self._params(self.point)
        R = RG.root(self.cfg, self.taps, self.variance, p, self.x, self._omega())
        mg, vg = [], []
        for i, req in prog["requests"].items():
            mean, var = RG.predict(self.taps, self.variance, p, self.x, self.pool[self.records[i]["rows"]],
                                   prog["alpha"], R)
            a, b = pred_gaps(req["mean"], req["var"], mean, var, p["mean"])
            mg.append(a)
            vg.append(b)
        return {"mean_gap": max(mg), "var_gap": max(vg)}
