"""Posterior fits: posterior_cache with the benchmark's Omega, then predict_from_cache of the test rows, results on
the host; each fit at the next point of the replayed trajectory times a jitter drawn from the seed."""

from __future__ import annotations

import numpy as np
import torch

from .. import counts as C
from ..cell import Cell, pred_gaps, sample
from ..data import seed_of
from ..reference import gp as RG
from ..reference.lattice import tf32, vertex_count

__all__ = ["Driver"]


class Driver(Cell):
    def setup(self) -> None:
        self._data()
        self.model = self._model()
        self.gomega = torch.Generator(device=self.dev).manual_seed(seed_of(self.seed, "omega"))
        self.m = min(self.cfg["root_rank"], self.x.shape[0])
        for _ in range(self.traffic["warm"]):
            self.fit(self._next_raw())
        self.records.clear()
        self.span.counters.clear()

    def fit(self, raw: dict) -> dict:
        state = self.gomega.get_state()
        with self.span("fit"):
            self.model.load_raw(raw)
            omega = torch.randn((self.x.shape[0], self.m), generator=self.gomega, device=self.dev)
            with self.span("posterior_cache"):
                cache = self.model.posterior_cache(self.x, self.y, omega=omega)
            with self.span("predict"):
                mean, var = self.model.predict_from_cache(cache, self.x, self.data["test_x"])
                mean, var = mean.cpu(), var.cpu()
        self.span.count("cg_iters", cache["cg_iters"])
        rec = {"raw": raw, "omega": state, "alpha": cache["alpha"], "res": cache["cg_res"], "mean": mean, "var": var}
        self.records.append(rec)
        return rec

    def op(self) -> bool:
        rec = self.fit(self._next_raw())
        return bool(torch.isfinite(rec["mean"]).all() and torch.isfinite(rec["var"]).all())

    def costs(self, idx) -> list:
        c, n, d = self.cfg, self.x.shape[0], self.cfg["d"]
        out = []
        for i in idx:
            inv = self._params(self.records[i]["raw"])["inv_ell"]
            nl = vertex_count(self.x * inv, self.variance)
            nlr = vertex_count(torch.cat([self.x, self.data["test_x"]]) * inv, self.variance)
            it = self.span.counters["cg_iters"][i]
            out.append({"total": C.fit_cost(n, d, self.data["test_x"].shape[0], nl, nlr, it, c["precond_rank"],
                                            self.m, c["order"])})
        return out

    def _sample(self) -> list:
        return sample(self.seed, self.traffic["sample"], len(self.records))

    def _omega(self, rec) -> torch.Tensor:
        g = torch.Generator(device=self.dev)
        g.set_state(rec["omega"])
        return torch.randn((self.x.shape[0], self.m), generator=g, device=self.dev)

    def program_records(self) -> dict:
        return {i: self.records[i] for i in self._sample()}

    def control_records(self) -> dict:
        """The sampled fits made by the reference with every product's operands in TF32."""
        out = {}
        for i in self._sample():
            rec = self.records[i]
            p = self._params(rec["raw"])
            alpha, res, R = RG.posterior(self.cfg, self.taps, self.variance, p, self.x, self.y, self._omega(rec), tf32)
            mean, var = RG.predict(self.taps, self.variance, p, self.x, self.data["test_x"], alpha, R, tf32)
            out[i] = {"alpha": alpha, "res": res, "mean": mean, "var": var}
        return out

    def check(self, prog: dict) -> dict:
        """Each sampled fit: its alpha's residual under the reference's operator against the residual it
        claims (``res_gap``) and against the best that the reference's own eval CG reaches under the same stop
        rule (``cg_excess``: the two residuals' ratio less 1, each taken at no less than ``eval_cg_tolerance``,
        so a CG that met the tolerance reads 0; the median over the sampled fits, since a stalled CG's best
        residual follows rounding and the widest fit of sound runs swings past the lightest TF32 one); its
        means from its alpha and its variances against the reference's (its own root)."""
        res, best, mg, vg = [], [], [], []
        tol = self.cfg["eval_cg_tolerance"]
        for i, fit in prog.items():
            rec = self.records[i]
            p = self._params(rec["raw"])
            R = RG.root(self.cfg, self.taps, self.variance, p, self.x, self._omega(rec))
            mean, var = RG.predict(self.taps, self.variance, p, self.x, self.data["test_x"], fit["alpha"], R)
            true = RG.residual(self.taps, self.variance, p, self.x, self.y, fit["alpha"])
            res.append(abs(true - float(fit["res"])))
            ref_best = RG.solve(self.cfg, self.taps, self.variance, p, self.x, self.y)[1]
            best.append(max(true, tol) / max(ref_best, tol) - 1.0)
            a, b = pred_gaps(fit["mean"], fit["var"], mean, var, p["mean"])
            mg.append(a)
            vg.append(b)
        return {"res_gap": max(res), "cg_excess": float(np.median(best)), "mean_gap": max(mg), "var_gap": max(vg)}
