"""Trainer steps: train.py's step (zero_grad, SimplexGP.nlml with the benchmark's probes, backward, Adam, the
loss read back), each from the next point of the replayed trajectory times a jitter drawn from the seed; Adam's
state carries over.  The first ``check_steps`` run in set-up through the same call and are the ones the
reference follows; every step's CG is held to its stop rule by the program's own counters."""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import counts as C
from ..cell import Cell, rademacher, rel_norm_gap, spy, to_torch
from ..data import seed_of
from ..reference import gp as RG
from ..reference.lattice import tf32, vertex_count
from ..reference.solver import FLOOR

__all__ = ["Driver"]

_CG = ("simplex_gp_torch.linalg.cg", "cg_solve")
_PIVOTS = ("simplex_gp_torch.linalg.pivoted_cholesky", "pivoted_cholesky_features")


class Driver(Cell):
    def setup(self) -> None:
        self._data()
        self.model = self._model()
        self.opt = torch.optim.Adam(self.model.parameters(), lr=self.cfg["lr"])
        self.gprobe = torch.Generator(device=self.dev).manual_seed(seed_of(self.seed, "probes"))
        self.checked = []
        cpu = lambda t: t.detach().cpu()
        for k in range(self.traffic["check_steps"]):
            raw, state = self._next_raw(), self.gprobe.get_state()
            with spy(*_PIVOTS, lambda pc: cpu(pc.pivots)) as pivots, \
                    spy(*_CG, lambda r: (cpu(r.x), cpu(r.residual_norm), r.iterations, cpu(r.alphas[:, 1:]),
                                         cpu(r.betas[:, 1:]), cpu(r.tmask[:, 1:]))) as solves:
                loss = self.step(raw)
            x, res, iters, *record = solves[-1]
            rec = {"raw": raw, "probes": state, "loss": loss, "pivots": pivots[-1], "solves": x, "res": res,
                   "iters": iters, "record": record}
            if k == 0:  # the first gradient as Adam holds it: exp_avg = (1 - beta1) g (none: it got none)
                b1 = self.opt.defaults["betas"][0]
                rec["grad"] = {n: self.opt.state[p].get("exp_avg", torch.zeros_like(p)).detach().clone() / (1 - b1)
                               for n, p in self.model.raw().items()}
            rec["after"] = {n: p.detach().clone() for n, p in self.model.raw().items()}
            self.checked.append(rec)

    def step(self, raw: dict) -> float:
        m, stats = self.model, {}
        with self.span("step"):
            m.load_raw(raw)
            self.opt.zero_grad(set_to_none=True)
            probes = rademacher(self.x.shape[0], self.cfg["num_probes"], self.gprobe, self.dev)
            with self.span("nlml"):
                loss = m.nlml(self.x, self.y, probes=probes, stats=stats)
            with self.span("backward"):
                loss.backward()
            with self.span("adam"):
                self.opt.step()
            value = float(loss.detach())
        self.span.count("cg_iters", stats["cg_iters"])
        self.span.count("cg_res", stats["cg_res"])
        return value

    def op(self) -> bool:
        raw = self._next_raw()
        loss = self.step(raw)
        self.records.append(raw)
        return math.isfinite(loss)

    def costs(self, idx) -> list:
        c, n, d = self.cfg, self.x.shape[0], self.cfg["d"]
        out = []
        for i in idx:
            nl = vertex_count(self.x * self._params(self.records[i])["inv_ell"], self.variance)
            it = self.span.counters["cg_iters"][i]
            N, live, cols = n * (d + 1), min(nl, c["plan_capacity"] or n * (d + 1)), c["num_probes"] + 1
            out.append({"total": C.train_step_cost(n, d, nl, it, c["precond_rank"], c["num_probes"], c["order"],
                                                   c["plan_capacity"] or N),
                        "splat": tuple(it_ * (it + 2) for it_ in C.splat_cost(N, n, cols, live)),
                        "pivot": C.factor_cost(n, d, c["precond_rank"])})
        return out

    def program_records(self) -> dict:
        return {"checked": self.checked, "iters": list(self.span.counters.get("cg_iters", [])),
                "res": list(self.span.counters.get("cg_res", []))}

    def control_records(self) -> dict:
        """The check steps run by the reference with every product's operands in TF32 (its own pivots and CG),
        its own Adam; the window's counters as the program gave them."""
        state, out = {}, []
        for rec in self.checked:
            raw = to_torch(rec["raw"], self.dev)
            r = RG.nlml_and_grad(self.cfg, self.taps, self.variance, raw, self.x, self.y, self._probes(rec), tf32)
            r["after"] = RG.adam(raw, r["grad"], state, self.cfg["lr"])
            r["res"], r["record"] = r["res"].cpu(), tuple(t.cpu() for t in r["record"][:3])
            out.append(r)
        return {**self.program_records(), "checked": out}

    def _probes(self, rec) -> torch.Tensor:
        g = torch.Generator(device=self.dev)
        g.set_state(rec["probes"])
        return rademacher(self.x.shape[0], self.cfg["num_probes"], g, self.dev)

    def check(self, prog: dict) -> dict:
        """Each check step's loss, the first gradient and the last step's update against the reference's from the
        same pivots and CG output as ``prog``'s, and those two stages by themselves (how far below the largest
        residual diagonal its pivots lie; each CG column's residual under the reference's operator against the
        one it claims).  On houseelectric two runs of the reference alone, apart only by the rounding of
        index_add's atomics, stop their CGs 5 iterations apart and read losses 2-3% apart: at the training CG's
        tolerance the iterates follow rounding, so the reference follows the run's own.

        Every CG is also held to the stop rule that the configuration and the solver state: ``cg_stop``, the
        worst step's mean relative residual over ``cg_tolerance`` (the check steps' under the reference's
        operator, the window's as the program's counter gives it, a step that ran ``max_cg_iterations`` aside),
        and ``cg_floor``, the iterations by which the shortest CG fell short of the floor."""
        state, losses, pivot, res, stop = {}, [], [], [], []
        tol, cap = self.cfg["cg_tolerance"], self.cfg["max_cg_iterations"]
        dev = lambda t: t.to(self.dev)
        runs = prog["checked"]
        for k, rec in enumerate(self.checked):
            raw = to_torch(rec["raw"], self.dev)
            run = runs[k]
            solves = dev(run["solves"])  # a run that saw fewer rows than the step has is padded with zeros
            solves = torch.cat([solves, solves.new_zeros((self.x.shape[0] - solves.shape[0], solves.shape[1]))])
            probes = self._probes(rec)
            follow = {"pivots": dev(run["pivots"]), "solves": solves, "res": dev(run["res"]),
                      "record": (*(dev(t) for t in run["record"]), (probes * probes).sum(0))}
            r = RG.nlml_and_grad(self.cfg, self.taps, self.variance, raw, self.x, self.y, probes, follow=follow)
            losses.append(abs(run["loss"] - r["loss"]) / abs(r["loss"]))
            pivot.append(r["pivot_gap"])
            res.append(r["res_gap"])
            if run.get("iters", 0) < cap:
                stop.append(r["true_res"] / tol)
            grad1 = r["grad"] if k == 0 else grad1
            after = RG.adam(raw, r["grad"], state, self.cfg["lr"])
        stop += [s / tol for s, i in zip(prog["res"], prog["iters"]) if i < cap]
        iters = [run.get("iters", FLOOR) for run in runs] + prog["iters"]
        norms = {k: float(v.norm()) for k, v in grad1.items()}
        med = float(np.median(list(norms.values())))
        moved = {k for k, v in norms.items() if v >= 1e-3 * med}
        d_prog = {k: runs[-1]["after"][k] - raw[k] for k in raw}
        d_ref = {k: after[k] - raw[k] for k in raw}
        return {"loss_gap": max(losses), "grad_gap": rel_norm_gap(runs[0]["grad"], grad1),
                "update_gap": rel_norm_gap(d_prog, d_ref, moved), "pivot_gap": max(pivot), "res_gap": max(res),
                "cg_stop": max(stop, default=0.0), "cg_floor": float(max(0, FLOOR - min(iters)))}
