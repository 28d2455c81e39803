"""What every traffic driver shares: the spans, the cell's data, model and parameter points, the checks' helpers.

Everything a cell runs is found by name, so that a new configuration, data
recipe, model, traffic mix or driver is a new file and never an edit:
- the traffic file's ``op`` names the driver, ``gpbench/drivers/<op>.py``,
  which defines ``Driver``, a subclass of :class:`Cell`;
- the configuration's ``data`` names the recipe, ``gpbench/recipes/<data>.py``,
  whose ``make(cfg, device)`` gives the split table;
- the configuration's ``model`` names the builder, ``gpbench/models/<model>.py``,
  whose ``build(cfg, device)`` gives the program's model;
- a traffic file's ``replay`` names a trajectory,
  ``gpbench/trajectories/<name>.json``, the parameter points the program's
  own trainer went through (``python -m gpbench.record``).

A driver gives ``setup``, ``op`` (one unit of traffic, timed by the caller;
False when its answer is not finite), ``costs`` (the bytes and operations of
chosen ops, for the roofline metrics), ``program_records`` (what the window
produced that the check reads) or ``control_records`` (the same, made by the
reference in TF32), ``release`` (drops the program's state) and ``check``
(the numbers compared with the reference, run after ``release``).  A traffic
file's other keys are its driver's parameters.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import inspect
import json
import pathlib
import re
import sys
import time

import numpy as np
import torch

from .data import Strata, jittered, seed_of
from .reference import gp as RG
from .reference.lattice import matern_taps

__all__ = ["HERE", "TRAJECTORIES", "load", "Span", "Cell", "rademacher", "to_torch", "rel_norm_gap", "pred_gaps",
           "sample", "spy", "patch_program"]

HERE = pathlib.Path(__file__).resolve().parent
TRAJECTORIES = HERE / "trajectories"


def load(kind: str, name: str):
    """The module ``gpbench/<kind>/<name>.py``."""
    if not re.fullmatch(r"[A-Za-z0-9_]+", name):
        raise ValueError(f"not a module name: {name!r}")
    return importlib.import_module(f"gpbench.{kind}.{name}")


class Span:
    """Host spans and counters of the benchmark's own calls into the program.

    Every span is a ``record_function`` (the trace labels idle gaps by it);
    with ``timed`` it is also closed by a synchronise and its duration kept.
    """

    def __init__(self, timed: bool):
        self.timed, self.spans, self.counters = timed, {}, {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        with torch.profiler.record_function(f"gpbench.{name}"):
            if not self.timed:
                yield
                return
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def count(self, name: str, value) -> None:
        self.counters.setdefault(name, []).append(value)


def rademacher(n: int, p: int, g: torch.Generator, device) -> torch.Tensor:
    return (2 * torch.randint(0, 2, (n, p), generator=g, device=device) - 1).to(torch.float32)


def to_torch(raw: dict, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.float32, device=device) for k, v in raw.items()}


def rel_norm_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap between the two norms, over the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    names = [k for k in ref if keep is None or k in keep]
    norms = {k: float(ref[k].norm()) for k in names}
    med = float(np.median(list(norms.values())))
    return max(abs(float(prog[k].norm()) - norms[k]) / max(norms[k], med, 1e-30) for k in names)


def pred_gaps(mean_p, var_p, mean_r, var_r, mu) -> tuple:
    """The widest row's mean gap over the RMS of the reference's means less mu, and its variance gap over the
    reference's mean variance."""
    mean_p, var_p = mean_p.to(mean_r.device), var_p.to(var_r.device)
    scale = max(float(torch.sqrt(((mean_r - mu) ** 2).mean())), 1e-30)
    return (float((mean_p - mean_r).abs().max()) / scale, float((var_p - var_r).abs().max() / var_r.mean()))


def sample(seed: int, k: int, count: int) -> list:
    """``k`` of ``count`` answers, drawn from the seed."""
    rng = np.random.default_rng(seed_of(seed, "sample"))
    return sorted(rng.choice(count, size=min(k, count), replace=False).tolist())


@contextlib.contextmanager
def patch_program(module: str, name: str, make):
    """Replace the program's function ``<module>.<name>`` by ``make(original)`` wherever the program has
    bound it by importing it (every other module of the program that imported it by name; its own module keeps
    it, since the function may keep state on itself there)."""
    importlib.import_module(module)
    original = getattr(sys.modules[module], name)
    bound = {m: getattr(m, name, None) for k, m in list(sys.modules.items())
             if k.split(".")[0] == "simplex_gp_torch" and k != module}
    bound = {m: f for m, f in bound.items() if callable(f) and inspect.unwrap(f) is original}  # patched already too
    for m, f in bound.items():
        setattr(m, name, functools.wraps(f)(make(f)))
    try:
        yield
    finally:
        for m, f in bound.items():
            setattr(m, name, f)


@contextlib.contextmanager
def spy(module: str, name: str, keep):
    """``keep(result)`` of every call of the program's public ``<module>.<name>`` while the block runs (host
    copies, so that nothing the program frees is held on the card); the calls and their results are the
    program's, unchanged."""
    seen = []

    def make(original):
        def wrapped(*args, **kw):
            result = original(*args, **kw)
            seen.append(keep(result))
            return result
        return wrapped

    with patch_program(module, name, make):
        yield seen


class Cell:
    """What the drivers share: the data, the model, the parameter points."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, traced: bool):
        self.cfg, self.traffic, self.seed, self.dev = cfg, traffic, seed, device
        self.span = Span(traced)
        self.taps, self.variance = matern_taps(cfg["nu"], cfg["order"])
        self.records = []

    def _model(self):
        return load("models", self.cfg["model"]).build(self.cfg, self.dev)

    def _data(self):
        """The table, the traffic's parameter points in the order this seed replays them, and the jitter."""
        self.data = load("recipes", self.cfg["data"]).make(self.cfg, self.dev)
        self.x, self.y = self.data["train_x"], self.data["train_y"]
        self.points = self._points()
        self.offset = int(np.random.default_rng(seed_of(self.seed, "offset")).integers(len(self.points)))
        self.served = 0
        jit = self.traffic.get("jitter", {})
        width = {"lengthscale": self.cfg["d"], "outputscale": 1, "noise": 1}
        self.strata = {k: Strata(lo, hi, width[k], self.seed, f"jitter.{k}") for k, (lo, hi) in jit.items()}

    def _points(self) -> list:
        """The raw points the traffic replays: ``replay``'s slice of a recorded trajectory."""
        rep = self.traffic["replay"]
        traj = json.loads((TRAJECTORIES / f"{rep['trajectory']}.json").read_text())
        for k in ("config", "data_seed", "n", "d"):
            want = self.cfg["name"] if k == "config" else self.cfg[k]
            if traj[k] != want:
                raise ValueError(f"trajectory {rep['trajectory']}: {k} {traj[k]!r}, the configuration's {want!r}")
        pts = traj["points"][rep["first"]:rep["last"] + 1:rep.get("every", 1)]
        return [{k: np.asarray(v, np.float32) for k, v in p.items()} for p in pts]

    def _next_raw(self) -> dict:
        """The next point of the replay (from this seed's offset, cycling), times this seed's next jitter."""
        raw = self.points[(self.offset + self.served) % len(self.points)]
        self.served += 1
        return jittered(raw, {k: s.draw() for k, s in self.strata.items()}, self.cfg["min_noise"])

    def _params(self, raw: dict) -> dict:
        with torch.no_grad():
            return RG.constrain(to_torch(raw, self.dev), self.cfg["min_noise"])

    def release(self) -> None:
        for name in ("model", "opt", "cache"):
            self.__dict__.pop(name, None)
        torch.cuda.empty_cache() if torch.cuda.is_available() else None
