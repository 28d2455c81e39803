"""Faults planted in the program underneath a run, for the checks that ``correct`` must catch.

Each is a context manager that patches the program's timed path:
``unchanged_state``: the optimizer step returns the parameters unchanged;
``half_batch``: the loss or the fit sees only the first half of the training
rows (the mean taken over them), a predict answers only the first half of
its rows and gives the rest the mean of those answers;
``altered_answer``: one predicted mean is moved by 0.1 where it is made;
``early_stop``: every CG stops after at most 5 iterations, its answer and
record as they stand then.
"""

from __future__ import annotations

import contextlib

import inspect

import torch

from .cell import patch_program

__all__ = ["FAULTS"]


@contextlib.contextmanager
def _patched(owner, name: str, make):
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def unchanged_state():
    return _patched(torch.optim.Adam, "step", lambda orig: lambda self, closure=None: None)


@contextlib.contextmanager
def half_batch():
    from simplex_gp_torch.models.exact_gp import SimplexGP

    def nlml(orig):
        def f(self, x, y, probes=None, **kw):
            h = x.shape[0] // 2
            return orig(self, x[:h], y[:h], probes=None if probes is None else probes[:h].contiguous(), **kw)
        return f

    def cache(orig):
        def f(self, x, y, omega=None, **kw):
            h = x.shape[0] // 2
            c = orig(self, x[:h], y[:h], omega=None if omega is None else omega[:h].contiguous(), **kw)
            pad = lambda t: torch.cat([t, torch.zeros((x.shape[0] - h, *t.shape[1:]), device=t.device)])
            return dict(c, alpha=pad(c["alpha"]), root_inv=pad(c["root_inv"]))
        return f

    def predict(orig):
        def f(self, cache, x, x_test):
            h = max(1, x_test.shape[0] // 2)
            mean, var = orig(self, cache, x, x_test[:h])
            rest = x_test.shape[0] - h
            return torch.cat([mean, mean.mean().expand(rest)]), torch.cat([var, var.mean().expand(rest)])
        return f

    with _patched(SimplexGP, "nlml", nlml), _patched(SimplexGP, "posterior_cache", cache), \
            _patched(SimplexGP, "predict_from_cache", predict):
        yield


def altered_answer():
    from simplex_gp_torch.models.exact_gp import SimplexGP

    def predict(orig):
        def f(self, cache, x, x_test):
            mean, var = orig(self, cache, x, x_test)
            return mean + 0.1 * (torch.arange(mean.shape[0], device=mean.device) == 0), var
        return f

    return _patched(SimplexGP, "predict_from_cache", predict)


def early_stop():
    def make(orig):
        sig = inspect.signature(orig)

        def f(*args, **kw):
            bound = sig.bind(*args, **kw)
            bound.arguments["max_iters"] = min(5, bound.arguments.get("max_iters", 500))
            return orig(*bound.args, **bound.kwargs)
        return f

    return patch_program("simplex_gp_torch.linalg.cg", "cg_solve", make)


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch, "altered_answer": altered_answer,
          "early_stop": early_stop}
