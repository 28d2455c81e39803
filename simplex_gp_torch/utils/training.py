"""Training loop utilities: Adam fitting and early stopping.

Port of simplex_gp_tpu/utils/training.py (:23-87): the Adam NLML loop of
the reference (train_simplexgp.py:29-57) on ``torch.optim.Adam``, whose
defaults (betas 0.9/0.999, eps 1e-8 outside the square root) are optax's,
and the EarlyStopper of experiments/utils.py:170-199, whose state goes to
and from the trainer's checkpoint.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable, Optional

import torch

__all__ = ["fit_adam", "EarlyStopper"]


def fit_adam(
    loss_fn: Callable[[torch.Generator], torch.Tensor],
    params: Iterable[torch.nn.Parameter],
    epochs: int = 100,
    lr: float = 0.1,
    seed: int = 0,
    callback: Optional[Callable[[int, float, float], None]] = None,
) -> dict:
    """Minimize ``loss_fn(generator)`` over ``params`` with Adam, in place.

    One generator on the parameters' device, seeded with ``seed``, is
    handed to every epoch's loss, so each epoch draws fresh
    NLML probes, as GPyTorch re-draws them per loss evaluation.  Returns the
    history: per-epoch loss and step time in ms, taken by CUDA events when
    the parameters live on a card and by the host clock otherwise
    (``history["clock"]`` says which).  ``callback(epoch, loss, step_ms)``
    runs after every step.
    """
    params = list(params)
    device = params[0].device
    opt = torch.optim.Adam(params, lr=lr)
    gen = torch.Generator(device=device).manual_seed(seed)
    cuda = device.type == "cuda"
    history = {"loss": [], "step_ms": [], "clock": "cuda_events" if cuda else "host"}
    for epoch in range(epochs):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(gen)
        loss.backward()
        opt.step()
        if cuda:
            end.record()
            end.synchronize()
            step_ms = start.elapsed_time(end)
        else:
            step_ms = 1e3 * (time.perf_counter() - t0)
        value = float(loss.detach())
        history["loss"].append(value)
        history["step_ms"].append(step_ms)
        if callback is not None:
            callback(epoch, value, step_ms)
    return history


@dataclasses.dataclass
class EarlyStopper:
    """Patience-based early stopping retaining the best state.

    Stop after ``patience`` evals with no improvement greater than
    ``min_delta``; keep the best (params, info).
    """

    patience: int = 10
    min_delta: float = 0.0
    best_score: float = float("inf")
    counter: int = 0
    best_state: Any = None

    def step(self, score: float, state: Any = None) -> bool:
        """Record an eval score (lower is better); return True to stop."""
        if score < self.best_score - self.min_delta:
            self.best_score = score
            self.best_state = state
            self.counter = 0
        else:
            self.counter += 1
        return self.counter > self.patience

    @property
    def is_best(self) -> bool:
        return self.counter == 0

    def state_dict(self) -> dict:
        """Everything but the patience, for a checkpoint (experiments/common.py:187-192)."""
        return {"min_delta": self.min_delta, "best_score": self.best_score, "counter": self.counter,
                "best_state": self.best_state}

    def load_state_dict(self, state: dict) -> "EarlyStopper":
        """Restore :meth:`state_dict`'s fields in place; returns self."""
        for key in ("min_delta", "best_score", "counter", "best_state"):
            setattr(self, key, state[key])
        return self
