"""The entry points' ``--device`` argument."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(name: str) -> torch.device:
    """The ``--device`` argument as a device; ``cuda`` without a card is an error, not a fallback."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is false (pass --device cpu to "
                           "run on the CPU)")
    return dev
