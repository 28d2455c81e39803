"""Carry trained parameters from the JAX package into the port.

The JAX trainer saves its raw parameter dict (numpy arrays: raw_lengthscale,
raw_outputscale, raw_noise, mean) with pickle, e.g.
``runs/r5/simplexgp_elevators_s0/model_best.pkl``.  Loading needs no jax.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

__all__ = ["load_jax_params", "raw_params_from_numpy"]

# The only globals a saved raw dict of numpy arrays refers to.
_ALLOWED = {
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
}


class _NumpyOnlyUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) not in _ALLOWED:
            raise pickle.UnpicklingError(f"refusing to load {module}.{name} from a parameter file")
        return super().find_class(module, name)


def load_jax_params(path) -> dict:
    """Unpickle a JAX raw-parameter dict; only numpy arrays are accepted."""
    with open(path, "rb") as f:
        raw = _NumpyOnlyUnpickler(f).load()
    if not isinstance(raw, dict):
        raise ValueError(f"{path}: expected a dict of raw parameters, got {type(raw).__name__}")
    return raw


def raw_params_from_numpy(d: dict, device=None) -> dict:
    """Map a raw dict of numpy arrays to float32 tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device) for k, v in d.items()}
