"""Carry trained parameters between the JAX package and the port.

The JAX trainer saves its raw parameter dict (numpy arrays: raw_lengthscale,
raw_outputscale, raw_noise, mean) with pickle, e.g.
``runs/r5/simplexgp_elevators_s0/model_best.pkl``.  Loading needs no jax.
A JAX mixture model is that dict plus its ``mix_weights`` tuple (the
model's static field, fit on the host); :func:`mixture_model_from_jax`
builds the port's model from both.  JAX's SKIP and SGPR files are the same
dict (SGPR's with ``inducing`` (m, d) beside it);
:func:`skip_model_from_jax` and :func:`sgpr_model_from_jax` build the
port's models from them.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

__all__ = ["load_jax_params", "raw_params_from_numpy", "raw_params_to_numpy", "mixture_model_from_jax",
           "skip_model_from_jax", "sgpr_model_from_jax"]

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


def raw_params_to_numpy(raw: dict) -> dict:
    """Map a raw dict of tensors (e.g. ``model.raw()``) to float32 numpy arrays, JAX's raw dict."""
    return {k: np.asarray(v.detach().cpu(), np.float32) for k, v in raw.items()}


def _num_dims(raw: dict) -> int:
    return int(np.asarray(raw["raw_lengthscale"]).size)


def mixture_model_from_jax(raw: dict, mix_weights, device=None, **model_kwargs):
    """The port's mixture SimplexGP of a JAX mixture model: its raw dict and its ``mix_weights``.

    ``model_kwargs`` are the other SimplexGP settings (nu, order, min_noise,
    bbmm, eval_cg_tolerance); the number of components is that of the weights.
    """
    from .models.exact_gp import SimplexGP

    weights = tuple(float(w) for w in np.asarray(mix_weights, np.float64).ravel())
    model = SimplexGP(num_dims=_num_dims(raw), kernel="mixture", mix_components=len(weights), mix_weights=weights,
                      device=device, **model_kwargs)
    return model.load_raw(raw_params_from_numpy(raw, device=device))


def skip_model_from_jax(raw: dict, device=None, **model_kwargs):
    """The port's SKIP with a JAX SKIP raw dict loaded; ``model_kwargs`` are grid_size, rank, kernel, nu,
    min_noise and omegas."""
    from .models.ski import SKIP

    return SKIP(num_dims=_num_dims(raw), device=device, **model_kwargs).load_raw(
        raw_params_from_numpy(raw, device=device))


def sgpr_model_from_jax(raw: dict, device=None, **model_kwargs):
    """The port's SGPR with a JAX SGPR raw dict loaded, its ``inducing`` points included; ``model_kwargs`` are
    kernel, nu and min_noise (the number of inducing points is that of the file)."""
    from .models.sgpr import SGPR

    z = np.asarray(raw["inducing"])
    return SGPR(num_dims=_num_dims(raw), num_inducing=z.shape[0], device=device, **model_kwargs).load_raw(
        raw_params_from_numpy(raw, device=device))
