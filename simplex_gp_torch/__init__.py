"""simplex_gp_torch: Simplex-GP in PyTorch, with hand-written Hopper kernels.

The port of the JAX package ``simplex_gp_tpu`` (the reference it is tested
against) to PyTorch and CUDA on an NVIDIA H100, for the rbf, Matern and
Gaussian-mixture (``MixtureLattice``) lattice kernels: training (``SimplexGP.nlml`` through ``lattice_nlml``,
``fit_adam``, ``python -m simplex_gp_torch.train`` with periodic evaluation,
early stopping, checkpoints and resume; exact or reference-parity
``grad_mode="deriv_filter"`` gradients; a capacity-bounded training plan,
``BBMMConfig.plan_capacity``), serving (``SimplexGP.posterior_cache`` and
``predict_from_cache``, chunked above 4M contribution rows) and the
reference's filter entry points (``filter_once``, ``count_lattice_points``,
``lattice_filter``; ``python -m simplex_gp_torch.mvm_err``), and the
baselines ``models.ski.SKIP``, ``models.sgpr.SGPR`` and ``DenseGP`` with
their trainers (``python -m simplex_gp_torch.train_{skip,sgpr,exact}``).
Its kernels --
lattice geometry (K1), dedup and neighbours (K2, optionally bounded), apply
(K3, with the capacity guard), the sort-chain plan that the single-device
CG runs on (K3': build, splat, axis stencils, slice; no atomics), the
one-shot filter (K4), the filter's
position gradient (K5), the pivoted-Cholesky column (K6), the
derivative-tap gradient (K7), the occupancy count (K8), the chunked wide
apply (K9), the stacked mixture apply (K12) and SKIP's root (K13) -- live
in ``simplex_gp_torch/csrc`` and build at first use on a
CUDA tensor; on CPU tensors their plain PyTorch versions run.

Importing the package sets float32 matrix products to full precision (TF32
off): the preconditioner's SPD guard was tuned to float32 error.  It never
imports jax.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from .linalg.mll import BBMMConfig, lattice_nlml  # noqa: E402
from .models.exact_gp import DenseGP, SimplexGP  # noqa: E402
from .ops.filter import lattice_filter  # noqa: E402
from .ops.lattice import (  # noqa: E402
    ChainPlan,
    apply_plan,
    apply_plan_chain,
    build_plan,
    build_plan_chain,
    count_lattice_points,
    filter_once,
)
from .utils.training import EarlyStopper, fit_adam  # noqa: E402


def RBFLattice(num_dims: int, order: int = 2, **kwargs) -> SimplexGP:
    """Lattice-accelerated RBF GP (reference bilateral_kernel.py:247-248)."""
    return SimplexGP(num_dims=num_dims, kernel="rbf", order=order, **kwargs)


def MaternLattice(num_dims: int, nu: float = 1.5, order: int = 3, **kwargs) -> SimplexGP:
    """Lattice-accelerated Matern GP (reference bilateral_kernel.py:253-254)."""
    return SimplexGP(num_dims=num_dims, kernel="matern", nu=nu, order=order, **kwargs)


def MixtureLattice(num_dims: int, nu: float = 1.5, order: int = 1, components: int = 8, **kwargs) -> SimplexGP:
    """Gaussian-mixture lattice GP targeting Matern-``nu`` (simplex_gp_tpu/__init__.py:36-51).

    ``components`` RBF lattices at scaled positions with nonnegative
    host-fit weights, applied together by K12; an accuracy mode beyond the
    reference, at about ``components`` times the apply cost.
    """
    return SimplexGP(num_dims=num_dims, kernel="mixture", nu=nu, order=order, mix_components=components,
                     **kwargs)


__all__ = [
    "BBMMConfig",
    "ChainPlan",
    "DenseGP",
    "EarlyStopper",
    "MaternLattice",
    "MixtureLattice",
    "RBFLattice",
    "SimplexGP",
    "apply_plan",
    "apply_plan_chain",
    "build_plan",
    "build_plan_chain",
    "count_lattice_points",
    "filter_once",
    "fit_adam",
    "lattice_filter",
    "lattice_nlml",
]
