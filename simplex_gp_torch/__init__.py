"""simplex_gp_torch: Simplex-GP in PyTorch, with hand-written Hopper kernels.

The port of the JAX package ``simplex_gp_tpu`` (the reference it is tested
against) to PyTorch and CUDA on an NVIDIA H100.  This slice is the serving
path: ``SimplexGP.posterior_cache`` and ``predict_from_cache`` for the rbf
and Matern lattice kernels.  Its kernels -- lattice geometry (K1), dedup and
neighbours (K2), apply (K3) and the pivoted-Cholesky column (K6) -- live in
``simplex_gp_torch/csrc`` and build at first use on a CUDA tensor; on CPU
tensors their plain PyTorch versions run.

Importing the package sets float32 matrix products to full precision (TF32
off): the preconditioner's SPD guard was tuned to float32 error.  It never
imports jax.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from .linalg.mll import BBMMConfig  # noqa: E402
from .models.exact_gp import SimplexGP  # noqa: E402


def RBFLattice(num_dims: int, order: int = 2, **kwargs) -> SimplexGP:
    """Lattice-accelerated RBF GP (reference bilateral_kernel.py:247-248)."""
    return SimplexGP(num_dims=num_dims, kernel="rbf", order=order, **kwargs)


def MaternLattice(num_dims: int, nu: float = 1.5, order: int = 3, **kwargs) -> SimplexGP:
    """Lattice-accelerated Matern GP (reference bilateral_kernel.py:253-254)."""
    return SimplexGP(num_dims=num_dims, kernel="matern", nu=nu, order=order, **kwargs)


__all__ = ["BBMMConfig", "MaternLattice", "RBFLattice", "SimplexGP"]
