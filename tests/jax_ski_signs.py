"""JAX's SKIP with the port's sign rule (not collected: no test_ prefix).

The eigenvectors of SKIP's grid kernels and the columns of its range
finder's Q and U_B are defined up to sign; JAX takes LAPACK's, the port
fixes them (simplex_gp_torch/models/ski.py::fix_signs) so that its card
and CPU runs agree.  :func:`port_signs` runs the unchanged JAX package with
``jnp.linalg.eigh``, ``qr`` and ``svd`` giving vectors of the port's signs,
which makes JAX's SKIP and the port's the same function of the same
Omega.  The rule: each column's product with the Weyl weights
frac(i phi) - 1/2 (i = 1..rows) is >= 0.
"""

import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np

_PHI = (math.sqrt(5.0) - 1.0) / 2.0


def sign_weights(rows: int) -> np.ndarray:
    i = np.arange(1, rows + 1, dtype=np.float64)
    return (np.remainder(i * _PHI, 1.0) - 0.5).astype(np.float32)


def _signs(V):
    return jax.lax.stop_gradient(jnp.where(jnp.asarray(sign_weights(V.shape[-2])) @ V >= 0, 1.0, -1.0))


@contextlib.contextmanager
def port_signs():
    """Within the block, jnp.linalg.eigh / qr / svd return vectors with the port's signs."""
    lin = jnp.linalg
    eigh, qr, svd = lin.eigh, lin.qr, lin.svd

    def eigh_(a, *args, **kwargs):
        w, v = eigh(a, *args, **kwargs)
        return w, v * _signs(v)[None, :]

    def qr_(a, *args, **kwargs):
        q, r = qr(a, *args, **kwargs)
        s = _signs(q)
        return q * s[None, :], r * s[:, None]

    def svd_(a, *args, **kwargs):
        u, s, vt = svd(a, *args, **kwargs)
        f = _signs(u)
        return u * f[None, :], s, vt * f[:, None]

    lin.eigh, lin.qr, lin.svd = eigh_, qr_, svd_
    try:
        yield
    finally:
        lin.eigh, lin.qr, lin.svd = eigh, qr, svd


def jax_omegas(d: int, r: int) -> list:
    """JAX's Omega_j, j = 1..d-1 (ski.py:117-118), as numpy arrays."""
    return [np.asarray(jax.random.normal(jax.random.PRNGKey(j), (r * r, r), jnp.float32)) for j in range(1, d)]
