"""Exact-GP models: lattice-accelerated (Simplex-GP) and the dense baseline.

Port of simplex_gp_tpu/models/exact_gp.py for the rbf, Matern and
Gaussian-mixture lattice kernels:

    ConstantMean + ScaleKernel(RBFLattice/MaternLattice/MixtureLattice,
    ard_num_dims=d) + GaussianLikelihood(GreaterThan(min_noise))

``SimplexGP.nlml`` is the training loss, through the BBMM engine
(linalg/mll.py::lattice_nlml) and differentiable in every raw parameter.
``posterior_cache`` builds one lattice plan over the training positions
(bounded by ``BBMMConfig.plan_capacity``), a rank-k pivoted-Cholesky
preconditioner, solves alpha = K_hat^{-1} (y - mu) by preconditioned CG at
the eval tolerance, and forms the LOVE root from a randomized range sketch
whose two 100-column MVMs share one wide filter of their own (a join plan
and K9, or above 4M contribution rows JAX's chunked chain: one chain plan
applied in 16-column blocks).  ``predict_from_cache`` runs one rectangular
filter of 1+m columns over [train; test], untrimmed, chunked at the same
size.  ``kernel="mixture"`` is J RBF lattices at scaled positions targeting
Matern-nu (ops/kernels.py MixtureKernel): its training and eval CGs run on
J chain plans, one a component, its sketch and predict below 4M rows on
the stacked join plan applied by K12; its
weights are the profile fit, ``mix_weights`` when set, and
:meth:`SimplexGP.with_fitted_mixture` refits them on a data subset.
``prune_thresh`` > 0 screens the ARD dims for inference: the ``_screened``
methods drop the input dims whose inverse lengthscale lies below that
fraction of the largest and serve a reduced-dimension copy of the model
(exact_gp.py:82-91, :237-280); training always runs on every dim.
``DenseGP`` is the same model with dense Cholesky algebra, the dense side
of the Snelson parity test.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from .. import trace
from ..linalg.cg import cg_solve
from ..linalg.mll import BBMMConfig, build_precond, lattice_nlml
from ..ops.filter import apply_plan_any, build_plan_any, lattice_filter_rect, make_wide_filter
from ..ops.kernels import fit_mixture_weights_subset, matern_kernel, mixture_kernel, rbf_kernel
from .components import constrain, init_raw_params

__all__ = ["SimplexGP", "DenseGP", "rademacher", "rank_generator"]

_RAW_NAMES = ("raw_lengthscale", "raw_outputscale", "raw_noise", "mean")


def rademacher(shape, generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
    """float32 +-1 draws from ``generator`` (the NLML's Hutchinson / SLQ probes)."""
    bits = torch.randint(0, 2, shape, generator=generator, device=device)
    return (2 * bits - 1).to(torch.float32)


def rank_generator(seed: int, rank: int, device=None) -> torch.Generator:
    """A generator seeded from (seed, rank): each rank's own probe stream (JAX's fold_in, exact_gp.py:146-147)."""
    state = np.random.SeedSequence([seed, rank]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) & (2**63 - 1))


class _RawParams(nn.Module):
    """The raw (unconstrained) parameters, as ``nn.Parameter``s named as the
    JAX package's raw dict: ``raw_lengthscale`` (d,), ``raw_outputscale``,
    ``raw_noise`` and ``mean``."""

    def __init__(self, num_dims: int, min_noise: float, device=None):
        super().__init__()
        self.num_dims = num_dims
        self.min_noise = min_noise
        for name, value in init_raw_params(num_dims, device=device).items():
            setattr(self, name, nn.Parameter(value))

    def raw(self) -> dict:
        return {name: getattr(self, name) for name in _RAW_NAMES}

    @torch.no_grad()
    def load_raw(self, raw: dict):
        """Copy a raw parameter dict (tensors or numpy arrays) into the module."""
        for name in _RAW_NAMES:
            p = getattr(self, name)
            value = raw[name]
            if not isinstance(value, torch.Tensor):
                value = torch.from_numpy(np.array(value, dtype=np.float32))
            p.copy_(value.reshape(p.shape))
        return self

    def constrained(self) -> dict:
        return constrain(self.raw(), self.min_noise)


class SimplexGP(_RawParams):
    """Lattice-accelerated exact GP regression model.

    Every method runs on the device of the module's parameters and of its
    inputs.  ``kernel`` is "rbf", "matern" or "mixture"; a mixture has
    ``mix_components`` components and the weights ``mix_weights`` (None:
    the profile fit of ``mixture_kernel``).
    """

    def __init__(
        self,
        num_dims: int,
        kernel: str = "rbf",
        nu: float = 1.5,
        order: int = 1,
        min_noise: float = 1e-4,
        bbmm: BBMMConfig = BBMMConfig(),
        eval_cg_tolerance: float = 1e-2,
        mix_components: int = 8,
        mix_weights: Optional[tuple] = None,
        prune_thresh: float = 0.0,
        device=None,
    ):
        if kernel not in ("rbf", "matern", "mixture"):
            raise ValueError(f"unknown kernel {kernel!r} (rbf, matern or mixture)")
        super().__init__(num_dims, min_noise, device)
        self.kernel = kernel
        self.nu = nu
        self.order = order
        self.mix_components = mix_components
        self.mix_weights = None if mix_weights is None else tuple(float(w) for w in mix_weights)
        self.bbmm = bbmm
        self.eval_cg_tolerance = eval_cg_tolerance
        self.prune_thresh = prune_thresh

    def extra_repr(self) -> str:
        mix = (f", mix_components={self.mix_components}, mix_weights={self.mix_weights}"
               if self.kernel == "mixture" else "")
        return (f"num_dims={self.num_dims}, kernel={self.kernel!r}, nu={self.nu}, order={self.order}, "
                f"min_noise={self.min_noise}, bbmm={self.bbmm}, eval_cg_tolerance={self.eval_cg_tolerance}, "
                f"prune_thresh={self.prune_thresh}{mix}")

    @property
    def dk(self):
        """The DiscretizedKernel, or for "mixture" the MixtureKernel with ``mix_weights`` (exact_gp.py:93-104)."""
        if self.kernel == "rbf":
            return rbf_kernel(self.order)
        if self.kernel == "matern":
            return matern_kernel(self.nu, self.order)
        mk = mixture_kernel(self.nu, self.order, self.mix_components)
        return mk if self.mix_weights is None else dataclasses.replace(mk, weights=self.mix_weights)

    @torch.no_grad()
    def with_fitted_mixture(self, x: torch.Tensor, m: int = 1024, seed: int = 0) -> "SimplexGP":
        """Refit the mixture weights on an m-point subset at the current lengthscales (exact_gp.py:106-119).

        The weights go into ``mix_weights`` of this model, which is returned
        (JAX returns a new static model; here the parameters live in the
        module, so it is updated in place).  No-op for the other kernels.
        """
        if self.kernel == "mixture":
            ref = x * self.constrained()["inv_ell"]
            self.mix_weights = fit_mixture_weights_subset(self.dk, ref, m=m, seed=seed).weights
        return self

    def nlml(
        self,
        x: torch.Tensor,
        y: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        probes: Optional[torch.Tensor] = None,
        stats: Optional[dict] = None,
        axis=None,
        seed: int = 0,
    ) -> torch.Tensor:
        """Negative log marginal likelihood / n, the training loss (exact_gp.py:129-150).

        The (n, num_probes) Rademacher probes are ``probes`` when given, else
        drawn from ``generator`` on x's device.  Differentiable in every raw
        parameter; ``stats`` (a dict) receives the CG iterations and residual.
        With ``axis`` (a DataAxis) x and y are this rank's rows and the
        engine runs sharded: the loss is the global one, and the gradients
        each rank's part (``parallel.data_parallel_loss_fn`` sums them).
        Each rank then draws its own probes from a generator seeded from
        (``seed``, rank), as JAX folds the shard index into the key: the same
        probe block on every rank would bias the trace estimator.
        """
        shape = (x.shape[0], self.bbmm.num_probes)
        cfg = self.bbmm
        if axis is not None:
            if generator is not None:
                raise ValueError("with an axis each rank's probes come from (seed, rank): pass seed, not a generator")
            cfg = dataclasses.replace(cfg, axis=axis)
            generator = rank_generator(seed, axis.rank, x.device) if probes is None else None
        if probes is None:
            probes = rademacher(shape, generator, x.device)
        elif tuple(probes.shape) != shape:
            raise ValueError(f"probes have shape {tuple(probes.shape)}, expected {shape}")
        return lattice_nlml(self.dk, cfg, self.constrained(), x, y, probes, stats=stats)

    def _khat_mv(self, params: dict, plan):
        s, noise = params["outputscale"], params["noise"]

        def mv(V):
            return s * apply_plan_any(plan, V, self.dk) + noise * V

        return mv

    @torch.no_grad()
    def posterior_cache(
        self,
        x: torch.Tensor,
        y: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        omega: Optional[torch.Tensor] = None,
        root_rank: Optional[int] = None,
    ) -> dict:
        """alpha = K_hat^{-1} (y - mu) and the LOVE root for variances.

        The root comes from a randomized range sketch: Y = K_hat Omega,
        Q = qr(Y), T = Q^T K_hat Q, root_inv = Q U L^{-1/2} for T = U L U^T.
        ``Omega`` (n, m) is ``omega`` when given, else standard normal draws
        from ``generator``.  The eval CG runs on the sort-chain plan (K3'; a
        mixture's J chain plans), as JAX's does, replayed from a CUDA graph;
        both sketch MVMs share one wide filter of their own
        (make_wide_filter with the same positions and capacity, as JAX's,
        exact_gp.py:339): a join plan applied by K9 (a mixture's stacked
        plan, by K12), or above 4M contribution rows one chain plan applied
        in 16-column blocks (a mixture's J).  The cache also records the CG
        iteration count and mean final residual.  The call is the span
        ``posterior_cache`` (:mod:`simplex_gp_torch.trace`), with the plan,
        the preconditioner, the CG and the sketch as its children.
        """
        with trace.span("posterior_cache"):
            params = self.constrained()
            ref = x * params["inv_ell"]
            plan = build_plan_any(ref, self.dk, self.bbmm.plan_capacity)
            yc = y - params["mean"]

            P = build_precond(self.dk, self.bbmm, params, ref, x.shape[0])
            # One plan and hundreds of iterations at houseelectric: replayed from a CUDA graph on the card (the
            # training CG's 10-13 iterations do not repay the capture).
            sol = cg_solve(
                lambda V: apply_plan_any(plan, V, self.dk), yc[:, None], tol=self.eval_cg_tolerance,
                max_iters=self.bbmm.max_cg_iterations, precond=P,
                shift=(params["outputscale"], params["noise"]), graph=True,
            )
            alpha = sol.x[:, 0]

            with trace.span("sketch"):
                n = x.shape[0]
                m = min(root_rank or self.bbmm.max_lanczos_iterations, n)
                if omega is None:
                    omega = torch.randn((n, m), generator=generator, dtype=torch.float32, device=x.device)
                elif omega.shape != (n, m):
                    raise ValueError(f"omega has shape {tuple(omega.shape)}, expected {(n, m)}")
                s, noise = params["outputscale"], params["noise"]

                kmv = make_wide_filter(ref, self.dk, self.bbmm.plan_capacity)

                def mv_wide(V):
                    return s * kmv(V) + noise * V

                Q, _ = torch.linalg.qr(mv_wide(omega))
                T = Q.T @ mv_wide(Q)
                T = 0.5 * (T + T.T)
                evals, evecs = torch.linalg.eigh(T)
                evals = torch.clamp(evals, min=1e-8)
                root_inv = Q @ (evecs / torch.sqrt(evals)[None, :])
            return {
                "alpha": alpha,
                "root_inv": root_inv,
                "params": params,
                "cg_iters": sol.iterations,
                "cg_res": sol.residual_norm.mean(),
            }

    @torch.no_grad()
    def predict_from_cache(self, cache: dict, x: torch.Tensor, x_test: torch.Tensor):
        """Posterior mean and variance at x_test: one rect filter of 1+m columns (the span ``predict``)."""
        with trace.span("predict"):
            params = cache["params"]
            ref = x * params["inv_ell"]
            ref_test = x_test * params["inv_ell"]
            s = params["outputscale"]

            cols = torch.cat([cache["alpha"][:, None], cache["root_inv"]], dim=-1)
            F = lattice_filter_rect(cols, ref, ref_test, self.dk)  # (n_test, 1+m)
            mean = s * F[:, 0] + params["mean"]
            S = s * F[:, 1:]
            var = s + params["noise"] - (S * S).sum(dim=-1)
            return mean, torch.clamp(var, min=1e-8)

    # ----- ARD screening -----

    @torch.no_grad()
    def screened(self):
        """(sub, raw_sub, keep): the model with its near-irrelevant ARD dims dropped (exact_gp.py:237-257).

        ``keep`` holds the column indices whose constrained float32 inverse
        lengthscale is at least ``prune_thresh`` times the largest, read on the
        host.  With the threshold at 0, or when every dim is kept, it is None
        and ``sub`` is this model.  Otherwise ``sub`` is a new SimplexGP on the
        same device with ``len(keep)`` dims and no screening of its own, the
        same kernel, taps, mixture weights, BBMM settings (the plan capacity
        with them) and eval tolerance, holding a copy of this model's raw
        parameters with ``raw_lengthscale[keep]`` (``raw_sub``, no autograd
        link to this model).
        """
        if self.prune_thresh <= 0:
            return self, self.raw(), None
        inv_ell = self.constrained()["inv_ell"].cpu().numpy()
        keep = np.where(inv_ell >= self.prune_thresh * inv_ell.max())[0]
        if len(keep) == self.num_dims:
            return self, self.raw(), None
        dev = self.raw_lengthscale.device
        sub = SimplexGP(num_dims=len(keep), kernel=self.kernel, nu=self.nu, order=self.order,
                        min_noise=self.min_noise, bbmm=self.bbmm, eval_cg_tolerance=self.eval_cg_tolerance,
                        mix_components=self.mix_components, mix_weights=self.mix_weights, device=dev)
        raw_sub = {k: v.detach().clone() for k, v in self.raw().items()}
        raw_sub["raw_lengthscale"] = raw_sub["raw_lengthscale"][torch.from_numpy(keep).to(dev)]
        sub.load_raw(raw_sub)
        return sub, raw_sub, keep

    @staticmethod
    def _columns(x: torch.Tensor, keep: Optional[np.ndarray]) -> torch.Tensor:
        return x if keep is None else x[:, torch.from_numpy(keep).to(x.device)]

    @torch.no_grad()
    def posterior_cache_screened(
        self,
        x: torch.Tensor,
        y: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        omega: Optional[torch.Tensor] = None,
        root_rank: Optional[int] = None,
    ) -> dict:
        """:meth:`posterior_cache` of the screened model on the kept columns of x (exact_gp.py:259-271).

        The cache carries the screened model (``sub``) and the kept columns
        (``keep``, None when nothing is dropped, and then this is the plain
        cache); predict from it with :meth:`predict_from_cache_screened`.
        """
        sub, _, keep = self.screened()
        cache = sub.posterior_cache(self._columns(x, keep), y, generator=generator, omega=omega,
                                    root_rank=root_rank)
        return dict(cache, keep=keep, sub=sub)

    @torch.no_grad()
    def predict_from_cache_screened(self, cache: dict, x: torch.Tensor, x_test: torch.Tensor):
        """Posterior mean and variance at x_test from a :meth:`posterior_cache_screened` cache (exact_gp.py:273-280)."""
        keep = cache.get("keep")
        return cache.get("sub", self).predict_from_cache(cache, self._columns(x, keep), self._columns(x_test, keep))

    def predict(self, x, y, x_test, generator: Optional[torch.Generator] = None):
        """Posterior mean and variance at x_test: build the cache, predict once."""
        return self.predict_from_cache(self.posterior_cache(x, y, generator), x, x_test)


class DenseGP(_RawParams):
    """Dense exact GP (Cholesky), the KeOps-exact-baseline analog (exact_gp.py:392).

    Same parameterization as :class:`SimplexGP`; O(n^2) memory, O(n^3) time.
    """

    def __init__(self, num_dims: int, kernel: str = "rbf", nu: float = 1.5, min_noise: float = 1e-4,
                 device=None):
        super().__init__(num_dims, min_noise, device)
        self.kernel = kernel
        self.nu = nu

    def _kmat(self, params: dict, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        r1 = x1 * params["inv_ell"]
        r2 = x2 * params["inv_ell"]
        # Matmul-form squared distances, as exact_gp.py:413-416.
        d2 = (r1 * r1).sum(-1)[:, None] + (r2 * r2).sum(-1)[None, :] - 2.0 * (r1 @ r2.T)
        d2 = torch.clamp(d2, min=0.0)
        if self.kernel == "rbf":
            k = torch.exp(-d2)
        elif self.kernel == "matern" and self.nu == 1.5:
            d = torch.sqrt(d2 + 1e-12)
            k = (1 + math.sqrt(3.0) * d) * torch.exp(-math.sqrt(3.0) * d)
        elif self.kernel == "matern" and self.nu == 2.5:
            d = torch.sqrt(d2 + 1e-12)
            k = (1 + math.sqrt(5.0) * d + (5.0 / 3.0) * d2) * torch.exp(-math.sqrt(5.0) * d)
        else:
            raise ValueError(f"unsupported kernel {self.kernel}/{self.nu}")
        return params["outputscale"] * k

    def _factor(self, x: torch.Tensor, y: torch.Tensor):
        params = self.constrained()
        n = x.shape[0]
        K = self._kmat(params, x, x) + params["noise"] * torch.eye(n, dtype=x.dtype, device=x.device)
        L = torch.linalg.cholesky(K)
        yc = y - params["mean"]
        a = torch.cholesky_solve(yc[:, None], L)[:, 0]
        return params, L, yc, a

    def nlml(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Exact NLML / n by Cholesky."""
        _, L, yc, a = self._factor(x, y)
        n = x.shape[0]
        logdet = 2 * torch.log(torch.diagonal(L)).sum()
        return 0.5 * ((yc * a).sum() + logdet + n * math.log(2 * math.pi)) / n

    @torch.no_grad()
    def predict(self, x: torch.Tensor, y: torch.Tensor, x_test: torch.Tensor, block: int = 2048):
        """Posterior mean and variance (with observation noise), blocked over test rows."""
        params, L, _, a = self._factor(x, y)
        means, variances = [], []
        for i in range(0, x_test.shape[0], block):
            Kst = self._kmat(params, x_test[i : i + block], x)
            means.append(Kst @ a + params["mean"])
            v = torch.linalg.solve_triangular(L, Kst.T, upper=False)
            variances.append(params["outputscale"] + params["noise"] - (v * v).sum(dim=0))
        return torch.cat(means), torch.clamp(torch.cat(variances), min=1e-8)
