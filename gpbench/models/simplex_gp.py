"""The program's Simplex-GP model (simplex_gp_torch/models/exact_gp.py::SimplexGP) at a configuration's
settings: kernel, smoothness, order, noise floor, the CG's and Lanczos's limits, the preconditioner's rank, the
probes, the training plan's capacity and the eval CG's tolerance."""

from __future__ import annotations

__all__ = ["build"]


def build(cfg: dict, device):
    from simplex_gp_torch.linalg.mll import BBMMConfig
    from simplex_gp_torch.models.exact_gp import SimplexGP

    bbmm = BBMMConfig(cg_tolerance=cfg["cg_tolerance"], max_cg_iterations=cfg["max_cg_iterations"],
                      max_lanczos_iterations=cfg["root_rank"], precond_rank=cfg["precond_rank"],
                      num_probes=cfg["num_probes"], plan_capacity=cfg["plan_capacity"])
    return SimplexGP(num_dims=cfg["d"], kernel=cfg["kernel"], nu=cfg["nu"], order=cfg["order"],
                     min_noise=cfg["min_noise"], bbmm=bbmm, eval_cg_tolerance=cfg["eval_cg_tolerance"], device=device)
