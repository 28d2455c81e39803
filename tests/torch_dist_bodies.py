"""Rank bodies of the data-parallel tests (not collected: no test_ prefix).

``simplex_gp_torch.parallel.launch`` runs these in fresh processes, one per
rank, on the CPU over gloo.  This module imports no jax (nor anything that
does), so the spawned ranks never load it: the tests compare the results
with JAX in the parent process.  Inputs and results are numpy arrays.
"""

import numpy as np
import torch

from simplex_gp_torch import SimplexGP
from simplex_gp_torch.kernels import lattice as K
from simplex_gp_torch.kernels.chain import chain_splat_plain
from simplex_gp_torch.kernels.lattice import dedup_ordered_plain, geometry_plain
from simplex_gp_torch.linalg.cg import cg_solve
from simplex_gp_torch.linalg.mll import BBMMConfig
from simplex_gp_torch.linalg.pivoted_cholesky import (
    Preconditioner,
    make_preconditioner,
    pivoted_cholesky_features,
    precond_solve,
)
from simplex_gp_torch.ops import kernels as kern
from simplex_gp_torch.ops.lattice import SLICE_NORM, _lattice_constants, apply_plan_join
from simplex_gp_torch.parallel import (
    build_plan_sharded_join,
    data_parallel_loss_fn,
    filter_sharded,
    host_local_batch,
    initialize_distributed,
    is_distributed,
    local_device,
    make_mesh,
    replicate,
    shard_batch,
)

CPU = torch.device("cpu")


def dk_of(spec):
    """A DiscretizedKernel from ("rbf", order) or ("matern", nu, order)."""
    return kern.rbf_kernel(spec[1]) if spec[0] == "rbf" else kern.matern_kernel(spec[1], spec[2])


def _gathered(axis, t):
    return axis.all_gather(t.detach().contiguous()).numpy()


def _filter(axis, case):
    """The sharded plan and filter of one case, its gradients, and the plan twice for K11a."""
    dk = dk_of(case["kernel"])
    x, v, g = shard_batch(axis, case["x"], case["v"], case["g"], device=CPU)
    plan = build_plan_sharded_join(x, dk.coeffs, dk.variance, axis)
    again = build_plan_sharded_join(x, dk.coeffs, dk.variance, axis)
    out = apply_plan_join(plan, v, dk.coeffs, axis=axis)
    x.requires_grad_(True)
    v.requires_grad_(True)
    (filter_sharded(v, x, dk, axis) * g).sum().backward()
    # The global plan from the gathered hashes, as every rank builds it.
    E, a, oh1, oh2 = _lattice_constants(x.shape[1], dk.coeffs, dk.variance, CPU)
    h1, h2, _ = geometry_plain(x.detach(), E, a)
    seg_all, nb_all, _ = dedup_ordered_plain(axis.all_gather(h1), axis.all_gather(h2), oh1, oh2)
    k11b = _k11b(axis, plan, v.detach(), dk)
    return dict(
        **k11b, out=_gathered(axis, out), n_lattice=int(plan.n_lattice), grad_v=_gathered(axis, v.grad),
        grad_x=_gathered(axis, x.grad), seg_all=seg_all.numpy(), neighbors=plan.neighbors.numpy(),
        same_twice=bool(torch.equal(plan.seg_ids, again.seg_ids) and torch.equal(plan.neighbors, again.neighbors)),
        seg_window=bool(torch.equal(plan.seg_ids.reshape(-1), seg_all.reshape(-1, *plan.seg_ids.shape)[axis.rank]
                                    .reshape(-1))),
        same_plan=bool(torch.equal(nb_all, plan.neighbors)),
    )


def _full_table(axis, plan, v, taps, transpose):
    """K11b's blurred table in the old layout, all M = n (d+1) rows of the sharded plan: this rank's
    row-order splat of each column block over the M rows, the reduce-scatter, the blur with the plan's
    own neighbour ids, the all-gather; the same arithmetic as the live-row apply."""
    M, c = plan.neighbors.shape[1], v.shape[1]
    cb = -(-c // axis.size)
    rows = K._rows_plain(plan.seg_ids, plan.weights, M, plan.n_lattice)
    padded = torch.nn.functional.pad(v, (0, axis.size * cb - c))
    blocks = torch.stack([chain_splat_plain(rows, padded[:, b * cb:(b + 1) * cb].contiguous())
                          for b in range(axis.size)])
    mine = K._blur_plain(axis.psum_scatter(blocks), plan.neighbors, taps, transpose)
    return axis.all_gather_blocks(mine).permute(1, 0, 2).reshape(M, axis.size * cb)[:, :c]


def _k11b(axis, plan, v, dk):
    """K11b forward and transposed on the plan's row lists, twice; its tables against the full-M layout."""
    taps, norm = list(dk.coeffs), SLICE_NORM(plan.seg_ids.shape[1] - 1)
    nl = int(plan.n_lattice)
    res = dict(k11b_repeat=True, k11b_live_equal=True, k11b_dead_zero=True)
    for transpose in (False, True):
        out, table = K.lattice_apply_sharded(*plan[:4], v, taps, norm, axis, transpose, True, plan.rows)
        again, table2 = K.lattice_apply_sharded(*plan[:4], v, taps, norm, axis, transpose, True, plan.rows)
        full = _full_table(axis, plan, v, taps, transpose)
        res["k11b_repeat"] &= bool(torch.equal(out, again) and torch.equal(table, table2))
        res["k11b_live_equal"] &= table.shape[0] == nl and bool(torch.equal(table, full[:nl]))
        res["k11b_dead_zero"] &= bool((full[nl:] == 0).all())
        res["k11b_transposed" if transpose else "k11b_forward"] = _gathered(axis, out)
    res["k11b_rows"] = int(plan.rows.cnt.shape[0])
    return res


def _filter_mixture(axis, case):
    """filter_sharded of a J = 8 mixture (one sharded plan a component) and its gradients, gathered."""
    dk = kern.mixture_kernel(1.5, 1, 8)
    x, v, g = shard_batch(axis, case["x"], case["v"], case["g"], device=CPU)
    x.requires_grad_(True)
    v.requires_grad_(True)
    out = filter_sharded(v, x, dk, axis)
    (out * g).sum().backward()
    return dict(out=_gathered(axis, out), grad_v=_gathered(axis, v.grad), grad_x=_gathered(axis, x.grad))


def _model(spec, cfg, raw):
    dk = spec["kernel"]
    mixture = dict(mix_components=spec["mix_components"]) if dk[0] == "mixture" else {}
    model = SimplexGP(num_dims=spec["d"], kernel=dk[0], nu=dk[1] if dk[0] != "rbf" else 1.5,
                      order=dk[-1], bbmm=BBMMConfig(**cfg), **mixture)
    if raw is not None:
        model.load_raw(raw)
    return model


def _engine(axis, case, adam_lr=None):
    """data_parallel_loss_fn on this rank's rows: loss, psum'd gradients, CG iterations, one Adam step."""
    model = _model(case, case["cfg"], case.get("raw"))
    replicate(axis, model)
    x, y = shard_batch(axis, case["x"], case["y"], device=CPU)
    probes = None if case.get("probes") is None else shard_batch(axis, case["probes"], device=CPU)
    stats = {}
    loss, grads = data_parallel_loss_fn(model, axis)(x, y, seed=case.get("seed", 0), probes=probes, stats=stats)
    res = dict(loss=float(loss), grads={k: g.numpy().copy() for k, g in grads.items()}, cg_iters=stats["cg_iters"])
    if adam_lr is not None:
        opt = torch.optim.Adam(model.parameters(), lr=adam_lr)
        opt.step()
        res["params"] = {k: p.detach().numpy().copy() for k, p in model.named_parameters()}
    return res


def _pivoted(axis, case):
    """The sharded factor and preconditioner, gathered to all rows."""
    ref, z = shard_batch(axis, case["ref"], case["z"], device=CPU)
    s = torch.tensor(case["outputscale"], dtype=torch.float32)
    pc = pivoted_cholesky_features(ref, s * torch.ones(ref.shape[0]), case["nu"], s, case["rank"], axis)
    P = make_preconditioner(pc.L, torch.tensor(case["noise"]), axis.n_global(ref.shape[0]), axis)
    return dict(L=_gathered(axis, pc.L), solve=_gathered(axis, precond_solve(P, z, axis)),
                logdet=float(P.logdet), pivots=pc.pivots.numpy())


def _cg_system(case, rows=slice(None)):
    """The dense operator's rows, the right-hand sides and the Woodbury preconditioner (None without one)."""
    A, b = torch.from_numpy(case["A"][rows]), torch.from_numpy(case["b"][rows])
    if case.get("U") is None:
        return A, b, None
    pre = Preconditioner(U=torch.from_numpy(case["U"][rows]), **{k: torch.tensor(case[k])
                                                                 for k in ("s2", "noise", "logdet", "gamma")})
    return A, b, pre


def _result(res):
    return dict(iterations=res.iterations, residual=res.residual_norm.numpy().copy(),
                record=None if res.alphas is None else [res.alphas.numpy().copy(), res.betas.numpy().copy(),
                                                        res.tmask.numpy().copy()])


def _cg(axis, case):
    """The sharded CG (K10') on this rank's rows of a dense SPD system: the gathered solution, the state and
    record, the CG's collectives apart from the MVM's, and the single-device solve in this process."""
    n_loc = case["A"].shape[0] // axis.size
    A, b, pre = _cg_system(case, slice(axis.rank * n_loc, (axis.rank + 1) * n_loc))
    mvm = []

    def matmul(V):
        mvm.append(1)
        return A @ axis.all_gather(V)

    axis.timing = True
    axis.reset_stats()
    res = cg_solve(matmul, b, precond=pre, axis=axis, **case["kw"])
    axis.timing = False
    A1, b1, pre1 = _cg_system(case)
    single = cg_solve(lambda V: A1 @ V, b1, precond=pre1, **case["kw"])
    return dict(_result(res), x=_gathered(axis, res.x), cg_collectives=axis.stats["calls"] - len(mvm),
                single=dict(_result(single), x=single.x.numpy()))


def _cg_one_rank(axis, case):
    """A one-rank axis against the single-device solve in this process: torch.equal, field by field."""
    A, b, pre = _cg_system(case)
    one = cg_solve(lambda V: A @ axis.all_gather(V), b, precond=pre, axis=axis, **case["kw"])
    single = cg_solve(lambda V: A @ V, b, precond=pre, **case["kw"])
    return dict(iterations=(one.iterations, single.iterations),
                equal=[bool(torch.equal(u, v)) for u, v in zip(one, single) if isinstance(u, torch.Tensor)])


def parallel_suite(axis, cases):
    """Every sharded check of tests/test_torch_parallel.py, over the world and over its first two ranks."""
    torch.manual_seed(0)
    out = {}
    for tag, ax in (("world", axis), ("pair", make_mesh(2))):
        if ax is None:  # ranks 2 and 3 sit out the two-rank checks
            continue
        out[tag] = dict(
            size=ax.size,
            filters=[_filter(ax, c) for c in cases["filters"]],
            filter_mixture=_filter_mixture(ax, cases["filters"][0]),
            engine=_engine(ax, cases["engine"]),
            engine_lanczos=_engine(ax, cases["engine_lanczos"]),
            engine_unpreconditioned=_engine(ax, cases["engine_unpreconditioned"]),
            ignored=_engine(ax, cases["ignored"]),
            mixture=_engine(ax, cases["mixture"]),
            pivoted=[_pivoted(ax, c) for c in cases["pivoted"]],
            end_to_end=_engine(ax, cases["end_to_end"], adam_lr=0.1),
            dryrun=[_engine(ax, c, adam_lr=0.1) for c in cases["dryrun"]],
            cg=[_cg(ax, c) for c in cases["cg"]],
        )
    one = make_mesh(1)
    if one is not None:
        out["one"] = dict(cg=[_cg_one_rank(one, c) for c in cases["cg"]])
    axis.psum(torch.zeros(1))  # no rank leaves while the pair still runs
    return out


def distributed_suite(axis, x, y):
    """The multi-process counterparts of tests/test_distributed.py, and the group helpers."""
    n_loc = x.shape[0] // axis.size
    rows = slice(axis.rank * n_loc, (axis.rank + 1) * n_loc)
    gx, gy = host_local_batch(x[rows], y[rows])
    sx, sy = shard_batch(axis, x, y)
    pair = make_mesh(2)
    return dict(
        size=axis.size, rank=axis.rank, again=initialize_distributed(), distributed=is_distributed(),
        device=str(local_device()), host_equals_shard=bool(torch.equal(gx, sx) and torch.equal(gy, sy)),
        gathered=axis.all_gather(gx).numpy(),
        pair_sum=None if pair is None else float(pair.psum(torch.tensor(float(axis.rank + 1)))),
        pair_size=None if pair is None else pair.size,
    )


def card_sharded_apply(axis, x, v):
    """K11b and its plain version on this rank's rows, on the card (tests/test_torch_kernels_cuda.py)."""
    dk = kern.rbf_kernel(1)
    x_loc, v_loc = shard_batch(axis, x, v)
    plan = build_plan_sharded_join(x_loc, dk.coeffs, dk.variance, axis)
    norm = SLICE_NORM(x.shape[1])
    K.lattice_apply_sharded.launches = 0
    out = {"neighbors": plan.neighbors.cpu().numpy()}
    for c in (5, 11):
        vc = v_loc[:, :c].contiguous()
        for transpose in (False, True):
            kernel = K.lattice_apply_sharded(*plan[:4], vc, dk.coeffs, norm, axis, transpose, rows=plan.rows)
            plain = K.apply_sharded_plain(*plan[:4], vc, dk.coeffs, norm, axis, transpose, rows=plan.rows)
            out[(c, transpose)] = dict(kernel=kernel.cpu().numpy(), plain=plain.cpu().numpy())
    out["launches"] = K.lattice_apply_sharded.launches
    return out


def raise_on_rank_one(axis):
    if axis.rank == 1:
        raise ValueError("rank one fails on purpose")
    return axis.rank


def hang_on_rank_one(axis):
    """Rank 1 never joins the all-reduce that rank 0 waits in."""
    if axis.rank == 0:
        axis.psum(torch.ones(1))
    else:
        import time

        time.sleep(60)
    return axis.rank
