"""The port's data-parallel engine on gloo CPU ranks against JAX's shard_map engine.

One module fixture spawns four ranks (``simplex_gp_torch.parallel.launch``,
a ``file://`` rendezvous, one torch thread each) that run every sharded
check of ``tests/torch_dist_bodies.py`` over the four of them and over a
subgroup of the first two: P = 4 and P = 2.  The parent holds the results
against JAX's ``shard_map`` engine on ``make_mesh(P)`` of the suite's
virtual devices (tests/conftest.py) and against the port's single-device
engine, on the same numpy inputs.

Bounds, those of tests/test_parallel.py: the filter rtol 1e-5 / atol 1e-5,
the loss rtol 1e-4, gradients rtol 1e-3 / atol 1e-4.  JAX's sharded plan is
the sort chain, the port's the join plan (the same operator to rel 2e-5,
test_chain_plan.py).  The port's single-device engine runs its CG on the
sort chain (K3'), its sharded engine on the join; the two differ in the
order of the sums over rows and in the splat's summation (measured: filter
rel <= 7e-8, the same CG iteration counts).  The sharded
pivoted-Cholesky factor equals the single-device one bit for bit: every row
runs the same operations, and the winner of the gathered candidates is the
global first maximum, as the single-device argmax.  K11a's plans are the same
bits on every rank and in every build.
"""

import dataclasses
import importlib
import types

import jax
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P
from torch_dist_bodies import dk_of, parallel_suite
from torch_parity import rel_err

import simplex_gp_torch
from simplex_gp_torch.kernels import lattice as K
from simplex_gp_torch.linalg import mll as t_mll
from simplex_gp_torch.linalg.pivoted_cholesky import make_preconditioner, pivoted_cholesky_features, precond_solve
from simplex_gp_torch.ops import kernels as t_kernels
from simplex_gp_torch.ops import lattice as t_lattice
from simplex_gp_torch.ops.filter import lattice_filter_exact_grad
from simplex_gp_torch.parallel import launch, shard_batch
from simplex_gp_tpu import BBMMConfig as JConfig
from simplex_gp_tpu import SimplexGP as JSimplexGP
from simplex_gp_tpu.linalg import cg as j_cg
from simplex_gp_tpu.linalg.mll import lattice_nlml as j_lattice_nlml
from simplex_gp_tpu.ops import kernels as j_kernels
from simplex_gp_tpu.ops.lattice import apply_plan as j_apply_plan
from simplex_gp_tpu.parallel import build_plan_sharded_join as j_build_plan_sharded_join
from simplex_gp_tpu.parallel import make_mesh as j_make_mesh

j_pc = importlib.import_module("simplex_gp_tpu.linalg.pivoted_cholesky")

SIZES = {"pair": 2, "world": 4}
ENGINE_CFG = dict(cg_tolerance=1e-4, max_cg_iterations=200, max_lanczos_iterations=40, num_probes=8)
# __graft_entry__.py's dry run (variant A: d = 5, order 2, c = 1 + 4 probes padded, rank 96; variant B:
# rank 160 above the 128 local rows of a rank), 512 and 128 rows per rank of the four.
DRYRUN = [(512, 5, 2, 96), (128, 5, 1, 160)]


def _problem(n, d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)).astype(np.float32)
    return x, y


def _rademacher(n, p, seed):
    return np.random.default_rng(seed).choice([-1.0, 1.0], size=(n, p)).astype(np.float32)


def _cases():
    filters = []
    for kernel, n, d, c, seed in ((("rbf", 1), 64, 3, 2, 0), (("matern", 1.5, 2), 64, 4, 3, 5)):
        x, _ = _problem(n, d, seed)
        rng = np.random.default_rng(seed + 1)
        filters.append(dict(kernel=kernel, x=x, v=rng.normal(size=(n, c)).astype(np.float32),
                            g=rng.normal(size=(n, c)).astype(np.float32)))
    x, y = _problem(96, 2)
    raw = {k: np.asarray(v) for k, v in JSimplexGP(num_dims=2, kernel="rbf", order=1).init_params().items()}
    engine = dict(kernel=("rbf", 1), d=2, x=x, y=y, cfg=ENGINE_CFG, probes=_rademacher(96, 8, 7), raw=raw)
    # J = 8 RBF components of order 1 targeting Matern-1.5, with their profile-fit weights in both packages.
    mixture = dict(engine, kernel=("mixture", 1.5, 1), mix_components=8,
                   raw={k: np.asarray(v) for k, v in JSimplexGP(num_dims=2, kernel="mixture", mix_components=8)
                        .init_params().items()})
    pivoted = [dict(ref=1.3 * x, z=np.random.default_rng(3).normal(size=(96, 3)).astype(np.float32),
                    outputscale=0.7, nu=nu, rank=rank, noise=0.1) for nu, rank in ((0.0, 20), (1.5, 40))]
    dryrun = []
    for n_per, d, order, rank in DRYRUN:
        xd, yd = _problem(4 * n_per, d)
        dryrun.append(dict(kernel=("rbf", order), d=d, x=xd, y=yd, probes=_rademacher(4 * n_per, 4, 11),
                           cfg=dict(cg_tolerance=1e-2, max_cg_iterations=50, max_lanczos_iterations=20,
                                    num_probes=4, precond_rank=rank)))
    return dict(filters=filters, engine=engine, engine_lanczos=dict(engine, cfg=dict(ENGINE_CFG, slq_mode="lanczos")),
                engine_unpreconditioned=dict(engine, cfg=dict(ENGINE_CFG, slq_mode="lanczos", precond_rank=0)),
                ignored=dict(engine, cfg=dict(ENGINE_CFG, grad_mode="deriv_filter", plan_capacity=64)), mixture=mixture,
                end_to_end=dict(kernel=("rbf", 1), d=2, x=x, y=y, cfg=ENGINE_CFG, seed=0),
                pivoted=pivoted, dryrun=dryrun, cg=_cg_cases())


def _cg_cases():
    """Dense SPD systems of 300 rows and 11 columns (test_torch_cg_kernels.py's, its full-rank part spread
    wider): with the Woodbury preconditioner of its low-rank part, the "mean" stop and an 8-step record
    (19 iterations, the mean residual 1.5e-5 / 8.0e-6 after 18 / 19); and with none, the "column" stop (24
    iterations, every column 1.1e-5 or less after 24, the last above 1.8e-5 after 23)."""
    rng = np.random.default_rng(0)
    n, k = 300, 20
    L = (rng.normal(size=(n, k)) * np.geomspace(0.3, 0.01, k)).astype(np.float32)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    A = (L @ L.T + np.eye(n) + (Q * np.geomspace(10.0, 0.01, n)) @ Q.T).astype(np.float32)
    pre = make_preconditioner(torch.from_numpy(L), torch.tensor(np.float32(1.0)), n)
    b = rng.normal(size=(n, 11)).astype(np.float32)
    return [dict(A=A, b=b, kw=dict(tol=1e-5, max_iters=200, stop_mode="mean", tridiag_m=8),
                 **{f: getattr(pre, f).numpy() for f in ("U", "s2", "noise", "logdet", "gamma")}),
            dict(A=A, b=b, kw=dict(tol=1.5e-5, max_iters=300, stop_mode="column", tridiag_m=8))]


@pytest.fixture(scope="module")
def run():
    """(cases, {tag: [each rank's results]}) of one four-rank launch."""
    cases = _cases()
    ranks = launch(parallel_suite, 4, (cases,), device="cpu", timeout=300, threads=1)
    return cases, {tag: [r[tag] for r in ranks if tag in r] for tag in (*SIZES, "one")}


def _rows(a, size):
    """The rows shard_batch keeps: a multiple of the axis size."""
    return a[: (a.shape[0] // size) * size]


def _kernel_kw(case) -> dict:
    """SimplexGP's kernel arguments (both packages) of ("rbf", order), ("matern" | "mixture", nu, order)."""
    kind = case["kernel"]
    kw = dict(kernel=kind[0], order=kind[-1])
    if kind[0] != "rbf":
        kw["nu"] = kind[1]
    if kind[0] == "mixture":
        kw["mix_components"] = case["mix_components"]
    return kw


def _port_model(case, cfg):
    model = simplex_gp_torch.SimplexGP(num_dims=case["d"], bbmm=t_mll.BBMMConfig(**cfg), **_kernel_kw(case))
    if case.get("raw") is not None:
        model.load_raw(case["raw"])
    return model


def _single_device(case, size):
    """The port's single-device NLML, raw gradients and CG iterations on the same rows and probes."""
    model = _port_model(case, case["cfg"])
    stats = {}
    loss = model.nlml(torch.from_numpy(_rows(case["x"], size)), torch.from_numpy(_rows(case["y"], size)),
                      probes=torch.from_numpy(_rows(case["probes"], size)), stats=stats)
    loss.backward()
    return float(loss.detach()), {k: p.grad.numpy() for k, p in model.named_parameters()}, stats["cg_iters"]


@pytest.mark.parametrize("ci", [0, 1])
@pytest.mark.parametrize("tag", SIZES)
def test_sharded_filter_matches_jax_and_single_device(run, tag, ci):
    cases, res = run
    case, size = cases["filters"][ci], SIZES[tag]
    dk = dk_of(case["kernel"])
    jdk = j_kernels.rbf_kernel(1) if case["kernel"][0] == "rbf" else j_kernels.matern_kernel(1.5, 2)
    assert jdk.coeffs == pytest.approx(dk.coeffs) and jdk.variance == pytest.approx(dk.variance)

    def shard_fn(x_loc, v_loc):
        plan = j_build_plan_sharded_join(x_loc, jdk.coeffs, jdk.variance, "data")
        return j_apply_plan(plan, v_loc, jdk.coeffs, axis_name="data"), plan.n_lattice

    j_out, j_nl = jax.jit(shard_map(shard_fn, mesh=j_make_mesh(size), in_specs=(P("data", None), P("data", None)),
                                    out_specs=(P("data", None), P()), check_vma=False))(case["x"], case["v"])
    x, v = torch.from_numpy(case["x"]), torch.from_numpy(case["v"])
    single = t_lattice.apply_plan_join(t_lattice.build_plan_join(x, dk.coeffs, dk.variance), v, dk.coeffs)
    for r in res[tag]:
        f = r["filters"][ci]
        np.testing.assert_allclose(f["out"], np.asarray(j_out), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(f["out"], single.numpy(), rtol=1e-5, atol=1e-5)
        assert f["n_lattice"] == int(j_nl)


@pytest.mark.parametrize("ci", [0, 1])
@pytest.mark.parametrize("tag", SIZES)
def test_sharded_filter_gradients_match_single_device(run, tag, ci):
    """filter_sharded's backward (transposed K11b, K5 per rank) against the single-device exact gradient."""
    cases, res = run
    case = cases["filters"][ci]
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    v = torch.from_numpy(case["v"]).requires_grad_(True)
    (lattice_filter_exact_grad(v, x, dk_of(case["kernel"])) * torch.from_numpy(case["g"])).sum().backward()
    for r in res[tag]:
        f = r["filters"][ci]
        assert rel_err(f["grad_v"], v.grad.numpy()) <= 1e-5
        assert rel_err(f["grad_x"], x.grad.numpy()) <= 1e-5


@pytest.mark.parametrize("ci", [0, 1])
@pytest.mark.parametrize("tag", SIZES)
def test_sharded_apply_on_live_rows_repeats_and_matches_single_device(run, tag, ci):
    """K11b's twin on the row lists of the n_lattice live rows: forward and transposed against JAX's
    sharded apply and its vjp under shard_map and against the single-device port (rtol 1e-5, the
    filter's bound), the same bits over two calls, and its blurred table the old full-M buffer's rows
    below n_lattice bit for bit (the dead rows there all zero)."""
    cases, res = run
    case, size = cases["filters"][ci], SIZES[tag]
    dk = dk_of(case["kernel"])
    jdk = j_kernels.rbf_kernel(1) if case["kernel"][0] == "rbf" else j_kernels.matern_kernel(1.5, 2)

    def j_apply(xs, vs):
        def shard_fn(x_loc, v_loc):
            plan = j_build_plan_sharded_join(x_loc, jdk.coeffs, jdk.variance, "data")
            return j_apply_plan(plan, v_loc, jdk.coeffs, axis_name="data")

        return shard_map(shard_fn, mesh=j_make_mesh(size), in_specs=(P("data", None), P("data", None)),
                         out_specs=P("data", None), check_vma=False)(xs, vs)

    j_out, vjp = jax.vjp(lambda vs: j_apply(case["x"], vs), case["v"])
    want = {"k11b_forward": np.asarray(j_out), "k11b_transposed": np.asarray(vjp(case["v"])[0])}
    x, v = torch.from_numpy(case["x"]), torch.from_numpy(case["v"])
    plan = t_lattice.build_plan_join(x, dk.coeffs, dk.variance)
    for r in res[tag]:
        f = r["filters"][ci]
        assert f["k11b_rows"] == f["n_lattice"] < f["neighbors"].shape[1]
        for key, transpose in (("k11b_forward", False), ("k11b_transposed", True)):
            single = t_lattice.apply_plan_join(plan, v, dk.coeffs, transpose=transpose)
            np.testing.assert_allclose(f[key], single.numpy(), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(f[key], want[key], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(f["k11b_forward"], f["out"])
        assert f["k11b_repeat"] and f["k11b_live_equal"] and f["k11b_dead_zero"]


@pytest.mark.parametrize("tag", SIZES)
def test_sharded_mixture_filter_matches_single_device(run, tag):
    """filter_sharded of a J = 8 mixture (the weighted sum of its components' sharded filters, JAX's
    _khat_matmul_diff with an axis_name, mll.py:100-104) and its gradients against the one-process K12."""
    cases, res = run
    case = cases["filters"][0]
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    v = torch.from_numpy(case["v"]).requires_grad_(True)
    out = lattice_filter_exact_grad(v, x, t_kernels.mixture_kernel(1.5, 1, 8))
    (out * torch.from_numpy(case["g"])).sum().backward()
    for r in res[tag]:
        f = r["filter_mixture"]
        np.testing.assert_allclose(f["out"], out.detach().numpy(), rtol=1e-5, atol=1e-5)
        assert rel_err(f["grad_v"], v.grad.numpy()) <= 1e-5
        assert rel_err(f["grad_x"], x.grad.numpy()) <= 1e-5


@pytest.mark.parametrize("ci", [0, 1])
@pytest.mark.parametrize("tag", SIZES)
def test_ordered_dedup_is_the_same_on_every_rank_and_build(run, tag, ci):
    """K11a: every rank's global plan is the same bits, built twice or from the gathered hashes alone."""
    _, res = run
    ranks = [r["filters"][ci] for r in res[tag]]
    assert len(ranks) == SIZES[tag]
    for f in ranks:
        np.testing.assert_array_equal(f["seg_all"], ranks[0]["seg_all"])
        np.testing.assert_array_equal(f["neighbors"], ranks[0]["neighbors"])
        assert f["same_twice"] and f["seg_window"] and f["same_plan"]


@pytest.mark.parametrize("order,kind", [(1, "rbf"), (2, "matern"), (3, "rbf")])
def test_ordered_dedup_numbers_rows_by_first_vertex_and_keeps_the_operator(order, kind):
    """K11a's plain version: rows in order of first appearance, K2's n_lattice and operator (K3 rel 1e-6)."""
    x, _ = _problem(150, 3, 2)
    dk = dk_of(("rbf", order) if kind == "rbf" else ("matern", 1.5, order))
    E, a, oh1, oh2 = t_lattice._lattice_constants(3, dk.coeffs, dk.variance, torch.device("cpu"))
    h1, h2, w = K.geometry_plain(torch.from_numpy(x), E, a)
    seg, nb, nl = K.dedup_ordered_plain(h1, h2, oh1, oh2)
    seg2, nb2, _ = K.dedup_ordered_plain(h1.clone(), h2.clone(), oh1, oh2)
    assert torch.equal(seg, seg2) and torch.equal(nb, nb2)
    rows, first = np.unique(seg.numpy(), return_index=True)
    np.testing.assert_array_equal(rows, np.arange(int(nl)))
    assert (np.diff(first) > 0).all()
    kseg, knb, knl = K.dedup_neighbors_plain(h1, h2, oh1, oh2)
    assert int(nl) == int(knl)
    v = torch.from_numpy(np.random.default_rng(0).normal(size=(150, 2)).astype(np.float32))
    norm, taps = t_lattice.SLICE_NORM(3), list(dk.coeffs)
    out = K.apply_plain(seg.reshape(150, 4), w, nb, v, taps, norm)
    ref = K.apply_plain(kseg.reshape(150, 4), w, knb, v, taps, norm)
    assert rel_err(out, ref) <= 1e-6


@pytest.mark.parametrize("engine", ["engine", "engine_lanczos", "engine_unpreconditioned", "mixture"])
@pytest.mark.parametrize("tag", SIZES)
def test_sharded_engine_matches_jax_same_probes(run, tag, engine):
    """Port of test_sharded_engine_matches_single_device_same_probes against JAX's shard_map engine,
    with the SLQ log-det from the CG tridiagonals and from a Lanczos run, with and without the
    preconditioner, and for a J = 8 mixture (one sharded plan per component, JAX mll.py:100-104,
    :164-168)."""
    cases, res = run
    case, size = cases[engine], SIZES[tag]
    model = JSimplexGP(num_dims=case["d"], bbmm=JConfig(**case["cfg"]), **_kernel_kw(case))
    cfg = dataclasses.replace(model.bbmm, axis_name="data")

    def shard_loss(raw, x_loc, y_loc, z_loc):
        loss, grads = jax.value_and_grad(
            lambda r: j_lattice_nlml(model.dk, cfg, model.constrained(r), x_loc, y_loc, z_loc))(raw)
        return loss, jax.tree.map(lambda g: jax.lax.psum(g, "data"), grads)

    j_loss, j_grads = jax.jit(shard_map(shard_loss, mesh=j_make_mesh(size),
                                        in_specs=(P(), P("data", None), P("data"), P("data", None)),
                                        out_specs=(P(), P()), check_vma=False))(
        {k: np.asarray(v) for k, v in case["raw"].items()}, case["x"], case["y"], case["probes"])
    for r in res[tag]:
        e = r[engine]
        np.testing.assert_allclose(e["loss"], float(j_loss), rtol=1e-4, atol=1e-4)
        for k, g in e["grads"].items():
            np.testing.assert_allclose(g, np.asarray(j_grads[k]), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("engine", ["engine", "engine_lanczos", "engine_unpreconditioned", "mixture"])
@pytest.mark.parametrize("tag", SIZES)
def test_sharded_engine_matches_single_device_port(run, tag, engine):
    """The same rows and probes on one process: loss, gradients, and the CG iteration count on every rank
    (the mixture's one process runs K12 on its stacked plan)."""
    cases, res = run
    loss, grads, iters = _single_device(cases[engine], SIZES[tag])
    for r in res[tag]:
        e = r[engine]
        assert e["cg_iters"] == iters
        np.testing.assert_allclose(e["loss"], loss, rtol=1e-4, atol=1e-4)
        for k, g in e["grads"].items():
            np.testing.assert_allclose(g, grads[k], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("tag", SIZES)
def test_sharded_engine_ignores_deriv_mode_and_capacity(run, tag):
    """As JAX's sharded engine: grad_mode="deriv_filter" runs the exact gradient, plan_capacity is not applied."""
    _, res = run
    for r in res[tag]:
        assert r["ignored"]["loss"] == r["engine"]["loss"]
        for k, g in r["ignored"]["grads"].items():
            np.testing.assert_array_equal(g, r["engine"]["grads"][k])


@pytest.mark.parametrize("ci", [0, 1])
@pytest.mark.parametrize("tag", SIZES)
def test_sharded_pivoted_cholesky_matches_single_device(run, tag, ci):
    """K6' factor bit-equal to K6's, L L^T z and the Woodbury solve to f32 sums, rank 40 above 24 local rows."""
    cases, res = run
    case = cases["pivoted"][ci]
    ref, z = torch.from_numpy(case["ref"]), torch.from_numpy(case["z"])
    s = torch.tensor(case["outputscale"], dtype=torch.float32)
    pc = pivoted_cholesky_features(ref, s * torch.ones(ref.shape[0]), case["nu"], s, case["rank"])
    pre = make_preconditioner(pc.L, torch.tensor(case["noise"]), ref.shape[0])
    solve = precond_solve(pre, z).numpy()
    for r in res[tag]:
        p = r["pivoted"][ci]
        np.testing.assert_array_equal(p["L"], pc.L.numpy())
        llt = p["L"] @ (p["L"].T @ case["z"])
        assert rel_err(llt, pc.L.numpy() @ (pc.L.numpy().T @ case["z"])) <= 1e-6
        assert rel_err(p["solve"], solve) <= 1e-5
        np.testing.assert_allclose(p["logdet"], float(pre.logdet), rtol=1e-6)
    held = np.stack([r["pivoted"][ci]["pivots"] for r in res[tag]])  # each pivot on exactly one rank
    assert ((held >= 0).sum(axis=0) == 1).all()


@pytest.mark.parametrize("tag", SIZES)
def test_data_parallel_loss_fn_end_to_end(run, tag):
    """Per-rank probes from (seed, rank): finite, the same loss on every rank, bit-equal params after Adam,
    and the single-device loss within the trace estimator's scatter (test_parallel.py's bound)."""
    cases, res = run
    ranks = [r["end_to_end"] for r in res[tag]]
    case = cases["end_to_end"]
    model = _port_model(case, case["cfg"])
    single = float(model.nlml(torch.from_numpy(case["x"]), torch.from_numpy(case["y"]),
                              generator=torch.Generator().manual_seed(0)).detach())
    for e in ranks:
        assert np.isfinite(e["loss"]) and e["loss"] == ranks[0]["loss"]
        assert all(np.isfinite(g).all() for g in e["grads"].values())
        for k, p in e["params"].items():
            np.testing.assert_array_equal(p, ranks[0]["params"][k])
        np.testing.assert_allclose(e["loss"], single, rtol=0.25, atol=0.25)


@pytest.mark.parametrize("vi", range(len(DRYRUN)))
@pytest.mark.parametrize("tag", SIZES)
def test_dryrun_variants_match_single_device(run, tag, vi):
    """__graft_entry__.py's two dry-run geometries: one data-parallel Adam step on P ranks.

    Against the single-device port on the same rows and probes: loss rtol
    1e-4 and gradients rtol 1e-3 / atol 1e-4 (the CG at tol 1e-2 runs the
    same iterations), and bit-equal parameters on every rank after the step.
    """
    cases, res = run
    case = cases["dryrun"][vi]
    loss, grads, iters = _single_device(case, SIZES[tag])
    ranks = [r["dryrun"][vi] for r in res[tag]]
    for e in ranks:
        assert e["cg_iters"] == iters
        np.testing.assert_allclose(e["loss"], loss, rtol=1e-4)
        for k, g in e["grads"].items():
            np.testing.assert_allclose(g, grads[k], rtol=1e-3, atol=1e-4)
        for k, p in e["params"].items():
            np.testing.assert_array_equal(p, ranks[0]["params"][k])


def test_shard_batch_truncates_to_the_axis_size():
    """Port of test_shard_batch_truncates_to_mesh_multiple: 10 rows over 8 ranks keep 8, never padded."""
    x = np.arange(30, dtype=np.float32).reshape(10, 3)
    shards = [shard_batch(types.SimpleNamespace(rank=r, size=8), x, device="cpu") for r in range(8)]
    assert sum(s.shape[0] for s in shards) == 8
    np.testing.assert_array_equal(torch.cat(shards).numpy(), x[:8])
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(types.SimpleNamespace(rank=0, size=8), x, remainder="error", device="cpu")
    x_elev = np.zeros((10623, 18), np.float32)  # elevators' training rows at P = 2
    assert shard_batch(types.SimpleNamespace(rank=1, size=2), x_elev, device="cpu").shape[0] == 5311


def test_rank_probe_streams_differ_by_rank_and_repeat_by_seed():
    """SimplexGP.nlml's per-rank probes (JAX's fold_in of the shard index): one stream per (seed, rank)."""
    from simplex_gp_torch.models.exact_gp import rademacher, rank_generator

    def draw(seed, rank):
        return rademacher((64, 4), rank_generator(seed, rank))

    assert torch.equal(draw(3, 1), draw(3, 1))
    assert not torch.equal(draw(3, 0), draw(3, 1)) and not torch.equal(draw(3, 1), draw(4, 1))



# ---- K10', the sharded CG: the kernels' loop over gathered block partials ------------------------


def _jax_cg(case, size):
    """JAX's cg_solve under shard_map on the same rows: x and the iteration count."""
    woodbury = case.get("U") is not None

    def shard_fn(A_loc, b_loc, *U_loc):
        precond = None
        if woodbury:
            jP = j_pc.Preconditioner(U=U_loc[0], **{k: case[k] for k in ("s2", "noise", "logdet", "gamma")})
            precond = lambda V: j_pc.precond_solve(jP, V, "data")
        res = j_cg.cg_solve(lambda V: A_loc @ jax.lax.all_gather(V, "data", tiled=True), b_loc, precond=precond,
                            axis_name="data", **case["kw"])
        return res.x, res.iterations

    args = (case["A"], case["b"]) + ((case["U"],) if woodbury else ())
    x, it = jax.jit(shard_map(shard_fn, mesh=j_make_mesh(size), in_specs=(P("data", None),) * len(args),
                              out_specs=(P("data", None), P()), check_vma=False))(*args)
    return np.asarray(x), int(it)


@pytest.mark.parametrize("ci", [0, 1])
@pytest.mark.parametrize("tag", SIZES)
def test_sharded_cg_state_is_bit_equal_on_every_rank(run, tag, ci):
    """Every rank reduces the same gathered partials: iterations, best residuals and SLQ record bit-equal."""
    _, res = run
    ranks = [r["cg"][ci] for r in res[tag]]
    assert len(ranks) == SIZES[tag] and ranks[0]["iterations"] > 10
    for r in ranks:
        assert r["iterations"] == ranks[0]["iterations"]
        np.testing.assert_array_equal(r["residual"], ranks[0]["residual"])
        for got, want in zip(r["record"], ranks[0]["record"]):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ci", [0, 1])
@pytest.mark.parametrize("tag", SIZES)
def test_sharded_cg_matches_single_device_cg_loop(run, tag, ci):
    """The gathered solution within rel 1e-5 of the single-device CGLoop on all rows, the same iterations, and
    the record of the first 8 steps within rel 1e-5 (the ranks' partial sums are another order of the same
    dots).  The final residuals are not compared: near 1e-5, float32's floor for these systems, they follow
    the summation order (the port's and JAX's single-device solves differ there by up to 77%)."""
    _, res = run
    for r in (r_["cg"][ci] for r_ in res[tag]):
        single = r["single"]
        assert r["iterations"] == single["iterations"]
        assert rel_err(r["x"], single["x"]) <= 1e-5
        np.testing.assert_array_equal(r["record"][2], single["record"][2])
        for got, want in zip(r["record"][:2], single["record"][:2]):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("ci", [0, 1])
@pytest.mark.parametrize("tag", SIZES)
def test_sharded_cg_matches_jax_shard_map(run, tag, ci):
    """Against JAX's cg_solve with axis_name under shard_map (every dot a psum): equal iterations, x rel 1e-5."""
    cases, res = run
    x, iters = _jax_cg(cases["cg"][ci], SIZES[tag])
    for r in (r_["cg"][ci] for r_ in res[tag]):
        assert r["iterations"] == iters
        assert rel_err(r["x"], x) <= 1e-5


@pytest.mark.parametrize("ci", [0, 1])
def test_one_rank_axis_is_the_single_device_solve(run, ci):
    """make_mesh(1): one rank's gathered partials are its own, so the solve is the single-device one bit for bit."""
    _, res = run
    one = res["one"]
    assert len(one) == 1
    it_one, it_single = one[0]["cg"][ci]["iterations"]
    assert it_one == it_single > 10
    assert all(one[0]["cg"][ci]["equal"]) and len(one[0]["cg"][ci]["equal"]) == 5


@pytest.mark.parametrize("ci,start,per_iteration", [(0, 3, 3), (1, 2, 2)])
@pytest.mark.parametrize("tag", SIZES)
def test_sharded_cg_collectives_an_iteration(run, tag, ci, start, per_iteration):
    """Besides the MVM's: three an iteration with a Woodbury preconditioner (pap; U^T r; r . r with r . z),
    two without one; at the start the layout check, U^T b (with the preconditioner) and b . b with r0 . z0."""
    _, res = run
    for r in (r_["cg"][ci] for r_ in res[tag]):
        assert r["cg_collectives"] == start + per_iteration * r["iterations"]
