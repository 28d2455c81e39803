"""The sharded sort chain on gloo CPU ranks against JAX's build_plan_sharded / apply_plan(axis_name=...).

One module fixture spawns four ranks (``simplex_gp_torch.parallel.launch``)
that run ``tests/torch_dist_bodies.py::sharded_chain_suite`` over the four of
them and over a subgroup of the first two: P = 4 and P = 2.  The parent
holds the results against JAX's sharded chain (``build_plan_sharded`` and
``apply_plan`` with ``axis_name``, under ``shard_map`` on ``make_mesh(P)``
of the suite's virtual CPU devices, tests/conftest.py), its ``jax.vjp``,
and the port's one-device chain, on the same numpy inputs.

Bounds: the applies rtol 1e-5 / atol 1e-5 (tests/test_parallel.py's filter
bounds), the position gradient rtol 1e-3 / atol 1e-4
(test_torch_chain_backward.py's), the NLML rtol 1e-4 and the raw gradients
rtol 1e-3 / atol 1e-4 (test_parallel.py's).  The sharded plan's global
fields are the one-device untrimmed plan's bit for bit, and its splat lists
this rank's part of it, as their definition gives them.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P
from torch_dist_bodies import dk_of, sharded_chain_suite
from torch_parity import rel_err

import simplex_gp_torch
from simplex_gp_torch.kernels import chain as KC
from simplex_gp_torch.linalg import mll as t_mll
from simplex_gp_torch.ops import kernels as t_kernels
from simplex_gp_torch.ops import lattice as t_lattice
from simplex_gp_torch.ops.filter import lattice_filter_exact_grad
from simplex_gp_torch.parallel import launch
from simplex_gp_tpu import BBMMConfig as JConfig
from simplex_gp_tpu import SimplexGP as JSimplexGP
from simplex_gp_tpu.linalg.mll import lattice_nlml as j_lattice_nlml
from simplex_gp_tpu.ops import kernels as j_kernels
from simplex_gp_tpu.ops.lattice import apply_plan as j_apply_plan
from simplex_gp_tpu.parallel import build_plan_sharded as j_build_plan_sharded
from simplex_gp_tpu.parallel import filter_sharded as j_filter_sharded
from simplex_gp_tpu.parallel import make_mesh as j_make_mesh

SIZES = {"pair": 2, "world": 4}
# Global and per-rank fields of a sharded chain plan.
GLOBAL = ("gather", "tapw", "n_lattice")
LISTS = ("long_rows", "long_first", "piece_row", "piece_start", "n_long", "n_pieces", "mid_rows", "n_mid")


def _j_dk(kernel):
    return j_kernels.rbf_kernel(kernel[1]) if kernel[0] == "rbf" else j_kernels.matern_kernel(*kernel[1:])


def _cases():
    filters = []
    # c = 2 at P = 4 leaves two blocks of padding alone; c = 3 pads one column at P = 2 and P = 4.
    for kernel, n, d, c, seed in ((("rbf", 1), 64, 3, 2, 0), (("matern", 1.5, 2), 96, 4, 3, 5)):
        rng = np.random.default_rng(seed)
        filters.append(dict(kernel=kernel, x=rng.normal(size=(n, d)).astype(np.float32),
                            v=rng.normal(size=(n, c)).astype(np.float32),
                            g=rng.normal(size=(n, c)).astype(np.float32)))
    rng = np.random.default_rng(3)
    n, d = 128, 3
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)).astype(np.float32)
    raw = {k: np.asarray(v) for k, v in JSimplexGP(num_dims=d, kernel="matern", nu=1.5, order=1)
           .init_params().items()}
    engine = dict(kernel=("matern", 1.5, 1), d=d, x=x, y=y, raw=raw,
                  probes=rng.choice([-1.0, 1.0], size=(n, 8)).astype(np.float32),
                  cfg=dict(cg_tolerance=1e-4, max_cg_iterations=200, max_lanczos_iterations=40, num_probes=8))
    return dict(filters=filters, engines=[engine])


@pytest.fixture(scope="module")
def run():
    """(cases, {tag: [each rank's results]}) of one four-rank launch."""
    cases = _cases()
    ranks = launch(sharded_chain_suite, 4, (cases,), device="cpu", timeout=300, threads=1)
    return cases, {tag: [r[tag] for r in ranks if tag in r] for tag in SIZES}


_JAX = {}


def _jax_apply(case, size):
    """JAX's sharded chain apply of the case's v, its n_lattice, its vjp in v (of v and of g) and in x (of g);
    each (case, size) computed once."""
    key = (id(case), size)
    if key in _JAX:
        return _JAX[key]
    jdk = _j_dk(case["kernel"])

    def shard_fn(x_loc, v_loc):
        plan = j_build_plan_sharded(x_loc, jdk.coeffs, jdk.variance, "data")
        return j_apply_plan(plan, v_loc, jdk.coeffs, axis_name="data"), plan.n_lattice

    def apply(xs, vs):
        return shard_map(shard_fn, mesh=j_make_mesh(size), in_specs=(P("data", None), P("data", None)),
                         out_specs=(P("data", None), P()), check_vma=False)(xs, vs)

    @jax.jit
    def everything(xs, vs, gs):
        out, nl = apply(xs, vs)
        _, vjp_v = jax.vjp(lambda v_: apply(xs, v_)[0], vs)
        _, vjp_x = jax.vjp(lambda x_: apply(x_, vs)[0], xs)
        return out, nl, vjp_v(vs)[0], vjp_v(gs)[0], vjp_x(gs)[0]

    names = ("forward", "n_lattice", "transposed", "grad_v", "grad_x")
    _JAX[key] = {k: np.asarray(t) for k, t in zip(names, everything(case["x"], case["v"], case["g"]))}
    return _JAX[key]


def _one_device_plan(case):
    dk = dk_of(case["kernel"])
    return dk, t_lattice.build_plan_chain(torch.from_numpy(case["x"]), dk.coeffs, dk.variance)


def _expected_part(plan, rank: int, size: int) -> dict:
    """Rank ``rank``'s part of the one-device plan by definition: its contributions (points rank n_loc ..)
    in the plan's row order, numbered by local point; their run ends over the live rows; their lists."""
    n = plan.weights.shape[0]
    n_loc, dp1 = n // size, plan.weights.shape[1]
    live = int(plan.n_lattice)
    mine = (plan.splat_points >= rank * n_loc) & (plan.splat_points < (rank + 1) * n_loc)
    rows = torch.searchsorted(plan.cnt, torch.arange(plan.splat_points.shape[0], dtype=torch.int32), right=True)
    cnt = torch.full((plan.cnt.shape[0],), n_loc * dp1, dtype=torch.int32)
    cnt[:live] = torch.cumsum(torch.bincount(rows[mine], minlength=live)[:live], 0).to(torch.int32)
    lists = dict(zip(LISTS, KC.run_lists(cnt, live, n_loc * dp1)))
    return dict(splat_points=plan.splat_points[mine] - rank * n_loc, splat_weights=plan.splat_weights[mine],
                cnt=cnt[:live], slice_idx=plan.slice_idx[rank * n_loc:(rank + 1) * n_loc],
                weights=plan.weights[rank * n_loc:(rank + 1) * n_loc], **lists)


@pytest.mark.parametrize("ci", [0, 1])
@pytest.mark.parametrize("tag", SIZES)
def test_sharded_chain_plan_is_the_one_device_plan_on_every_rank_and_build(run, tag, ci):
    """(a) n_lattice equal to JAX's; gather, tapw and n_lattice the same bits on every rank, in two builds
    and in the one-device untrimmed chain plan of all the points; each rank's slice_idx its window of the
    one-device plan's; its splat lists, run ends and run lists its part of the one-device plan's."""
    cases, res = run
    case, size = cases["filters"][ci], SIZES[tag]
    _, plan = _one_device_plan(case)
    nl = int(_jax_apply(case, size)["n_lattice"])
    ranks = res[tag]
    assert len(ranks) == size and int(plan.n_lattice) == nl
    for r in ranks:
        got = r["filters"][ci]["plan"]
        assert r["filters"][ci]["same_twice"]
        for field in GLOBAL:
            np.testing.assert_array_equal(got[field], getattr(plan, field).numpy())
        want = _expected_part(plan, r["rank"], size)
        assert got["cnt"].shape == (nl,)
        for field, value in want.items():
            np.testing.assert_array_equal(got[field], value.numpy(), err_msg=field)


@pytest.mark.parametrize("ci", [0, 1])
def test_transposed_maps_over_the_live_rows_are_the_full_maps_cut(ci):
    """The sharded transposed apply lays its maps out over the n_lattice live positions only (csrc/chain.cu,
    chain_maps_kernel with m = n_lattice): the full maps' first n_lattice columns, every one below
    n_lattice, since every axis order sorts the dead rows last."""
    _, plan = _one_device_plan(_cases()["filters"][ci])
    nl = int(plan.n_lattice)
    cut = KC.chain_maps_plain(plan.gather[:, :nl])
    assert nl < plan.gather.shape[-1]
    assert torch.equal(cut, KC.chain_maps_plain(plan.gather)[:, :nl])
    assert int(cut.max()) < nl


@pytest.mark.parametrize("ci", [0, 1])
@pytest.mark.parametrize("tag", SIZES)
def test_sharded_chain_plan_without_its_axis_is_refused(run, tag, ci):
    """apply_plan_chain without the axis raises on every rank's part, also where no two vertices merge, so
    its run ends are as many as its rows (the points spread 1,000-fold): a part has Mc = P N_loc rows, more
    than its N_loc contributions, which no one-device plan has."""
    _, res = run
    for r in res[tag]:
        f = r["filters"][ci]
        assert f["spread_all_live"]
        assert f["refused"] == [True, True]


@pytest.mark.parametrize("ci", [0, 1])
@pytest.mark.parametrize("tag", SIZES)
def test_sharded_chain_apply_matches_jax_and_one_device(run, tag, ci):
    """(b, c) The sharded chain apply forward and transposed against JAX's sharded apply and its vjp in v
    under shard_map, and against the port's one-device chain apply, rtol 1e-5 / atol 1e-5; its
    final-order table (n_lattice, c) against the one-device table's live rows; two calls the same bits."""
    cases, res = run
    case, size = cases["filters"][ci], SIZES[tag]
    dk, plan = _one_device_plan(case)
    want = _jax_apply(case, size)
    v = torch.from_numpy(case["v"])
    nl = int(plan.n_lattice)
    for r in res[tag]:
        f = r["filters"][ci]
        assert f["repeat"]
        for key, transpose in (("forward", False), ("transposed", True)):
            single, table = t_lattice.apply_plan_chain(plan, v, dk.coeffs, transpose=transpose, return_table=True)
            np.testing.assert_allclose(f[key], want[key], rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(f[key], single.numpy(), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(f[f"{key}_table"], table[:nl].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ci", [0, 1])
@pytest.mark.parametrize("tag", SIZES)
def test_sharded_chain_filter_gradients_match_jax_vjp(run, tag, ci):
    """(d) filter_sharded's backward (the transposed sharded apply, K5 at this rank's slice_idx) against
    jax.vjp of JAX's sharded apply: in v rtol 1e-5 / atol 1e-5, in the positions rtol 1e-3 / atol 1e-4;
    and the forward filter equal to the apply."""
    cases, res = run
    case = cases["filters"][ci]
    want = _jax_apply(case, SIZES[tag])
    for r in res[tag]:
        f = r["filters"][ci]
        np.testing.assert_array_equal(f["filter"], f["forward"])
        np.testing.assert_allclose(f["grad_v"], want["grad_v"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(f["grad_x"], want["grad_x"], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("tag", SIZES)
def test_sharded_chain_mixture_filter_matches_jax_and_one_device(run, tag):
    """(e) filter_sharded of a J = 8 mixture (one sharded chain plan a component) against JAX's sum of
    w_j filter_sharded(v, x alpha_j) under shard_map and its vjp, and against the port's one-process K12."""
    cases, res = run
    case, size = cases["filters"][1], SIZES[tag]
    jmk = j_kernels.mixture_kernel(1.5, 1, 8)

    def shard_fn(x_loc, v_loc):
        return sum(w * j_filter_sharded(v_loc, x_loc * a, jmk.base, "data") for w, a in zip(jmk.weights, jmk.alphas))

    def apply(xs, vs):
        return shard_map(shard_fn, mesh=j_make_mesh(size), in_specs=(P("data", None), P("data", None)),
                         out_specs=P("data", None), check_vma=False)(xs, vs)

    @jax.jit
    def with_vjp(xs, vs, gs):
        out, vjp = jax.vjp(apply, xs, vs)
        return (out, *vjp(gs))

    j_out, j_gx, j_gv = (np.asarray(t) for t in with_vjp(case["x"], case["v"], case["g"]))
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    v = torch.from_numpy(case["v"]).requires_grad_(True)
    out = lattice_filter_exact_grad(v, x, t_kernels.mixture_kernel(1.5, 1, 8))
    (out * torch.from_numpy(case["g"])).sum().backward()
    for r in res[tag]:
        f = r["mixture"]
        np.testing.assert_allclose(f["out"], np.asarray(j_out), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(f["out"], out.detach().numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(f["grad_v"], j_gv, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(f["grad_x"], j_gx, rtol=1e-3, atol=1e-4)
        assert rel_err(f["grad_v"], v.grad.numpy()) <= 1e-5 and rel_err(f["grad_x"], x.grad.numpy()) <= 1e-5


def _port_model(case):
    kind = case["kernel"]
    model = simplex_gp_torch.SimplexGP(num_dims=case["d"], kernel=kind[0], nu=kind[1], order=kind[-1],
                                       bbmm=t_mll.BBMMConfig(**case["cfg"]))
    model.load_raw(case["raw"])
    return model


@pytest.mark.parametrize("tag", SIZES)
def test_data_parallel_engine_on_the_sharded_chain_matches_jax_and_one_device(run, tag):
    """(f) data_parallel_loss_fn's NLML and raw gradients against JAX's shard_map engine (its sharded chain)
    and the port's one-device engine on the same rows and probes (loss rtol 1e-4, gradients rtol 1e-3 /
    atol 1e-4), with the same CG iterations; the step builds one sharded chain plan, applies it through
    the sharded chain (one transposed apply, in the backward) and calls neither K11a nor K11b."""
    cases, res = run
    case, size = cases["engines"][0], SIZES[tag]
    kind = case["kernel"]
    jmodel = JSimplexGP(num_dims=case["d"], kernel=kind[0], nu=kind[1], order=kind[-1], bbmm=JConfig(**case["cfg"]))
    cfg = dataclasses.replace(jmodel.bbmm, axis_name="data")

    def shard_loss(raw, x_loc, y_loc, z_loc):
        loss, grads = jax.value_and_grad(
            lambda r: j_lattice_nlml(jmodel.dk, cfg, jmodel.constrained(r), x_loc, y_loc, z_loc))(raw)
        return loss, jax.tree.map(lambda g: jax.lax.psum(g, "data"), grads)

    j_loss, j_grads = jax.jit(shard_map(shard_loss, mesh=j_make_mesh(size),
                                        in_specs=(P(), P("data", None), P("data"), P("data", None)),
                                        out_specs=(P(), P()), check_vma=False))(
        {k: np.asarray(v) for k, v in case["raw"].items()}, case["x"], case["y"], case["probes"])
    model = _port_model(case)
    stats = {}
    loss = model.nlml(torch.from_numpy(case["x"]), torch.from_numpy(case["y"]),
                      probes=torch.from_numpy(case["probes"]), stats=stats)
    loss.backward()
    for r in res[tag]:
        e = r["engines"][0]
        assert e["cg_iters"] == stats["cg_iters"]
        assert e["calls"] == dict(chain_build=1, chain_apply=e["cg_iters"] + 2, transposed=1, k11a=0, k11b=0)
        np.testing.assert_allclose(e["loss"], float(j_loss), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(e["loss"], float(loss.detach()), rtol=1e-4, atol=1e-4)
        for k, g in e["grads"].items():
            np.testing.assert_allclose(g, np.asarray(j_grads[k]), rtol=1e-3, atol=1e-4)
            np.testing.assert_allclose(g, getattr(model, k).grad.numpy(), rtol=1e-3, atol=1e-4)
