"""The port's process-group runtime: ports of tests/test_distributed.py, and the launcher.

tests/test_distributed.py pins the single-process contracts of JAX's
runtime; the port's are tested in one process where they are (no launcher,
no card) and on four spawned gloo CPU ranks where they need a group (one
module fixture, ``tests/torch_dist_bodies.distributed_suite``).  The
launcher must report a rank that raises, and turn a collective that one
rank never joins into an error at its deadline.  The port, its rank bodies
and chip_smoke.py import with jax blocked.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_dist_bodies import distributed_suite, hang_on_rank_one, raise_on_rank_one

from simplex_gp_torch.parallel import initialize_distributed, is_distributed, launch, local_device

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ranks():
    x = np.arange(64, dtype=np.float32).reshape(16, 4)
    y = np.arange(16, dtype=np.float32)
    return x, launch(distributed_suite, 4, (x, y), device="cpu", timeout=120, threads=1)


def test_initialize_noop_without_launcher(monkeypatch):
    """Port of test_initialize_noop_without_coordinator: no launcher, no group, False."""
    for v in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(v, raising=False)
    assert initialize_distributed() is False
    assert is_distributed() is False


def test_cuda_ranks_without_a_card_raise():
    """No fallback to the CPU: a card is asked for and there is none."""
    with pytest.raises(RuntimeError, match="cuda"):
        initialize_distributed(init_method="file:///nonexistent", rank=0, world_size=1, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        local_device()


def test_global_mesh_spans_all_ranks(ranks):
    """Port of test_global_mesh_spans_all_devices: make_mesh() is the whole group, every rank in it."""
    _, res = ranks
    assert [r["rank"] for r in res] == [0, 1, 2, 3]
    assert all(r["size"] == 4 for r in res)
    assert all(r["again"] and r["distributed"] and r["device"] == "cpu" for r in res)


def test_host_local_batch_matches_shard_batch(ranks):
    """Port of the JAX test: a rank's own rows equal its shard of the whole; gathered, they are the whole."""
    x, res = ranks
    assert all(r["host_equals_shard"] for r in res)
    for r in res:
        np.testing.assert_array_equal(r["gathered"], x)


def test_make_mesh_subgroup_of_the_first_ranks(ranks):
    """make_mesh(2): a group of ranks 0 and 1 (sum 1 + 2 over it); the others get None."""
    _, res = ranks
    assert [r["pair_size"] for r in res] == [2, 2, None, None]
    assert [r["pair_sum"] for r in res] == [3.0, 3.0, None, None]


def test_launch_reports_a_rank_that_raises():
    with pytest.raises(RuntimeError, match="rank 1 of 2 raised"):
        launch(raise_on_rank_one, 2, device="cpu", timeout=60, threads=1)


def test_launch_deadline_ends_a_hung_collective():
    with pytest.raises(TimeoutError, match="still running"):
        launch(hang_on_rank_one, 2, device="cpu", timeout=8, threads=1)


def test_scaling_records_over_two_gloo_ranks():
    """simplex_gp_torch.scaling's ladder on two gloo CPU ranks: a record per size with the keys of
    experiments/scaling.py, the column-split traffic of c = 3 padded to 4 over the plan's live rows, and
    finite times."""
    from simplex_gp_torch import scaling
    from simplex_gp_torch.ops.kernels import rbf_kernel
    from simplex_gp_torch.ops.lattice import count_lattice_points

    argv = ["--device", "cpu", "--rows", "256", "-d", "2", "--cols", "3", "--reps", "1"]
    ranks = launch(scaling.records, 2, (argv,), device="cpu", timeout=120, threads=1)
    keys = {"devices", "platform", "n", "d", "cols", "mode", "comm_table_bytes", "comm_per_device_bytes_per_mvm",
            "comm_plan_build_bytes", "filter_full_ms", "filter_mvm_per_s", "nlml_step_ms", "nlml_step_per_s",
            "mvm_speedup_vs_1dev", "mvm_parallel_efficiency", "step_speedup_vs_1dev"}
    assert [r["devices"] for r in ranks[0]] == [1, 2] and [r["devices"] for r in ranks[1]] == [2]
    for rec in ranks[0]:
        assert keys <= set(rec) and rec["n"] == 256 and rec["platform"] == "cpu"
        assert np.isfinite(rec["filter_full_ms"]) and rec["nlml_step_ms"] > 0
    two = ranks[0][1]
    x = np.random.default_rng(0).normal(size=(256, 2)).astype(np.float32)  # scaling.py's positions
    live = int(count_lattice_points(torch.from_numpy(x), rbf_kernel(1).variance))
    assert live < 256 * 3  # the dead rows of the plan's 768 travel no more
    assert two["comm_table_bytes"] == live * 4 * 4 and two["comm_per_device_bytes_per_mvm"] == live * 4 * 4
    assert two["comm_plan_build_bytes"] == 256 * 3 * 8


def test_port_imports_no_jax():
    """simplex_gp_torch.parallel, the rank bodies and chip_smoke.py import with jax blocked."""
    code = ("import sys; sys.modules['jax'] = None; sys.modules['simplex_gp_tpu'] = None; "
            "sys.path[:0] = ['tests', '.']; import simplex_gp_torch.parallel, simplex_gp_torch.scaling, "
            "torch_dist_bodies, chip_smoke")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
