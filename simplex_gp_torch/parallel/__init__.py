"""Data-parallel training over ``torch.distributed``: the port of simplex_gp_tpu/parallel."""

from .comm import DataAxis  # noqa: F401
from .distributed import host_local_batch, initialize_distributed, is_distributed, local_device  # noqa: F401
from .launch import launch  # noqa: F401
from .mesh import data_parallel_loss_fn, make_mesh, replicate, shard_batch  # noqa: F401
from .shard_filter import build_plan_sharded, build_plan_sharded_join, filter_sharded  # noqa: F401
