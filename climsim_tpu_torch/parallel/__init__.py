"""Multi-device helpers on ``torch.distributed`` (counterpart of
``climsim_tpu/parallel``): process groups and named device meshes, data
parallelism, and the halo exchange of the latitude-sharded coupled step."""
from .halo import HaloHandle, exchange_halo, global_sum, sharded_stencil
from .mesh import (axis_rank, data_parallel_step, init_distributed,
                   local_device, make_global_mesh, make_mesh, make_mesh_2d,
                   replicate, shard_batch)

__all__ = ["make_mesh", "make_mesh_2d", "make_global_mesh", "shard_batch",
           "replicate", "data_parallel_step", "init_distributed",
           "local_device", "axis_rank", "exchange_halo", "sharded_stencil",
           "global_sum", "HaloHandle"]
