"""Scale-out over processes: the rank runtime, the 2-D mesh and the
landmark-sharded BA (port of `alicevision_tpu/parallel/`), on
`torch.distributed` (nccl on cards, gloo on the CPU)."""

from .mesh import make_mesh, replicated, shard_leading
from .ba_sharded import make_sharded_ba, shard_problem, solve_sharded
from .distributed import host_local_view_range, init_distributed, is_primary

__all__ = [
    "host_local_view_range",
    "init_distributed",
    "is_primary",
    "make_mesh",
    "make_sharded_ba",
    "replicated",
    "shard_leading",
    "shard_problem",
    "solve_sharded",
]
