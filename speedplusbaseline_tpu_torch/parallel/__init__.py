"""Data parallelism over processes (``mesh.py``)."""
from .mesh import (all_reduce_grads, all_reduce_sum, barrier, broadcast_params, global_batch,
                   global_rows, is_main, launch, make_mesh, maybe_initialize_distributed,
                   rank_rows, rank_world, spawn)

__all__ = ["all_reduce_grads", "all_reduce_sum", "barrier", "broadcast_params",
           "global_batch", "global_rows", "is_main", "launch", "make_mesh",
           "maybe_initialize_distributed", "rank_rows", "rank_world", "spawn"]
