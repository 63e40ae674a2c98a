"""Data parallel across processes: one process per card, NCCL on cards and
gloo on the CPU (the JAX package's parallel/mesh.py)."""

from .mesh import (
    active, all_reduce_grads, broadcast_module, broadcast_object, device_for_rank, finalize,
    gather_rows, global_mean, initialize, is_main, main_print, mean_over_ranks, process_group,
    rank, shard_rows, world_size)

__all__ = ["active", "all_reduce_grads", "broadcast_module", "broadcast_object",
           "device_for_rank", "finalize", "gather_rows", "global_mean", "initialize",
           "is_main", "main_print", "mean_over_ranks", "process_group", "rank", "shard_rows",
           "world_size"]
