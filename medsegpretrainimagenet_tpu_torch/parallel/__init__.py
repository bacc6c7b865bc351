"""Multi-device training over processes: the process grid and data
parallelism (``mesh.py``), tensor parallelism (``tp.py``), spatial sharding
(``spatial.py``) and pipeline parallelism (``pp.py``)."""
from .mesh import (ROWS_KEY, SHARDED_KEY, Axis, Grid,  # noqa: F401
                   all_reduce_sum, batch_stats_axis, batch_stats_synced,
                   broadcast_from_main, copy_to_axis, create_grid,
                   data_parallel, device_count, gather_axis, gather_batch,
                   gather_shards, gather_tree_to_host, grid,
                   initialize_distributed, is_main_process, launched,
                   put_replicated, rank, reduce_gradients, shard_batch,
                   split_rows, sync_batch_stats)
from .pp import pipeline_apply, stack_stage_params  # noqa: F401
from .tp import (full_optimizer_state_dict, full_state_dict,  # noqa: F401
                 shard_train_state, tensor_parallel_shardings)

__all__ = ["initialize_distributed", "launched", "data_parallel",
           "device_count", "rank", "is_main_process", "broadcast_from_main",
           "gather_tree_to_host", "put_replicated", "shard_batch",
           "split_rows", "all_reduce_sum", "gather_shards", "gather_batch",
           "reduce_gradients", "sync_batch_stats", "batch_stats_axis",
           "batch_stats_synced", "create_grid", "grid", "Axis", "Grid",
           "gather_axis", "copy_to_axis", "SHARDED_KEY", "ROWS_KEY",
           "tensor_parallel_shardings", "shard_train_state",
           "full_state_dict", "full_optimizer_state_dict",
           "stack_stage_params", "pipeline_apply"]
