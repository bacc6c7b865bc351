"""Multi-device training: data parallelism over processes (``mesh.py``).
Tensor parallelism, spatial sharding and pipeline parallelism are ROADMAP
queue M12 and raise NotImplementedError in the CLI."""
from .mesh import (SHARDED_KEY, all_reduce_sum,  # noqa: F401
                   batch_stats_synced,
                   broadcast_from_main, data_parallel, device_count,
                   gather_batch, gather_shards, gather_tree_to_host,
                   initialize_distributed, is_main_process, launched,
                   put_replicated, rank, reduce_gradients, shard_batch,
                   sync_batch_stats)

__all__ = ["initialize_distributed", "launched", "data_parallel",
           "device_count", "rank", "is_main_process", "broadcast_from_main",
           "gather_tree_to_host", "put_replicated", "shard_batch",
           "all_reduce_sum", "gather_shards", "gather_batch",
           "reduce_gradients",
           "sync_batch_stats", "batch_stats_synced", "SHARDED_KEY"]
