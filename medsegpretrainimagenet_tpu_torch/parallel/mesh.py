"""Data parallelism over processes: the port of ``parallel/mesh.py``.

The JAX package shards the global batch over a ``'data'`` mesh axis and
lets XLA compute the loss, the BatchNorm statistics and the metrics on the
global batch.  The port runs one process per device under a launcher
(``torchrun``) and does the same by hand:

* :func:`shard_batch` gives each process its slice of the batch axis (a
  ragged tail is replicated whole, as in the JAX package);
* the train and eval steps gather the predictions (with autograd) and the
  targets of every slice, so the loss and the metric state are those of the
  global batch on every process (:func:`gather_shards`);
* BatchNorm takes the statistics of the global batch while a step runs on a
  slice (:func:`sync_batch_stats`, read by ``models.blocks.BatchNorm``);
* the processes' parameter gradients are summed once per step
  (:func:`reduce_gradients`): each process differentiates the global loss
  through its own slice only, so the slices' gradients add up to the global
  gradient;
* rank 0's parameters are broadcast at the start (:func:`put_replicated`),
  and host decisions read off the filesystem go through
  :func:`broadcast_from_main`.

Everything here is the identity in a process that has not joined a process
group.  Under a launcher the data-parallel path runs also with one process,
so it can be held against the plain run on one card.
"""
from __future__ import annotations

import contextlib
import os
import warnings
from typing import Any, Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

__all__ = ["initialize_distributed", "launched", "data_parallel",
           "device_count", "rank", "is_main_process", "broadcast_from_main",
           "gather_tree_to_host", "put_replicated", "shard_batch",
           "all_reduce_sum", "gather_shards", "gather_batch",
           "reduce_gradients",
           "sync_batch_stats", "batch_stats_synced", "SHARDED_KEY"]

#: reserved batch key that marks a batch as this process's slice of the
#: global batch (set by shard_batch, popped by the train and eval steps)
SHARDED_KEY = "_mst_sharded"


def launched() -> bool:
    """Was this process started by a launcher (``torchrun`` sets
    ``WORLD_SIZE``)?"""
    return "WORLD_SIZE" in os.environ


def initialize_distributed(device: Optional[Union[str, torch.device]] = None,
                           init_method: Optional[str] = None,
                           rank: Optional[int] = None,
                           world_size: Optional[int] = None
                           ) -> torch.device:
    """Join the launcher's process group and return this process's device.

    Reads ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` (and, through the
    default ``env://`` rendezvous, ``MASTER_ADDR`` and ``MASTER_PORT``);
    *init_method*, *rank* and *world_size* override them (tests rendezvous
    through a ``file://`` path).  The device is ``cuda:{LOCAL_RANK}`` unless
    the caller names another; the backend is NCCL on the card and gloo on
    the CPU, never one for the other.  Without a launcher and without
    *world_size* there is no group to join: the device is the card unless
    named, as everywhere in the port."""
    if world_size is None and not launched():
        return resolve_device(device)
    rank = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None \
        else int(world_size)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found; pass device='cpu' to "
                               "run on the CPU")
        if device.index is None:
            device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"data parallelism runs on cuda or cpu, not "
                         f"{device}")
    if not dist.is_initialized():
        kwargs = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world_size, **kwargs)
    return device


def data_parallel() -> bool:
    """Has this process joined a process group?"""
    return dist.is_available() and dist.is_initialized()


def device_count() -> int:
    """The number of processes (one device each) of the run."""
    return dist.get_world_size() if data_parallel() else 1


def rank() -> int:
    return dist.get_rank() if data_parallel() else 0


def is_main_process() -> bool:
    """True in a run of one process and on rank 0.  Host-side sinks (CSV
    rows, checkpoints, plots, config dumps) write only here: every process
    holds the same results."""
    return rank() == 0


def broadcast_from_main(values: Sequence[int]) -> List[int]:
    """Rank 0's small host integers on every process (identity in one
    process): resume counters and directory suffixes are read off the
    filesystem, which only rank 0 writes, and processes that act on
    different values run different collectives and hang."""
    values = [int(v) for v in values]
    if not data_parallel():
        return values
    box = [values]
    dist.broadcast_object_list(box, src=0)
    return [int(v) for v in box[0]]


def gather_tree_to_host(tree: Any) -> Any:
    """The tree's tensors on the host.  Data-parallel state is replicated,
    so every process holds all of it and no collective is needed."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: gather_tree_to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_tree_to_host(v) for v in tree)
    return tree


def put_replicated(module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast rank 0's parameters and persistent buffers to every
    process, in place (identity in one process)."""
    if data_parallel():
        with torch.no_grad():
            for tensor in module.state_dict().values():
                dist.broadcast(tensor, src=0)
    return module


def shard_batch(batch: Dict[str, Any], batch_dim: int = 1,
                already_local: bool = False) -> Dict[str, Any]:
    """This process's slice of *batch* along *batch_dim* (1 for the
    ``(n_fragments, fragment_bs, ...)`` stacks of the loop), marked with
    :data:`SHARDED_KEY`.

    ``already_local=True`` declares the arrays to be this process's slice
    already (per-host input slicing: the loader assembled only it).  A
    batch axis that the number of processes does not divide (a ragged
    epoch tail) is replicated whole instead, with a warning: every process
    computes the whole tail, which is exact, and it is not marked.  In a
    process without a group the batch passes through unmarked."""
    if not data_parallel():
        return batch
    count = dist.get_world_size()
    if already_local:
        return {**batch, SHARDED_KEY: True}
    sizes = {v.shape[batch_dim] for v in batch.values()
             if hasattr(v, "shape") and len(v.shape) > batch_dim}
    if any(size % count for size in sizes):
        warnings.warn(f"batch size(s) {sorted(sizes)} not divisible by the "
                      f"{count} processes: replicating this (tail) batch "
                      f"instead of sharding it", stacklevel=2)
        return batch
    me = dist.get_rank()

    def local(value):
        if not hasattr(value, "shape") or len(value.shape) <= batch_dim:
            return value
        per = value.shape[batch_dim] // count
        index = [slice(None)] * len(value.shape)
        index[batch_dim] = slice(me * per, (me + 1) * per)
        return value[tuple(index)]

    return {**{k: local(v) for k, v in batch.items()}, SHARDED_KEY: True}


class _GatherShards(torch.autograd.Function):
    """All-gather along dim 0 in rank order.  Its backward keeps this
    process's rows of the incoming gradient: every process computes the
    same loss of the global batch, so that gradient is already the global
    one, and no collective is needed."""

    @staticmethod
    def forward(ctx, x):
        ctx.rows = x.shape[0]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        start = dist.get_rank() * ctx.rows
        return g[start:start + ctx.rows]


class _AllReduceSum(torch.autograd.Function):
    """The sum over every process; its gradient is the sum of the
    processes' gradients (each process's output feeds its own loss)."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """*x* summed over every process, differentiable (BatchNorm's global
    statistics)."""
    return _AllReduceSum.apply(x)


def gather_shards(x):
    """The global batch from every process's slice *x* (a tensor, or a
    tuple or list of them), differentiable in this process's slice."""
    if isinstance(x, (tuple, list)):
        return type(x)(gather_shards(t) for t in x)
    return _GatherShards.apply(x)


def gather_batch(batch: Dict[str, Any]) -> Dict[str, Any]:
    """The global batch of every tensor of *batch* but the images ``x``,
    which no loss or metric reads (targets and masks, no autograd)."""
    return {k: gather_shards(v.detach()) if isinstance(v, torch.Tensor)
            else v for k, v in batch.items() if k != "x"}


def reduce_gradients(grads: Sequence[torch.Tensor],
                     replicated: bool = False) -> None:
    """Sum the processes' gradients in place, in one collective.  Each
    process holds its slice's share of the gradient of the global loss
    (:class:`_GatherShards`), and the shares add up to it: a mean would
    give it divided by the number of processes.  ``replicated=True`` is
    for a batch that every process computed whole (a ragged tail): each
    holds the whole gradient, and their mean keeps the processes'
    parameters equal where the card's reductions round differently."""
    if not data_parallel() or not grads:
        return
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors
    flat = _flatten_dense_tensors(list(grads))
    dist.all_reduce(flat)
    if replicated:
        flat /= dist.get_world_size()
    for grad, reduced in zip(grads, _unflatten_dense_tensors(flat, grads)):
        grad.copy_(reduced)


#: whether the forward that runs now is on a slice of the global batch
_SYNC_BATCH_STATS = False


@contextlib.contextmanager
def sync_batch_stats(active: bool = True):
    """While active, BatchNorm in training takes the statistics of the
    global batch over every process (``models.blocks.BatchNorm``)."""
    global _SYNC_BATCH_STATS
    previous, _SYNC_BATCH_STATS = _SYNC_BATCH_STATS, bool(active) \
        and data_parallel()
    try:
        yield
    finally:
        _SYNC_BATCH_STATS = previous


def batch_stats_synced() -> bool:
    return _SYNC_BATCH_STATS
