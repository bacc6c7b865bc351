"""The process grid and data parallelism over processes: the port of
``parallel/mesh.py``.

The JAX package shards the global batch over a ``'data'`` mesh axis and
lets XLA compute the loss, the BatchNorm statistics and the metrics on the
global batch.  The port runs one process per device under a launcher
(``torchrun``) and does the same by hand:

* :func:`create_grid` lays the processes out as ``data x inner``, the inner
  axis being ``'model'`` (tensor parallelism, ``parallel.tp``),
  ``'spatial'`` (spatial sharding, ``parallel.spatial``) or ``'pipe'``
  (``parallel.pp``); rank ``d * inner + i`` sits at (d, i), as the JAX
  mesh reshapes its device list.  Each axis has its process group and, for
  the neighbour exchanges of the spatial and pipe axes, a group per pair of
  neighbours.  Without a grid every process is on the ``'data'`` axis;
* :func:`shard_batch` gives each process its slice of the batch axis over
  the data axis (a ragged tail is replicated whole, as in the JAX package)
  and, with ``spatial_axis``, its rows of every image-like leaf;
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

The collectives of the inner axes are broadcasts and all-reduces only, so
the same code runs on NCCL, one process per card, and on gloo with several
processes sharing one card (gloo carries those two on CUDA tensors).

Everything here is the identity in a process that has not joined a process
group.  Under a launcher the data-parallel path runs also with one process,
so it can be held against the plain run on one card.
"""
from __future__ import annotations

import contextlib
import math
import os
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

__all__ = ["initialize_distributed", "launched", "data_parallel",
           "device_count", "rank", "is_main_process", "broadcast_from_main",
           "gather_tree_to_host", "put_replicated", "shard_batch",
           "split_rows", "all_reduce_sum", "gather_shards", "gather_batch",
           "reduce_gradients", "sync_batch_stats", "batch_stats_over",
           "batch_stats_axis", "batch_stats_synced", "create_grid", "grid",
           "Axis", "Grid", "gather_axis", "copy_to_axis", "SHARDED_KEY",
           "ROWS_KEY"]

#: reserved batch key that marks a batch as this process's slice of the
#: global batch (set by shard_batch, popped by the train and eval steps)
SHARDED_KEY = "_mst_sharded"
#: reserved batch key that marks the image-like leaves of a batch as this
#: process's rows of the spatial axis
ROWS_KEY = "_mst_rows"


def launched() -> bool:
    """Was this process started by a launcher (``torchrun`` sets
    ``WORLD_SIZE``)?"""
    return "WORLD_SIZE" in os.environ


def initialize_distributed(device: Optional[Union[str, torch.device]] = None,
                           init_method: Optional[str] = None,
                           rank: Optional[int] = None,
                           world_size: Optional[int] = None,
                           backend: Optional[str] = None) -> torch.device:
    """Join the launcher's process group and return this process's device.

    Reads ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` (and, through the
    default ``env://`` rendezvous, ``MASTER_ADDR`` and ``MASTER_PORT``);
    *init_method*, *rank* and *world_size* override them (tests rendezvous
    through a ``file://`` path).  The device is ``cuda:{LOCAL_RANK}`` unless
    the caller names another.  The backend is NCCL on the card and gloo on
    the CPU unless the caller names one: gloo on the card is taken only when
    asked for (several processes sharing one card, which NCCL refuses).
    Without a launcher and without *world_size* there is no group to join:
    the device is the card unless named, as everywhere in the port."""
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
        backend = backend or "nccl"
    elif device.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"the {backend} backend does not run on the CPU")
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


# ---------------------------------------------------------------------------
# the process grid
# ---------------------------------------------------------------------------

class Axis:
    """One axis of the grid as this process sees it: its *name*, *size*,
    this process's *index* along it, the global ranks of its members in
    axis order, the process *group* (None where the axis needs no
    collective: a group of one in a grid with another axis), and *pairs*,
    the groups of this process with its neighbours (``pairs[p]`` joins the
    members p and p + 1; on the spatial axis the members form a ring, and
    ``pairs[size - 1]`` joins the last member and the first: the pair group
    itself for two members, a group of its own for more)."""

    def __init__(self, name: str, ranks: Sequence[int], group,
                 pairs: Optional[Dict[int, Any]] = None):
        self.name, self.ranks, self.group = name, list(ranks), group
        self.size = len(self.ranks)
        self.index = self.ranks.index(rank())
        self.pairs = pairs or {}

    def __repr__(self) -> str:
        return f"Axis({self.name!r}, size={self.size}, index={self.index})"


class Grid:
    """The processes laid out as ``data x inner`` (:func:`create_grid`).
    ``data`` and ``inner`` are this process's :class:`Axis` on each;
    ``world`` spans every process (``data x inner``)."""

    def __init__(self, names: Tuple[str, ...], shape: Tuple[int, ...]):
        self.names, self.shape = names, shape
        outer, inner = shape[0], (shape[1] if len(shape) > 1 else 1)
        me = rank()
        world = dist.group.WORLD if data_parallel() else None
        self._world_group = world
        self.world = Axis("world", range(outer * inner), world)
        if len(shape) == 1:
            self.data = Axis(names[0], range(outer), world)
            self.inner = Axis("none", [me], None)
            return
        # every process creates every group, in one order (new_group is a
        # collective over the world)
        data = inner_axis = None
        for i in range(inner):
            ranks = [d * inner + i for d in range(outer)]
            group = dist.new_group(ranks)
            if me in ranks:
                data = Axis(names[0], ranks, group if outer > 1 else None)
        for d in range(outer):
            ranks = [d * inner + i for i in range(inner)]
            group = dist.new_group(ranks)
            pairs = {p: dist.new_group(ranks[p:p + 2])
                     for p in range(inner - 1)}
            if names[1] == "spatial" and inner > 1:
                # the ring's wrap (the cyclic shift of the Swin blocks),
                # made here on every process, never on first use
                pairs[inner - 1] = pairs[0] if inner == 2 else \
                    dist.new_group([ranks[-1], ranks[0]])
            if me in ranks:
                index = ranks.index(me)
                inner_axis = Axis(names[1], ranks,
                                  group if inner > 1 else None,
                                  {p: g for p, g in pairs.items()
                                   if p in ((index - 1) % inner, index)})
        self.data, self.inner = data, inner_axis

    def current(self) -> bool:
        """Was this grid made in the process group that runs now?"""
        world = dist.group.WORLD if data_parallel() else None
        return world is self._world_group \
            and math.prod(self.shape) == device_count()

    def axis(self, name: str) -> Axis:
        for axis in (self.data, self.inner):
            if axis.name == name:
                return axis
        raise KeyError(f"the grid {self.names} has no axis {name!r}")

    def size(self, name: str) -> int:
        return self.axis(name).size if name in self.names else 1

    @property
    def grad_axis(self) -> Axis:
        """The processes whose gradient shares add up to the gradient: the
        data axis under tensor parallelism (each model rank holds the whole
        gradient of the replicated parameters and its slice's of the
        sharded ones), every process otherwise."""
        return self.data if self.inner.name == "model" else self.world

    @property
    def stats_axis(self) -> Axis:
        """The processes whose slices make up a global batch: data x
        spatial under spatial sharding, the data axis otherwise."""
        return self.world if self.inner.name == "spatial" else self.data


_GRIDS: Dict[Tuple, Grid] = {}
_ACTIVE: List[Optional[Grid]] = [None]


def create_grid(axis_names: Sequence[str] = ("data",),
                shape: Optional[Sequence[int]] = None) -> Grid:
    """Lay the processes out on a grid of *axis_names* (``("data",)`` or
    ``("data", "model" | "spatial" | "pipe")``) and make it the active one.
    Default: every process on the first axis (the JAX ``create_mesh``
    default).  The groups of one layout are made once per process; every
    process must call this with the same arguments."""
    names = tuple(axis_names)
    count = device_count()
    shape = tuple(int(s) for s in shape) if shape is not None \
        else (count,) + (1,) * (len(names) - 1)
    if len(names) not in (1, 2) or len(shape) != len(names):
        raise ValueError(f"a grid has one or two axes, got {names} of "
                         f"shape {shape}")
    if names[0] != "data" or (len(names) == 2 and names[1] not in
                              ("model", "spatial", "pipe")):
        raise ValueError(f"grid axes are ('data'[, 'model' | 'spatial' | "
                         f"'pipe']), got {names}")
    if math.prod(shape) != count:
        raise ValueError(f"a grid of shape {shape} needs {math.prod(shape)} "
                         f"processes, the run has {count}")
    key = (names, shape)
    if key not in _GRIDS or not _GRIDS[key].current():
        _GRIDS[key] = Grid(names, shape)
    _ACTIVE[0] = _GRIDS[key]
    return _ACTIVE[0]


def grid() -> Grid:
    """The active grid: the last :func:`create_grid`, or every process on
    the data axis."""
    active = _ACTIVE[0]
    if active is None or not active.current():
        return create_grid()
    return active


def data_size() -> int:
    return grid().data.size


def data_rank() -> int:
    return grid().data.index


# ---------------------------------------------------------------------------
# collectives along an axis (broadcasts and all-reduces)
# ---------------------------------------------------------------------------

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


def _gather_pieces(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """Every member's *x* (equal shapes) concatenated along *dim* in axis
    order: one broadcast per member, the bytes of an all-gather.  The
    member's own piece goes out as a copy: gloo writes a broadcast's
    result back into the source tensor too, on the card, which autograd
    would take for an in-place change of *x*."""
    parts = []
    for j, src in enumerate(axis.ranks):
        part = x.clone(memory_format=torch.contiguous_format) \
            if j == axis.index else torch.empty_like(
                x, memory_format=torch.contiguous_format)
        dist.broadcast(part, src=src, group=axis.group)
        parts.append(part)
    return torch.cat(parts, dim)


class _GatherAxis(torch.autograd.Function):
    """Gather along *dim* over an axis.  Every member computes the same
    function of the gathered tensor, so the incoming gradient is already
    the whole one: the backward keeps this member's piece."""

    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.index, ctx.rows = dim, axis.index, x.shape[dim]
        return _gather_pieces(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.rows, ctx.rows), None, None


def gather_axis(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """*x* gathered along *dim* over *axis*, differentiable in this
    member's piece; the identity on an axis without a group."""
    if axis.group is None:
        return x
    return _GatherAxis.apply(x, dim, axis)


class _CopyToAxis(torch.autograd.Function):
    """The identity; its backward sums the members' gradients (each member
    differentiates through its own part of what follows)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.axis.group)
        return g, None


def copy_to_axis(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The input of a computation split over *axis* (tensor parallelism's
    column-parallel layers): its gradient is summed over the axis."""
    if axis.group is None:
        return x
    return _CopyToAxis.apply(x, axis)


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

def split_rows(batch: Dict[str, Any], axis: Axis,
               batch_dim: int = 0) -> Dict[str, Any]:
    """This member's rows (the dim after *batch_dim*) of every image-like
    leaf of *batch* (tensors or host arrays with ``ndim >= batch_dim + 3``:
    an H and a W dim); labels, scalar or one-hot, pass whole.  The rows
    must split evenly."""
    def local(value):
        if not hasattr(value, "shape") or len(value.shape) < batch_dim + 3:
            return value
        height = value.shape[batch_dim + 1]
        if height % axis.size:
            raise ValueError(
                f"spatial sharding: image height {height} does not divide "
                f"by the {axis.size}-way '{axis.name}' axis (H must divide "
                f"by meta/technical/spatial_sharding)")
        per = height // axis.size
        index = [slice(None)] * len(value.shape)
        index[batch_dim + 1] = slice(axis.index * per, (axis.index + 1) * per)
        return value[tuple(index)]
    return {k: local(v) for k, v in batch.items()}


def shard_batch(batch: Dict[str, Any], batch_dim: int = 1,
                spatial_axis: Optional[str] = None,
                already_local: bool = False) -> Dict[str, Any]:
    """This process's slice of *batch* along *batch_dim* (1 for the
    ``(n_fragments, fragment_bs, ...)`` stacks of the loop) over the data
    axis, marked with :data:`SHARDED_KEY`.  With *spatial_axis* (the
    grid's ``'spatial'``) the image-like leaves (``ndim >= batch_dim + 3``)
    are also cut to this process's rows of the height dim
    (``batch_dim + 1``) and marked with :data:`ROWS_KEY`; labels stay
    batch-only.

    ``already_local=True`` declares the arrays to be this process's slice
    of the batch axis already (per-host input slicing: the loader assembled
    only it).  A batch axis that the data axis does not divide (a ragged
    epoch tail) is replicated whole instead, rows and all, with a warning:
    every process computes the whole tail, which is exact, and it is not
    marked.  In a process without a group the batch passes through
    unmarked."""
    if not data_parallel():
        return batch
    layout = grid()
    data = layout.data
    if not already_local:
        sizes = {v.shape[batch_dim] for v in batch.values()
                 if hasattr(v, "shape") and len(v.shape) > batch_dim}
        if any(size % data.size for size in sizes):
            warnings.warn(f"batch size(s) {sorted(sizes)} not divisible by "
                          f"the {data.size} processes of the data axis: "
                          f"replicating this (tail) batch instead of "
                          f"sharding it", stacklevel=2)
            return batch

        def local(value):
            if not hasattr(value, "shape") or len(value.shape) <= batch_dim:
                return value
            per = value.shape[batch_dim] // data.size
            index = [slice(None)] * len(value.shape)
            index[batch_dim] = slice(data.index * per, (data.index + 1) * per)
            return value[tuple(index)]

        batch = {k: local(v) for k, v in batch.items()}
    batch = {**batch, SHARDED_KEY: True}
    if spatial_axis is not None:
        batch = {**split_rows(batch, layout.axis(spatial_axis), batch_dim),
                 ROWS_KEY: True}
    return batch


class _GatherShards(torch.autograd.Function):
    """All-gather along dim 0 in rank order over the data axis.  Its
    backward keeps this process's rows of the incoming gradient: every
    process computes the same loss of the global batch, so that gradient is
    already the global one, and no collective is needed."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.rows, ctx.index = x.shape[0], dist.get_rank(group)
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        start = ctx.index * ctx.rows
        return g[start:start + ctx.rows], None


class _AllReduceSum(torch.autograd.Function):
    """The sum over the members of a group; its gradient is the sum of the
    members' gradients (each member's output feeds its own loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, axis: Optional[Axis] = None
                   ) -> torch.Tensor:
    """*x* summed over *axis* (every process by default), differentiable
    (BatchNorm's global statistics)."""
    axis = axis or grid().world
    if axis.group is None:
        return x
    return _AllReduceSum.apply(x, axis.group)


class _OncePerGroup(torch.autograd.Function):
    """The identity; its backward divides by the axis's size.  The input is
    the same on every member of the axis and so is the loss computed from
    it: each member's gradient is then its share (``parallel.spatial``)."""

    @staticmethod
    def forward(ctx, x, size):
        ctx.size = size
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.size, None


def gather_shards(x, rows: bool = False):
    """The global batch from every process's slice *x* (a tensor, or a
    tuple or list of them), differentiable in this process's slice: the
    rows over the spatial axis first when *rows* (image-like tensors,
    ``ndim >= 3``), then the samples over the data axis.  With *rows* a
    tensor of fewer dims (a classifier's logits) is whole on every member
    of the spatial axis already, and its gradient is counted once per
    spatial group."""
    if isinstance(x, (tuple, list)):
        return type(x)(gather_shards(t, rows) for t in x)
    layout = grid()
    if rows and x.ndim >= 3:
        x = gather_axis(x, 1, layout.inner)
    elif rows and layout.inner.group is not None:
        x = _OncePerGroup.apply(x, layout.inner.size)
    if layout.data.group is None:
        return x
    return _GatherShards.apply(x, layout.data.group)


def gather_batch(batch: Dict[str, Any], rows: bool = False
                 ) -> Dict[str, Any]:
    """The global batch of every tensor of *batch* but the images ``x``,
    which no loss or metric reads (targets and masks, no autograd)."""
    return {k: gather_shards(v.detach(), rows)
            if isinstance(v, torch.Tensor) else v
            for k, v in batch.items() if k != "x"}


def reduce_gradients(grads: Sequence[torch.Tensor],
                     replicated: bool = False) -> None:
    """Sum the processes' gradients in place, in one collective over the
    grid's gradient axis (every process, or the data axis under tensor
    parallelism).  Each process holds its slice's share of the gradient of
    the global loss (:class:`_GatherShards`), and the shares add up to it: a
    mean would give it divided by the number of processes.
    ``replicated=True`` is for a batch that every process computed whole (a
    ragged tail): each holds the whole gradient, and their mean keeps the
    processes' parameters equal where the card's reductions round
    differently."""
    if not data_parallel() or not grads:
        return
    axis = grid().grad_axis
    if axis.group is None:
        return
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors
    flat = _flatten_dense_tensors(list(grads))
    dist.all_reduce(flat, group=axis.group)
    if replicated:
        flat /= axis.size
    for grad, reduced in zip(grads, _unflatten_dense_tensors(flat, grads)):
        grad.copy_(reduced)


#: the axis over which a BatchNorm in training takes its statistics while a
#: forward runs on a slice of the global batch (None: its own batch)
_STATS_AXIS: List[Optional[Axis]] = [None]


@contextlib.contextmanager
def sync_batch_stats(active: bool = True):
    """While active, BatchNorm in training takes the statistics of the
    global batch over the grid's statistics axis (``models.blocks.
    BatchNorm``): the data axis, or data x spatial under spatial
    sharding."""
    axis = grid().stats_axis if active and data_parallel() else None
    if axis is not None and axis.group is None:
        axis = None
    with batch_stats_over(axis):
        yield


@contextlib.contextmanager
def batch_stats_over(axis: Optional[Axis]):
    """While active, BatchNorm in training takes its statistics over *axis*
    (None: its own batch); a rematerialised block's recompute runs under
    the :func:`batch_stats_axis` of its forward."""
    previous, _STATS_AXIS[0] = _STATS_AXIS[0], axis
    try:
        yield
    finally:
        _STATS_AXIS[0] = previous


def batch_stats_axis() -> Optional[Axis]:
    return _STATS_AXIS[0]


def batch_stats_synced() -> bool:
    return _STATS_AXIS[0] is not None
