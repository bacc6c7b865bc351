"""Spatial sharding: each process of the grid's ``'spatial'`` axis holds a
band of rows of every image and activation (the port of ``shard_batch``'s
``spatial_axis``).

The JAX package shards the height dim over a ``'spatial'`` mesh axis and
lets XLA's partitioner insert whatever exchanges the model needs.  The port
does them by hand, for every model family it has:

* **Convolutions and poolings.**  While a forward runs on row bands
  (:func:`row_shards`), every convolution and pooling with a spatial extent
  above one row asks :func:`halo` for the rows its outputs read, which come
  from the neighbours above and below (a broadcast on the pair's group each
  way, with the reverse exchange as its backward), or are the layer's
  padding at the image's top and bottom.  One rule covers kernel, stride,
  dilation and padding: the outputs split evenly over the axis, and each
  process computes its band of them from the input rows they read.
  Pointwise layers, nearest upsampling and concatenations run on the band
  as they are; BatchNorm takes its statistics over data x spatial
  (``parallel.sync_batch_stats``).
* **Swin tokens.**  A ``(B, L, C)`` band holds ``L = rows * cols`` tokens,
  row-major, with ``rows = cols / S`` (:func:`token_grid`: the image is
  square).  A level's windows lie inside the bands, the shift mask is cut to
  the band's windows (:func:`band_part`), and the cyclic shift along the
  height crosses them (:func:`roll_rows`, a ring over the axis; along the
  width it stays local).
* **Whole levels.**  A level whose blocks do not fit the bands (its rows do
  not split into S bands that are each a multiple of its window: the Swin
  bottleneck, any level with rows <= window) runs on the whole image on
  every member: the U-Net gathers the rows before it (:func:`to_whole`) and
  takes the band's rows back after the first level that fits again
  (:func:`to_bands`).  Meanwhile :func:`bands` is None and every layer runs
  as in one process.
* **Global pooling.**  A pretraining head's mean over the image is the
  band's sum, summed over the axis (:func:`mean_rows`); what follows runs
  whole on every member.
* **Draws.**  A dropout mask that varies along the rows is drawn at the
  whole image's shape from the step's generator, which the members of a
  spatial group share, and cut to the band (:func:`draw_uniform`): the same
  seed gives one process's draws.

The gradients: inside the model every exchange has its exact adjoint, so
that each member's parameter gradients are its *share*, and the shares of
the data x spatial members add up to the gradient (``reduce_gradients``
sums them).  A tensor that every member holds whole (a whole level's, the
pooled features, the head's logits) carries on each member a share of its
gradient: a whole level's output is cut to the band (the backward pads the
other rows with zeros), the gather before it sums the members' shares, the
pooling's all-reduce sums them too.  The train step computes the loss of
the gathered batch on every member, so where the model's output is whole
(a classifier's logits), ``parallel.gather_shards`` counts its gradient
once per spatial group: 1 / S on each member.  The train step gathers the
rows of a banded output before the loss and the metrics.
"""
from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import Axis, _gather_pieces, all_reduce_sum

__all__ = ["row_shards", "forward_state", "forward_state_set", "bands",
           "whole", "global_size", "halo",
           "token_grid", "band_part", "roll_rows", "to_whole", "to_bands",
           "mean_rows", "draw_uniform", "fits", "check_supported"]

#: the axis of the forward's bands (None: no spatial sharding), and whether
#: the forward runs on the whole image for now (a whole level, a pooled head)
_ROWS: List[Optional[Axis]] = [None]
_WHOLE: List[bool] = [False]


@contextlib.contextmanager
def row_shards(axis: Optional[Axis]):
    """While active (an axis with a group), the forward runs on this
    process's band of rows of *axis*: convolutions and poolings exchange
    halo rows."""
    previous = _ROWS[0], _WHOLE[0]
    _ROWS[0] = axis if axis is not None and axis.group is not None else None
    _WHOLE[0] = False
    try:
        yield
    finally:
        _ROWS[0], _WHOLE[0] = previous


def forward_state() -> Tuple[Optional[Axis], bool]:
    """The state of the bands that the forward's layers read now, which a
    rematerialised block's recompute runs under again
    (:func:`forward_state_set`)."""
    return _ROWS[0], _WHOLE[0]


@contextlib.contextmanager
def forward_state_set(state: Tuple[Optional[Axis], bool]):
    """While active, the bands' state is *state* (:func:`forward_state`):
    a recompute in the backward runs on the rows its forward ran on."""
    previous = _ROWS[0], _WHOLE[0]
    _ROWS[0], _WHOLE[0] = state
    try:
        yield
    finally:
        _ROWS[0], _WHOLE[0] = previous


def bands() -> Optional[Axis]:
    """The axis whose band of rows the tensors of the forward hold now, or
    None (no spatial sharding, or a stretch that runs on the whole
    image)."""
    return None if _WHOLE[0] else _ROWS[0]


def whole() -> bool:
    """Does a spatially sharded forward run on the whole image for now?"""
    return _WHOLE[0] and _ROWS[0] is not None


def global_size(size: Sequence[int]) -> Tuple[int, ...]:
    """(H, W) of the whole image from a band's (H, W)."""
    axis = bands()
    if axis is None:
        return tuple(size)
    return (size[0] * axis.size,) + tuple(size[1:])


def _needs(rows: int, size: int, pads: Tuple[int, int], kernel: int,
           stride: int, dilation: int) -> List[Tuple[int, int]]:
    """Per member j of a *size*-way axis of *rows*-row bands: the rows its
    outputs read above and below its own band (negative: own rows they do
    not read)."""
    top, bottom = pads
    span = dilation * (kernel - 1)
    out = (rows * size + top + bottom - span - 1) // stride + 1
    if out % size:
        raise ValueError(
            f"spatial sharding: a layer (kernel {kernel}, stride {stride}, "
            f"padding {pads}) gives {out} rows from {rows * size}, which do "
            f"not split over {size} bands (the image height must divide by "
            f"spatial_sharding times the model's downsampling)")
    per = out // size
    needs = []
    for j in range(size):
        lo = j * per * stride - top
        hi = ((j + 1) * per - 1) * stride - top + span
        needs.append((j * rows - lo, hi - ((j + 1) * rows - 1)))
    if any(n > rows for need in needs for n in need):
        raise ValueError(
            f"spatial sharding: a layer (kernel {kernel}, dilation "
            f"{dilation}) reads more rows than a band of {rows} holds; use "
            f"fewer bands")
    return needs


def _outgoing(block: torch.Tensor) -> torch.Tensor:
    """A copy to send: gloo writes a broadcast's result back into the
    source tensor too, on the card, which autograd would take for an
    in-place change of the band."""
    return block.clone(memory_format=torch.contiguous_format)


def _exchange(axis: Axis, to_above: Optional[torch.Tensor], n_below: int,
              to_below: Optional[torch.Tensor], n_above: int,
              like: torch.Tensor):
    """Swap row blocks with both neighbours on their pair groups:
    *to_above* and *to_below* go out (None or empty: nothing), and back
    come *n_above* rows from the member above and *n_below* from the one
    below, as (from_above, from_below).  Each pair sends down, then up, and
    a member takes its upper pair first, so every chain of waits ends at the
    first member."""
    i, last = axis.index, axis.size - 1
    shape = list(like.shape)

    def block(rows):
        shape[2] = rows
        return like.new_empty(shape)

    from_above = from_below = None
    if i > 0:
        group = axis.pairs[i - 1]
        if n_above:
            from_above = block(n_above)
            dist.broadcast(from_above, src=axis.ranks[i - 1], group=group)
        if to_above is not None and to_above.shape[2]:
            dist.broadcast(_outgoing(to_above), src=axis.ranks[i],
                           group=group)
    if i < last:
        group = axis.pairs[i]
        if to_below is not None and to_below.shape[2]:
            dist.broadcast(_outgoing(to_below), src=axis.ranks[i],
                           group=group)
        if n_below:
            from_below = block(n_below)
            dist.broadcast(from_below, src=axis.ranks[i + 1], group=group)
    return from_above, from_below


class _Halo(torch.autograd.Function):
    """A band of NCHW rows -> the rows its outputs read (halos from the
    neighbours, the layer's padding value beyond the image); the backward
    returns each halo's gradient to its owner."""

    @staticmethod
    def forward(ctx, x, axis, needs, value):
        i, last, rows = axis.index, axis.size - 1, x.shape[2]
        above, below = needs[i]
        # what the neighbours read of this band: the member above reads
        # our first rows as its "below", the member below our last rows
        n_first = max(needs[i - 1][1], 0) if i > 0 else 0
        n_last = max(needs[i + 1][0], 0) if i < last else 0
        got_above, got_below = _exchange(
            axis, x[:, :, :n_first], max(below, 0) if i < last else 0,
            x[:, :, rows - n_last:], max(above, 0) if i > 0 else 0, x)
        if i == 0 and above > 0:
            got_above = x.new_full(x.shape[:2] + (above,) + x.shape[3:],
                                   value)
        if i == last and below > 0:
            got_below = x.new_full(x.shape[:2] + (below,) + x.shape[3:],
                                   value)
        own = x[:, :, max(-above, 0):rows - max(-below, 0)]
        ctx.axis, ctx.rows = axis, rows
        ctx.layout = (max(above, 0), max(below, 0), max(-above, 0),
                      max(-below, 0), n_first, n_last)
        parts = [p for p in (got_above, own, got_below) if p is not None]
        return torch.cat(parts, 2) if len(parts) > 1 else own.clone()

    @staticmethod
    def backward(ctx, g):
        axis, rows = ctx.axis, ctx.rows
        above, below, skip_top, skip_bottom, n_first, n_last = ctx.layout
        i, last = axis.index, axis.size - 1
        height = g.shape[2]
        g_above = g[:, :, :above]
        g_below = g[:, :, height - below:]
        g_own = g[:, :, above:height - below]
        # the reverse exchange: the halo gradients go back to their owners
        back_first, back_last = _exchange(
            axis, g_above if i > 0 else None, n_last,
            g_below if i < last else None, n_first, g)
        grad = g.new_zeros(g.shape[:2] + (rows,) + g.shape[3:])
        grad[:, :, skip_top:rows - skip_bottom] += g_own
        if back_first is not None:
            grad[:, :, :n_first] += back_first
        if back_last is not None:
            grad[:, :, rows - n_last:] += back_last
        return grad, None, None, None


def halo(x: torch.Tensor, pads, kernel: int, stride: int, dilation: int,
         value: float = 0.0):
    """(x, pads) for a layer over NCHW *x* with ((top, bottom), (left,
    right)) *pads* taken on the whole image: outside :func:`row_shards`
    unchanged; inside, *x* extended by the halo rows its band of outputs
    reads and the height padding spent on them (``value`` fills rows beyond
    the image: 0, or -inf for max pooling)."""
    axis = bands()
    if axis is None or (kernel == 1 and stride == 1 and pads[0] == (0, 0)):
        return x, pads
    needs = _needs(x.shape[2], axis.size, tuple(pads[0]), kernel, stride,
                   dilation)
    return _Halo.apply(x, axis, needs, value), ((0, 0), tuple(pads[1]))


def token_grid(length: int) -> Tuple[int, int]:
    """(rows, cols) of *length* row-major tokens: a square outside the
    bands, a band of ``rows = cols / S`` rows of a square on them."""
    axis = bands()
    size = 1 if axis is None else axis.size
    cols = math.isqrt(length * size)
    if cols * cols != length * size or cols % size:
        raise ValueError(
            f"{length} tokens are not "
            + ("a square" if size == 1 else
               f"a band of a square image over {size} bands (rows = cols / "
               f"{size})"))
    return cols // size, cols


def band_part(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This member's part of a tensor of the whole image along *dim*,
    which splits evenly over the bands (the rows of a mask table whose
    windows lie in row-major order); *x* itself outside the bands."""
    axis = bands()
    if axis is None:
        return x
    per = x.shape[dim] // axis.size
    return x.narrow(dim, axis.index * per, per)


def draw_uniform(shape: Sequence[int], generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """``torch.rand(shape)`` as one process draws it: on the bands, a
    *shape* of three or more dims that varies along dim 1 (rows, tokens, or
    windows in row-major order) is drawn at the whole image's shape and cut
    to this member's part, so the same generator gives the same mask."""
    shape = tuple(shape)
    axis = bands()
    if axis is None or len(shape) < 3 or shape[1] == 1:
        return torch.rand(shape, device=device, generator=generator)
    whole_shape = (shape[0], shape[1] * axis.size) + shape[2:]
    return band_part(torch.rand(whole_shape, device=device,
                                generator=generator), 1)


def _ring(axis: Axis, send: torch.Tensor, up: bool,
          like: torch.Tensor) -> torch.Tensor:
    """Send *send* to the previous member of the ring (*up*) or the next,
    and take the block of *like*'s shape that the other neighbour sends.
    ``pairs[p]`` joins the members p and p + 1 mod S.  Each member takes
    its upper pair first but the first member, which takes its lower pair
    first: every chain of waits then ends at the first member."""
    i, size = axis.index, axis.size
    upper, lower = (i - 1) % size, i
    got = like.new_empty(like.shape)
    out = _outgoing(send)
    # the member that sends in each pair: the lower one when sending up
    steps = [(upper, axis.ranks[i] if up else axis.ranks[upper], up),
             (lower, axis.ranks[(i + 1) % size] if up else axis.ranks[i],
              not up)]
    if i == 0:
        steps.reverse()
    for pair, src, sending in steps:
        dist.broadcast(out if sending else got, src=src,
                       group=axis.pairs[pair])
    return got


class _RollRows(torch.autograd.Function):
    """``torch.roll(x, shift, dim)`` of the whole image on its bands; the
    backward is the reverse roll."""

    @staticmethod
    def forward(ctx, x, shift, dim, axis):
        ctx.shift, ctx.dim, ctx.axis = shift, dim, axis
        return _roll_bands(x, shift, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _roll_bands(g, -ctx.shift, ctx.dim, ctx.axis), None, None, None


def _roll_bands(x, shift: int, dim: int, axis: Axis) -> torch.Tensor:
    rows = x.shape[dim]
    s = abs(shift)
    if s > rows:
        raise ValueError(f"spatial sharding: a roll by {shift} crosses more "
                         f"than a band of {rows} rows")
    if shift < 0:
        # band j keeps rows [s, rows) and takes the first s of band j + 1
        got = _ring(axis, x.narrow(dim, 0, s), True, x.narrow(dim, 0, s))
        return torch.cat([x.narrow(dim, s, rows - s), got], dim)
    # band j takes the last s rows of band j - 1, then its rows [0, rows - s)
    tail = x.narrow(dim, rows - s, s)
    got = _ring(axis, tail, False, tail)
    return torch.cat([got, x.narrow(dim, 0, rows - s)], dim)


def roll_rows(x: torch.Tensor, shift: int, dim: int = 1) -> torch.Tensor:
    """The cyclic roll of the whole image by *shift* along its rows (dim
    *dim*, torch's sign): ``torch.roll`` outside the bands, a ring exchange
    of ``|shift|`` rows with the neighbours on them."""
    axis = bands()
    if shift == 0:
        return x
    if axis is None:
        return torch.roll(x, shift, dims=dim)
    return _RollRows.apply(x, shift, dim, axis)


class _GatherRows(torch.autograd.Function):
    """The bands gathered into the whole image on every member.  Each
    member's gradient of the whole image is its share, so the backward sums
    them over the axis, then keeps this member's rows."""

    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis, ctx.rows = dim, axis, x.shape[dim]
        return _gather_pieces(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.axis.group)
        return g.narrow(ctx.dim, ctx.axis.index * ctx.rows, ctx.rows), \
            None, None


def to_whole(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """On the bands: the whole image of the band *x* (rows, or row-major
    tokens, along *dim*) on every member, and the forward runs whole from
    here (:func:`bands` is None) until :func:`to_bands`.  *x* otherwise."""
    axis = bands()
    if axis is None:
        return x
    _WHOLE[0] = True
    return _GatherRows.apply(x, dim, axis)


class _SplitRows(torch.autograd.Function):
    """This member's band of a whole image that every member holds.  The
    backward gathers the bands' gradients into the whole image's and gives
    each member an equal share of it, 1 / S: the whole stretch before it
    then computes one process's backward on every member, scaled by 1 / S,
    which for S a power of two rounds as one process does (the float32
    attention of a float64 model included)."""

    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        per = x.shape[dim] // axis.size
        return x.narrow(dim, axis.index * per, per)

    @staticmethod
    def backward(ctx, g):
        return _gather_pieces(g, ctx.dim, ctx.axis) / ctx.axis.size, \
            None, None


def to_bands(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """After a whole stretch (:func:`whole`): this member's band of the
    whole image *x*, and the forward runs on the bands again.  *x*
    otherwise."""
    if not whole():
        return x
    _WHOLE[0] = False
    return _SplitRows.apply(x, dim, _ROWS[0])


def mean_rows(x: torch.Tensor, dims: Sequence[int],
              keepdim: bool = True) -> torch.Tensor:
    """The mean of the whole image over *dims* (which hold dim 1, the
    rows): on the bands the band's sum, summed over the axis, over the
    whole count, and the forward runs whole from here (the result is the
    same on every member).  ``x.mean`` otherwise."""
    axis = bands()
    if axis is None:
        return x.mean(dim=tuple(dims), keepdim=keepdim)
    wide = torch.promote_types(x.dtype, torch.float32)
    total = all_reduce_sum(x.sum(dim=tuple(dims), keepdim=keepdim,
                                 dtype=wide), axis)
    count = math.prod(x.shape[d] for d in dims) * axis.size
    _WHOLE[0] = True
    return (total / count).to(x.dtype)


def fits(module: torch.nn.Module) -> bool:
    """Do *module*'s blocks run on the bands of the active axis?  A block
    that has a geometry of its own says so (``fits_bands(size)``: a Swin
    block whose windows lie inside the bands); the others (convolutions,
    poolings) exchange halos and do."""
    axis = _ROWS[0]
    if axis is None:
        return True
    return all(sub.fits_bands(axis.size) for sub in module.modules()
               if hasattr(sub, "fits_bands"))


def check_supported(module: torch.nn.Module, height: int,
                    size: int) -> None:
    """Refuse an image *height* that *size* bands cannot split: it must
    divide by *size* and, for a model that cuts the image into patches
    (the Swin families' ``PatchEmbed``), by *size* x the patch size, so
    that every band starts a row of patches."""
    from ..models import swin

    patch = max((sub.patch_size for sub in module.modules()
                 if isinstance(sub, swin.PatchEmbed)), default=1)
    if height % (size * patch):
        what = f"{size} x the patch size {patch}" if patch > 1 else str(size)
        raise ValueError(
            f"meta/technical/spatial_sharding: {size} bands do not split the "
            f"image height {height} (H must divide by {what})")
