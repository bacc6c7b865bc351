"""Spatial sharding: each process of the grid's ``'spatial'`` axis holds a
band of rows of every image and activation (the port of ``shard_batch``'s
``spatial_axis``).

The JAX package shards the height dim over a ``'spatial'`` mesh axis and
lets XLA's partitioner insert the convolutions' halo exchanges.  The port
does them by hand: while a forward runs on row bands (:func:`row_shards`),
every convolution and pooling with a spatial extent above one row asks
:func:`halo` for the rows its outputs read, which come from the neighbours
above and below (a broadcast on the pair's group each way, with the reverse
exchange as its backward), or are the layer's padding at the image's top
and bottom.  One rule covers kernel, stride, dilation and padding: the
outputs split evenly over the axis, and each process computes its band of
them from the input rows they read.  Pointwise layers, nearest upsampling
and concatenations run on the band as they are; BatchNorm takes its
statistics over data x spatial (``parallel.sync_batch_stats``); the train
step gathers the rows before the loss and the metrics.

Scope: the conv U-Net with every block kind and the ResNet attention U-Net
(:func:`check_supported`).  The Swin U-Net (windows and the cyclic shift
cross the bands) and the pretraining models (global pooling) are ROADMAP
queue M item M14.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import Axis

__all__ = ["row_shards", "global_size", "halo",
           "check_supported", "NOT_PORTED"]

#: the refusal of what spatial sharding does not cover yet
NOT_PORTED = ("spatial sharding of {what} is not ported (ROADMAP.md queue M, "
              "item M14: {why}); it covers the conv U-Net with every block "
              "kind and the ResNet attention U-Net")

_ROWS: List[Optional[Axis]] = [None]


@contextlib.contextmanager
def row_shards(axis: Optional[Axis]):
    """While active (an axis with a group), the forward runs on this
    process's band of rows of *axis*: convolutions and poolings exchange
    halo rows."""
    previous = _ROWS[0]
    _ROWS[0] = axis if axis is not None and axis.group is not None else None
    try:
        yield
    finally:
        _ROWS[0] = previous


def global_size(size: Sequence[int]) -> Tuple[int, ...]:
    """(H, W) of the whole image from a band's (H, W)."""
    axis = _ROWS[0]
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
    axis = _ROWS[0]
    if axis is None or (kernel == 1 and stride == 1 and pads[0] == (0, 0)):
        return x, pads
    needs = _needs(x.shape[2], axis.size, tuple(pads[0]), kernel, stride,
                   dilation)
    return _Halo.apply(x, axis, needs, value), ((0, 0), tuple(pads[1]))


def check_supported(module: torch.nn.Module) -> None:
    """Refuse, naming ROADMAP's item, a model that spatial sharding does
    not cover: it covers the U-Net family of conv blocks (every block kind
    of the residual zoo, the ResNet encoder of the attention U-Net)."""
    from ..models import swin
    from ..models.unet import UNet

    if any(isinstance(sub, (swin.SwinTransformerBlock, swin.PatchEmbed,
                            swin.PatchMerging, swin.PatchExpand))
           for sub in module.modules()):
        raise NotImplementedError(NOT_PORTED.format(
            what="the Swin U-Net",
            why="windows must align with the bands, the cyclic shift "
                "crosses them and the shift mask must be cut to each "
                "band's windows"))
    if not isinstance(module, UNet):
        raise NotImplementedError(NOT_PORTED.format(
            what=f"{type(module).__name__} (a pretraining model)",
            why="its global pooling and head need the whole image"))
