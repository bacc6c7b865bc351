"""Pipeline parallelism over the grid's ``'pipe'`` axis: the port of
``parallel/pp.py``.

GPipe-style microbatch pipelining: each process of a pipe group holds ONE
stage of a homogeneous stack (every stage maps activations of one shape and
dtype to the same, and all stages share one parameter structure, stacked on
a leading stage axis by :func:`stack_stage_params`).  The schedule runs
``num_microbatches + num_stages - 1`` ticks; at each tick every stage runs
``stage_fn`` once (the bubble ticks on zeros, the GPipe fill and drain) and
hands its activation to the next stage, a broadcast on the two stages' pair
group.  Autograd runs through the schedule: the hand-off's backward is the
reverse hand-off, so ``backward()`` gives the backward pipeline.

Each process computes its own stage's parameter gradients (the rows of the
stacked parameters it reads); the other rows' gradients are zero, so a sum
over the pipe group gives the stacked gradient.  The outputs are the last
stage's, broadcast to every stage; every stage then computes the same loss
on them, and the broadcast's backward keeps the last stage's gradient, so
it is counted once.

Memory model (default): every stage holds the whole microbatched input and
the output.  With ``data_axis`` the inputs are this process's slice of the
sample axis (data x pipe); with ``shard_io=True`` this process holds only
its share of the microbatches, in and out (microbatches ``[index * M / S,
(index + 1) * M / S)``), and each tick routes one microbatch to the first
stage and one from the last stage over the pipe group, as the JAX
package's masked ``psum`` does.

Scope: a library function, not a CLI option, as in the JAX package (its
README: "Scope: library primitive, deliberately NOT a config knob").
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import Axis, grid

__all__ = ["stack_stage_params", "pipeline_apply"]


def stack_stage_params(stage_params: Sequence[Dict[str, torch.Tensor]]
                       ) -> Dict[str, torch.Tensor]:
    """Stack per-stage parameter dicts (one structure, one shape per name)
    on a new leading stage axis: ``(num_stages, *shape)`` per name."""
    names = list(stage_params[0])
    for params in stage_params[1:]:
        if list(params) != names:
            raise ValueError("every stage must have the same parameter names")
    return {name: torch.stack([params[name] for params in stage_params])
            for name in names}


class _HandOff(torch.autograd.Function):
    """This stage's activation to the next stage, on their pair group;
    returns the previous stage's (zeros at the first stage).  The backward
    is the reverse hand-off."""

    @staticmethod
    def forward(ctx, out, axis):
        ctx.axis = axis
        i, last = axis.index, axis.size - 1
        received = torch.zeros_like(out)
        if i > 0:
            dist.broadcast(received, src=axis.ranks[i - 1],
                           group=axis.pairs[i - 1])
        if i < last:
            # a copy: gloo writes the result back into the source tensor
            # too, on the card, which autograd would take for an in-place
            # change of the stage's output
            dist.broadcast(out.clone(memory_format=torch.contiguous_format),
                           src=axis.ranks[i], group=axis.pairs[i])
        return received

    @staticmethod
    def backward(ctx, g):
        axis = ctx.axis
        i, last = axis.index, axis.size - 1
        grad = torch.zeros_like(g)
        # the pairs in the forward's order: the upper one first
        if i > 0:
            dist.broadcast(g.contiguous(), src=axis.ranks[i],
                           group=axis.pairs[i - 1])
        if i < last:
            dist.broadcast(grad, src=axis.ranks[i + 1], group=axis.pairs[i])
        return grad, None


class _Route(torch.autograd.Function):
    """*x* of the member *src* on every member of the axis (a broadcast);
    the backward sums the members' gradients onto *src*."""

    @staticmethod
    def forward(ctx, x, axis, src):
        ctx.axis, ctx.src = axis, src
        out = x.detach().clone() if axis.index == src else torch.empty_like(x)
        if axis.group is not None:
            dist.broadcast(out, src=axis.ranks[src], group=axis.group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        if ctx.axis.group is not None:
            dist.all_reduce(g, group=ctx.axis.group)
        if ctx.axis.index != ctx.src:
            g.zero_()
        return g, None, None


class _FromLast(torch.autograd.Function):
    """The last stage's *x* on every stage.  Every stage computes the same
    loss on it, so the last stage's own gradient is the whole one: the
    backward keeps it there and sends nothing."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.last = axis.index == axis.size - 1
        out = x.detach().clone() if ctx.last else torch.empty_like(x)
        if axis.group is not None:
            dist.broadcast(out, src=axis.ranks[-1], group=axis.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None


def _pipe_axis(group: Optional[Axis], axis: str) -> Axis:
    if group is not None:
        return group
    return grid().axis(axis)


def pipeline_apply(stage_fn: Callable[[Dict[str, torch.Tensor],
                                       torch.Tensor], torch.Tensor],
                   stacked_params: Dict[str, torch.Tensor],
                   inputs: torch.Tensor, *, group: Optional[Axis] = None,
                   axis: str = "pipe",
                   num_microbatches: Optional[int] = None,
                   data_axis: Optional[str] = None,
                   shard_io: bool = False) -> torch.Tensor:
    """Run ``num_stages`` sequential stages as a GPipe microbatch pipeline
    over the pipe group (*group*, an :class:`Axis`; by default the active
    grid's *axis*).

    ``stage_fn(params, x) -> y`` must keep x's shape and dtype, draw
    nothing, and be finite at zero input in its forward and its backward:
    the bubble ticks run it on zeros (``(S - 1) / (M + S - 1)`` of the
    ticks), as in the JAX package.  ``stacked_params``: the stage-stacked
    parameters (:func:`stack_stage_params`), leading dim ``S``, the pipe
    group's size; this process runs row ``index`` of them.  ``inputs``:
    ``(B, ...)`` activations entering stage 0, the same on every stage (with
    *data_axis*, this process's slice of the samples; with *shard_io*, its
    ``B / S`` rows, the microbatches it owns).  ``B`` (the whole batch under
    *shard_io*) must divide by
    ``num_microbatches`` (``M``, default ``S``), and under *shard_io* ``M``
    by ``S``.

    Returns the last stage's ``(B, ...)`` outputs on every stage (under
    *shard_io*, this process's share of them)."""
    pipe = _pipe_axis(group, axis)
    num_stages = pipe.size
    for name, leaf in stacked_params.items():
        lead = leaf.shape[0] if leaf.ndim else None
        if lead != num_stages:
            raise ValueError(
                f"stacked_params leaf {name!r} has leading dim {lead}, "
                f"expected num_stages={num_stages} (the '{pipe.name}' axis "
                f"size)")
    if data_axis is not None:
        grid().axis(data_axis)  # the samples are this process's slice
    m = num_stages if num_microbatches is None else int(num_microbatches)
    if shard_io and m % num_stages:
        raise ValueError(f"shard_io needs num_microbatches {m} divisible "
                         f"by num_stages {num_stages}")
    per_dev_m = m // num_stages if shard_io else m
    batch = inputs.shape[0] * (num_stages if shard_io else 1)
    if batch % m:
        raise ValueError(f"batch {batch} not divisible by "
                         f"num_microbatches {m}")
    x_mb = inputs.reshape((per_dev_m, batch // m) + inputs.shape[1:])
    my_params = {name: leaf[pipe.index]
                 for name, leaf in stacked_params.items()}
    # every stage builds the same graph (the stage's role enters through
    # torch.where on flags), so every stage's backward runs the
    # collectives in one order
    flag = functools.partial(torch.tensor, device=inputs.device)
    is_first = flag(pipe.index == 0)
    zeros = torch.zeros_like(x_mb[0])
    ticks = m + num_stages - 1
    incoming = zeros
    outputs = [zeros] * per_dev_m if shard_io else []
    for t in range(ticks):
        if t >= m:
            feed = zeros
        elif shard_io:
            # microbatch t lives on its owner's slot t % per_dev_m
            feed = _Route.apply(x_mb[t % per_dev_m], pipe, t // per_dev_m)
        else:
            feed = x_mb[t]
        out = stage_fn(my_params, torch.where(is_first, feed, incoming))
        if t < ticks - 1:
            incoming = _HandOff.apply(out, pipe)
        # the last stage drains microbatch t - (S - 1) at tick t
        d = t - (num_stages - 1)
        if d < 0:
            continue
        if shard_io:
            drained = _Route.apply(out, pipe, num_stages - 1)
            slot = d % per_dev_m
            outputs[slot] = torch.where(flag(d // per_dev_m == pipe.index),
                                        drained, outputs[slot])
        else:
            outputs.append(out)
    result = torch.stack(outputs)
    if not shard_io:
        result = _FromLast.apply(result, pipe)
    return result.reshape((-1,) + result.shape[2:])
