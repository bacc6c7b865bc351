"""Building blocks of the U-Nets: the port of ``models/blocks.py``.

Layout is the JAX package's: NHWC images and (B, L, C) token sequences,
"channel" always the last axis.  Submodules carry the names of the flax
parameter paths (``Dense_0``, ``Conv_0``, ``BatchNorm_0``, ...), so a JAX
checkpoint maps onto a state dict key by key
(``transfer.state_dict_from_jax``).  The ``torch.nn.*`` aliases the
configs name (``Conv2d``, ``MaxPool2d``, ``Upsample``, and the pretraining
head's ``AvgPool2d``, ``AdaptiveAvgPool2d``, ``Flatten``, ``Linear``,
``LayerNorm``) are modules of their own with the JAX package's semantics,
not torch's layers.

Mixed precision follows flax's ``dtype=`` convention rather than
``torch.autocast``: parameters stay float32 masters, a :class:`Dense` or
:class:`Conv` casts its input and weights to the compute dtype and returns
that dtype, :class:`LayerNorm` computes its statistics *and output* in
float32 whatever its input, as flax's LayerNorm with float32 parameters
does (under ``set_ln_half_out`` the output is then cast to the compute
dtype), and :class:`BatchNorm` takes and returns the compute dtype with
float32 statistics and parameters.

On the card every 4-D activation is an NHWC tensor whose NCHW view is
channels-last in memory: convolutions, BatchNorm, pooling and upsampling
run on that view, which cuDNN and PyTorch's channels-last kernels take
without a layout copy.
"""
from __future__ import annotations

import contextlib
import inspect
import math
from typing import Any, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import ConfigDict, register
from ..config.registry import fill_spec, get_kwargs, resolve
from ..parallel import spatial
from ..parallel.mesh import (all_reduce_sum, batch_stats_axis,
                             batch_stats_over, copy_to_axis, gather_axis)
from ..parallel.tp import full, sharded
from .activations import fill_activation_spec, make_activation
from .init import lecun_normal_

__all__ = [
    "set_compute_dtype", "compute_dtype", "set_ln_half_out", "set_remat",
    "remat_enabled", "maybe_remat", "Dense", "Conv", "LayerNorm",
    "make_layer_norm", "dropout", "drop_path", "Stochastic", "draws",
    "Identity", "Conv2d", "MaxPool2d", "max_pool",
    "Upsample", "AvgPool2d", "AdaptiveAvgPool2d", "Flatten", "Linear",
    "TorchLayerNorm", "BatchNorm", "ConvBlock", "UpConvBlock",
    "ChannelwiseLayerNorm", "LayerScale", "ResNeXtBlock",
    "InvertedBottleneckBlock", "ConvNeXtBlock", "ResConnection", "ConcatBlock",
    "ConcatLinearBlock", "AttentionBlock", "set_dropout_generator",
    "mixing_out_channels", "block_accepts", "make_block_builder",
]

_COMPUTE_DTYPE = [None]  # None -> float32 compute with float32 parameters


def set_compute_dtype(dtype: Optional[torch.dtype]) -> None:
    """Set the activation/compute dtype of every block (parameters stay
    float32).  ``torch.bfloat16`` is the mixed-precision serving path.
    Read at every forward, so it takes effect on the next call."""
    _COMPUTE_DTYPE[0] = dtype


def compute_dtype() -> Optional[torch.dtype]:
    return _COMPUTE_DTYPE[0]


_LN_HALF_OUT = [False]


def set_ln_half_out(enabled: bool) -> None:
    """LayerNorms emit the compute dtype (statistics and the affine part
    stay float32): with a bf16 compute dtype the residual stream of the
    Swin blocks is then bf16.  Off by default, as in the JAX package; no
    effect when no compute dtype is set.  Takes effect when a model is
    built (:func:`make_layer_norm`), not at the next forward."""
    _LN_HALF_OUT[0] = bool(enabled)


_REMAT = [False]
#: True while a rematerialised block recomputes its forward
_RECOMPUTING = [False]


def set_remat(enabled: bool) -> None:
    """Rematerialise the basic blocks' activations in the backward pass
    (``meta/technical/remat: true``): each block keeps only its input, and
    the backward recomputes its forward.  Trades operations for device
    memory.  Read at every forward, so it takes effect on the next call."""
    _REMAT[0] = bool(enabled)


def remat_enabled() -> bool:
    return _REMAT[0]


def maybe_remat(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Call a basic block, under ``torch.utils.checkpoint`` when remat is
    on and the block trains with gradients enabled (a plain call in eval or
    under ``no_grad``).  The wrap adds no module, so parameter and buffer
    names stay as they are and checkpoints load either way.  As flax's
    ``nn.remat``, the recompute replays the forward's draws and discards
    its BatchNorm updates: the drawing generators (:class:`Stochastic`)
    are set back to their state before the forward and then to their state
    before the recompute, and no running statistic moves in it.  It runs
    on the forward's rows and statistics axis (spatial sharding, data
    parallelism), whose collectives it repeats."""
    if not (_REMAT[0] and module.training and torch.is_grad_enabled()):
        return module(x)
    drawing = [sub.generator for sub in module.modules()
               if isinstance(sub, Stochastic) and sub.draws()]
    generators = list({id(g): g for g in drawing if g is not None}.values())
    forward = ([g.get_state() for g in generators], spatial.forward_state(),
               batch_stats_axis())
    return checkpoint(
        module, x, use_reentrant=False,
        # a draw without a generator takes the global one
        preserve_rng_state=None in drawing,
        context_fn=lambda: (contextlib.nullcontext(),
                            _recompute(generators, *forward)))


@contextlib.contextmanager
def _recompute(generators, states, rows, stats_axis):
    """The context of a block's recompute: its generators at *states*
    (theirs before the forward), the forward's *rows* and *stats_axis*,
    and BatchNorm's statistics held; after it, the generators where the
    backward found them."""
    found = [g.get_state() for g in generators]
    for g, state in zip(generators, states):
        g.set_state(state)
    _RECOMPUTING[0] = True
    try:
        with spatial.forward_state_set(rows), batch_stats_over(stats_axis):
            yield
    finally:
        _RECOMPUTING[0] = False
        for g, state in zip(generators, found):
            g.set_state(state)


def _cast(x: torch.Tensor, *params: Optional[torch.Tensor]):
    """flax ``promote_dtype``: everything to the compute dtype, or to the
    promoted float type when none is set."""
    dtype = compute_dtype() or torch.promote_types(x.dtype, torch.float32)
    return [None if t is None else t.to(dtype) for t in (x, *params)]


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` over the last axis.  The
    weight is stored torch-style as (out, in)."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if use_bias \
            else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shard = sharded(self.weight)
        if shard is None:
            return F.linear(*_cast(x, self.weight, self.bias))
        # tensor parallelism: this rank's output features, gathered
        x = copy_to_axis(x, shard.axis)
        return gather_axis(F.linear(*_cast(x, self.weight, self.bias)), -1,
                           shard.axis)


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return tuple(v)
    return (v, v)


def _padding(pad) -> Union[str, Tuple[Tuple[int, int], Tuple[int, int]]]:
    """Torch-style padding specs as the JAX package reads them: "SAME",
    "VALID", or ((lo, hi), (lo, hi)) per spatial axis."""
    if pad in ("same", "SAME"):
        return "SAME"
    if pad in ("valid", "VALID"):
        return "VALID"
    if isinstance(pad, int):
        return ((pad, pad), (pad, pad))
    if isinstance(pad, (tuple, list)):
        return tuple((p, p) for p in pad)
    raise ValueError(f"Unsupported padding {pad!r}")


def _axis_pads(padding, size: Sequence[int], kernel: Sequence[int],
               stride: Sequence[int], dilation: Sequence[int]):
    """(lo, hi) per spatial axis.  "SAME" is lax's: out = ceil(size /
    stride), the excess split with the odd element at the end, so an even
    kernel at stride 1 pads (k/2 - 1, k/2)."""
    if padding == "VALID":
        return ((0, 0), (0, 0))
    if padding != "SAME":
        return padding
    pads = []
    for n, k, s, d in zip(size, kernel, stride, dilation):
        total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


class Conv(nn.Module):
    """flax ``nn.Conv`` on NHWC input; weight stored torch-style as (out,
    in / groups, kh, kw).  *padding* is "VALID" (the default), "SAME" or
    ((lo, hi), (lo, hi)) per axis; an asymmetric one ("SAME" with an even
    kernel) is an explicit zero padding of the input."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Union[int, Tuple[int, int]] = 1,
                 stride: Union[int, Tuple[int, int]] = 1,
                 use_bias: bool = True, padding: Any = "VALID",
                 dilation: Union[int, Tuple[int, int]] = 1,
                 groups: int = 1):
        super().__init__()
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        self.dilation = _pair(dilation)
        self.padding = padding
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, *self.kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if use_bias \
            else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        fan_in = math.prod(self.weight.shape[1:])
        lecun_normal_(self.weight, fan_in, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = compute_dtype() or torch.promote_types(x.dtype, torch.float32)
        x, groups = x.to(dtype), self.groups
        shard = sharded(self.weight)
        if shard is not None:
            # tensor parallelism: this rank's output channels (of a grouped
            # conv, from its groups' input channels), gathered below
            x = copy_to_axis(x, shard.axis)
            if groups > 1:
                per = x.shape[-1] // shard.axis.size
                x = x[..., shard.axis.index * per:
                      (shard.axis.index + 1) * per]
                groups //= shard.axis.size
        # the NCHW view of an NHWC tensor is channels-last in memory, which
        # cuDNN convolves without a layout copy; the weight is cast into
        # that format in the same copy as into the compute dtype
        x = x.permute(0, 3, 1, 2)
        weight = self.weight.to(dtype, memory_format=torch.channels_last)
        bias = None if self.bias is None else self.bias.to(dtype)
        # the padding of the whole image; on a band of rows (spatial
        # sharding) the halo rows take the place of the height padding
        pads = _axis_pads(self.padding, spatial.global_size(x.shape[2:]),
                          self.kernel_size, self.stride, self.dilation)
        x, pads = spatial.halo(x, pads, self.kernel_size[0], self.stride[0],
                               self.dilation[0])
        if all(lo == hi for lo, hi in pads):
            padding = tuple(lo for lo, _ in pads)
        else:
            (top, bottom), (left, right) = pads
            x, padding = F.pad(x, (left, right, top, bottom)), 0
        out = F.conv2d(x, weight, bias, stride=self.stride, padding=padding,
                       dilation=self.dilation,
                       groups=groups).permute(0, 2, 3, 1)
        return out if shard is None else gather_axis(out, -1, shard.axis)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: epsilon 1e-6 (not torch's 1e-5); statistics
    and output in the parameters' dtype (float32) or the input's when it is
    wider, as flax promotes them."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, self.weight.dtype))
        return F.layer_norm(x, x.shape[-1:], full(self.weight),
                            full(self.bias), self.eps)


class HalfOutLayerNorm(LayerNorm):
    """:class:`LayerNorm` whose output is cast to the compute dtype, when
    one is set (the JAX package's ``_HalfOutLayerNorm``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        dtype = compute_dtype()
        return y if dtype is None else y.to(dtype)


def make_layer_norm(features: int) -> LayerNorm:
    """The framework's LayerNorm: flax's defaults, or the half-output
    variant when :func:`set_ln_half_out` is on.  The two have the same
    parameters, so a checkpoint of either loads into the other."""
    if _LN_HALF_OUT[0]:
        return HalfOutLayerNorm(features)
    return LayerNorm(features)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator],
            shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 - rate and
    scale the kept ones by 1 / (1 - rate); the identity at eval or rate 0.
    The mask has *shape* (default x's), broadcast over x, and is drawn from
    *generator*; on a band of rows (spatial sharding) at the whole image's
    shape, of which the band keeps its part (``spatial.draw_uniform``:
    dim 1 holds the rows, or tokens or windows in row-major order)."""
    if rate == 0.0 or not training:
        return x
    keep = 1.0 - rate
    mask = spatial.draw_uniform(shape or x.shape, generator, x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def drop_path(x: torch.Tensor, rate: float, training: bool,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """Per-sample stochastic depth (segmentation): one draw per sample."""
    return dropout(x, rate, training, generator,
                   (x.shape[0],) + (1,) * (x.ndim - 1))


class Stochastic:
    """A module whose training forward draws (dropout, attention dropout,
    stochastic depth).  Its draws take ``self.generator``, which the train
    step points at its fragment's generator (:func:`set_dropout_generator`);
    ``RATES`` names the attributes that hold its rates."""

    generator: Optional[torch.Generator] = None
    RATES: Tuple[str, ...] = ()

    def draws(self) -> bool:
        return any(getattr(self, rate) for rate in self.RATES)


def set_dropout_generator(module: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Point every drawing submodule of *module* (every :class:`Stochastic`)
    at *generator*, a generator on the activations' device.  The train step
    sets one per fragment, derived from the state's seed and step."""
    for sub in module.modules():
        if isinstance(sub, Stochastic):
            sub.generator = generator


def draws(module: nn.Module) -> bool:
    """Whether a training forward of *module* draws at all."""
    return any(isinstance(sub, Stochastic) and sub.draws()
               for sub in module.modules())


@register("torch.nn.Identity", "identity")
class Identity(nn.Module):
    def __init__(self):
        super().__init__()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def _cat(tensors, dim: int = -1) -> torch.Tensor:
    """Concatenate with JAX's type promotion (bf16 with f32 -> f32)."""
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return torch.cat([t.to(dtype) for t in tensors], dim=dim)


# ---------------------------------------------------------------------------
# torch.nn.* layer aliases (so the configs run unchanged)
# ---------------------------------------------------------------------------

@register("torch.nn.Conv2d", "nn.Conv2d", "conv2d")
class Conv2d(nn.Module):
    """The JAX package's ``Conv2d``: a flax ``nn.Conv`` (parameters under
    ``Conv_0``) with torch's argument names; padding as ``_padding``
    reads it, so ``"same"`` is lax's SAME."""

    def __init__(self, in_channels: int = 0, out_channels: int = 0,
                 kernel_size: Union[int, Tuple[int, int]] = 3,
                 stride: Union[int, Tuple[int, int]] = 1, padding: Any = 0,
                 bias: bool = True, groups: int = 1,
                 dilation: Union[int, Tuple[int, int]] = 1):
        super().__init__()
        self.Conv_0 = Conv(in_channels, out_channels, kernel_size,
                           stride=stride, use_bias=bias,
                           padding=_padding(padding), dilation=dilation,
                           groups=groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_0(x)


@register("torch.nn.MaxPool2d", "max_pool2d")
class MaxPool2d(nn.Module):
    """Max pooling over H and W of an NHWC tensor; the stride defaults to
    the window, padding (with -inf) as ``_padding`` reads it."""

    def __init__(self, kernel_size: Union[int, Tuple[int, int]] = 2,
                 stride: Optional[Union[int, Tuple[int, int]]] = None,
                 padding: Any = 0):
        super().__init__()
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride) if stride is not None \
            else self.kernel_size
        self.padding = "VALID" if padding == 0 else _padding(padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool(x, self.kernel_size, self.stride, self.padding)


def max_pool(x: torch.Tensor, kernel: Tuple[int, int],
             stride: Tuple[int, int], padding: Any) -> torch.Tensor:
    """Max pooling of an NHWC tensor with padding (-inf) as
    ``_axis_pads`` reads it; on a band of rows (spatial sharding) with its
    halo rows."""
    x = x.permute(0, 3, 1, 2)
    pads = _axis_pads(padding, spatial.global_size(x.shape[2:]), kernel,
                      stride, (1, 1))
    x, pads = spatial.halo(x, pads, kernel[0], stride[0], 1, -math.inf)
    (top, bottom), (left, right) = pads
    if (top, left) != (bottom, right):
        x = F.pad(x, (left, right, top, bottom), value=-math.inf)
        top = left = 0
    return F.max_pool2d(x, kernel, stride,
                        padding=(top, left)).permute(0, 2, 3, 1)


@register("torch.nn.Upsample", "upsample")
class Upsample(nn.Module):
    """Nearest-neighbour upsampling of H and W by an integer factor (the
    JAX package's ``jnp.repeat`` on both axes)."""

    def __init__(self, scale_factor: int = 2):
        super().__init__()
        self.scale_factor = int(scale_factor)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.interpolate(x.permute(0, 3, 1, 2),
                             scale_factor=self.scale_factor,
                             mode="nearest").permute(0, 2, 3, 1)


@register("torch.nn.AvgPool2d", "avg_pool2d")
class AvgPool2d(nn.Module):
    """Average pooling over H and W of an NHWC tensor; the stride defaults
    to the window.  Padding adds zeros that count in the mean (flax's
    ``avg_pool``)."""

    def __init__(self, kernel_size: Union[int, Tuple[int, int]] = 2,
                 stride: Optional[Union[int, Tuple[int, int]]] = None,
                 padding: Any = 0):
        super().__init__()
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride) if stride is not None \
            else self.kernel_size
        self.padding = "VALID" if padding == 0 else _padding(padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        pads = _axis_pads(self.padding, spatial.global_size(x.shape[2:]),
                          self.kernel_size, self.stride, (1, 1))
        x, ((top, bottom), (left, right)) = spatial.halo(
            x, pads, self.kernel_size[0], self.stride[0], 1)
        x = F.pad(x, (left, right, top, bottom))
        return F.avg_pool2d(x, self.kernel_size,
                            self.stride).permute(0, 2, 3, 1)


def _adaptive_pool_axis(x: torch.Tensor, dim: int, out: int) -> torch.Tensor:
    """Adaptive average pooling of one axis to *out* bins (torch's bins:
    bin i covers [floor(i n / out), ceil((i + 1) n / out)))."""
    n = x.shape[dim]
    if n == out:
        return x
    if n % out == 0:
        shape = x.shape[:dim] + (out, n // out) + x.shape[dim + 1:]
        return x.reshape(shape).mean(dim=dim + 1)
    return torch.cat([x.narrow(dim, (i * n) // out,
                               -(-((i + 1) * n) // out) - (i * n) // out)
                      .mean(dim=dim, keepdim=True) for i in range(out)],
                     dim=dim)


@register("torch.nn.AdaptiveAvgPool2d", "adaptive_avg_pool2d")
class AdaptiveAvgPool2d(nn.Module):
    """Adaptive average pooling of the two spatial axes of an NHWC tensor.
    A (B, L, C) tensor is read as torch reads an unbatched (C, H, W) one:
    its last two axes are pooled (``output_size (1, C)`` is the mean over
    the tokens, as the Swin pretraining head uses it)."""

    def __init__(self, output_size: Any = 1):
        super().__init__()
        self.output_size = output_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 4 and self.output_size in (1, (1, 1), [1, 1]):
            return spatial.mean_rows(x, (1, 2))
        out_h, out_w = _pair(self.output_size)
        if spatial.bands() is not None:
            # on a band of rows (spatial sharding): the mean over the rows
            # is the bands' sums, summed; bins that cross the bands take
            # the whole image first.  Either way what follows runs whole
            x = spatial.mean_rows(x, (1,)) if out_h == 1 \
                else spatial.to_whole(x)
        return _adaptive_pool_axis(_adaptive_pool_axis(x, 1, out_h), 2, out_w)


@register("torch.nn.Flatten", "flatten")
class Flatten(nn.Module):
    def __init__(self):
        super().__init__()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(x.shape[0], -1)


@register("torch.nn.Linear", "linear_layer")
class Linear(nn.Module):
    """The JAX package's ``Linear``: a flax ``nn.Dense`` (``Dense_0``) in
    the compute dtype, with torch's argument names."""

    def __init__(self, in_features: int = 0, out_features: int = 0,
                 bias: bool = True):
        super().__init__()
        self.Dense_0 = Dense(in_features, out_features, use_bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_0(x)


@register("torch.nn.LayerNorm", "layer_norm")
class TorchLayerNorm(nn.Module):
    """The JAX package's ``torch.nn.LayerNorm``: a flax ``nn.LayerNorm``
    (``LayerNorm_0``) with torch's epsilon, 1e-5."""

    def __init__(self, normalized_shape: int = 0, eps: float = 1e-5):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(normalized_shape, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm_0(x)


# ---------------------------------------------------------------------------
# core conv blocks
# ---------------------------------------------------------------------------

class BatchNorm(nn.Module):
    """The JAX package's ``TorchBatchNorm`` (``_batch_norm``): batch
    statistics in train mode, running statistics in eval mode, epsilon
    1e-5, the running averages updated with weight 0.1 on the batch
    (flax's momentum 0.9) and the *unbiased* batch variance, as torch
    does.  The input is cast to the compute dtype and the output has it;
    statistics, scale and bias stay float32.  Under data parallelism
    (``parallel.sync_batch_stats``) the batch is the global one."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.empty(num_features))
        self.bias = nn.Parameter(torch.empty(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        with torch.no_grad():
            self.running_mean.zero_()
            self.running_var.fill_(1.0)
            self.num_batches_tracked.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = compute_dtype() or torch.promote_types(x.dtype, torch.float32)
        weight, bias = full(self.weight), full(self.bias)
        running = self.running_mean, self.running_var
        if self.training:
            if _RECOMPUTING[0]:
                # a rematerialised block's recompute: the forward already
                # moved the statistics, so it moves copies (the same
                # arguments, so autograd saves the same tensors)
                running = tuple(t.clone() for t in running)
            else:
                self.num_batches_tracked.add_(1)
            axis = batch_stats_axis()
            if axis is not None:
                return self._global_batch_norm(x.to(dtype), weight, bias,
                                               axis, *running)
        return F.batch_norm(x.to(dtype).permute(0, 3, 1, 2), *running,
                            weight, bias, training=self.training,
                            momentum=self.momentum,
                            eps=self.eps).permute(0, 2, 3, 1)

    def _global_batch_norm(self, x: torch.Tensor, weight: torch.Tensor,
                           bias: torch.Tensor, axis,
                           running_mean: torch.Tensor,
                           running_var: torch.Tensor) -> torch.Tensor:
        """Training on one process's slice of a global batch: the
        statistics of the global batch over *axis*, as flax's BatchNorm
        takes them on a sharded batch.  A data-axis slice on the card takes
        PyTorch's fused SyncBatchNorm primitives (:class:`_GlobalBatchNorm`,
        an all-gather); on the CPU, which has none, and for the row bands of
        spatial sharding (data x spatial, all-reduces only, so the same
        code runs on NCCL and on gloo on the card): two float32 sums over
        the axis with autograd (each process's gradient then reaches the
        others' statistics), the channel sums with the element count, then
        the squared deviations from the global mean (in float64 for a
        float64 input); *running_mean* and *running_var* move."""
        if x.is_cuda and axis.name == "data":
            return _GlobalBatchNorm.apply(
                x.permute(0, 3, 1, 2), weight, bias, running_mean,
                running_var, self.eps, self.momentum,
                axis.group).permute(0, 2, 3, 1)
        dims = tuple(range(x.dim() - 1))
        wide = x.to(torch.promote_types(x.dtype, torch.float32))
        count = wide.new_full((1,), wide.numel() // wide.shape[-1])
        totals = all_reduce_sum(torch.cat([wide.sum(dims), count]), axis)
        n = totals[-1]
        mean = totals[:-1] / n
        centred = wide - mean
        var = all_reduce_sum((centred * centred).sum(dims), axis) / n
        with torch.no_grad():
            running_mean.lerp_(mean, self.momentum)
            running_var.lerp_(var * n / (n - 1), self.momentum)
        out = centred * torch.rsqrt(var + self.eps) * weight + bias
        return out.to(x.dtype)


class _GlobalBatchNorm(torch.autograd.Function):
    """BatchNorm over the global batch of every process, on the card: the
    fused kernels behind ``torch.nn.SyncBatchNorm`` (per-process mean and
    inverse std, their all-gather with the counts, the running statistics'
    update with the global unbiased variance, the elementwise map; in the
    backward the two channel sums, all-reduced).  Unlike SyncBatchNorm's
    own Function it filters no empty slice, which reads the card from the
    host: every process holds a slice of the same size.

    Each process differentiates the global loss through its own rows only
    (``parallel.gather_shards``), so the all-reduced sums are the global
    batch's, and the weight and bias gradients are this slice's share,
    summed later with the other parameters' (``parallel.reduce_gradients``).
    x is NCHW (a channels-last view)."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps,
                momentum, group):
        channels = x.shape[1]
        mean, invstd = torch.batch_norm_stats(x, eps)
        count = mean.new_full((1,), x.numel() // channels)
        local = torch.cat([mean, invstd, count])
        members = dist.get_world_size(group)
        gathered = local.new_empty(members * local.numel())
        dist.all_gather_into_tensor(gathered, local, group=group)
        gathered = gathered.view(members, -1)
        counts = gathered[:, 2 * channels]
        mean, invstd = torch.batch_norm_gather_stats_with_counts(
            x, gathered[:, :channels], gathered[:, channels:2 * channels],
            running_mean, running_var, momentum, eps, counts)
        ctx.group = group
        ctx.save_for_backward(x, weight, mean, invstd,
                              counts.to(torch.int32))
        return torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight, mean, invstd, counts = ctx.saved_tensors
        g = g.contiguous(memory_format=torch.channels_last) \
            if x.is_contiguous(memory_format=torch.channels_last) \
            else g.contiguous()
        sum_dy, sum_dy_xmu, grad_weight, grad_bias = \
            torch.batch_norm_backward_reduce(g, x, mean, invstd, weight,
                                             True, True, True)
        sums = torch.cat([sum_dy, sum_dy_xmu])
        dist.all_reduce(sums, group=ctx.group)
        sum_dy, sum_dy_xmu = sums.chunk(2)
        grad_input = torch.batch_norm_backward_elemt(
            g, x, mean, invstd, weight.to(mean.dtype), sum_dy, sum_dy_xmu,
            counts)
        return (grad_input, grad_weight, grad_bias, None, None, None, None,
                None)


@register("segmentation.models.blocks.ConvBlock", "conv_block")
class ConvBlock(Stochastic, nn.Module):
    """``size`` x (conv k x k -> BN -> act), an optional stride-2 last conv
    and torch's ``Dropout2d``: whole feature maps drop per (sample,
    channel)."""

    PARAMS = {
        "activations": "relu",
        "size": 2,
        "padding": 1,
        "kernel_size": 3,
        "dropout": False,
        "stride": None,
    }
    DROPOUT_RATE = 0.5
    RATES = ("dropout_rate",)

    @staticmethod
    def fill_kwargs(config_dict: ConfigDict):
        fill_activation_spec(config_dict, "activations")
        if config_dict.get("dropout"):
            config_dict.get_or_update("dropout/rate", ConvBlock.DROPOUT_RATE)

    def __init__(self, in_channels: int = 0, out_channels: int = 0,
                 size: int = 2, kernel_size: int = 3, padding: Any = 1,
                 activations: Any = "relu", dropout: Any = False,
                 stride: Optional[int] = None,
                 downsample_in_block: bool = False):
        super().__init__()
        self.size = size
        for i in range(size):
            downsampling = downsample_in_block and i == size - 1
            setattr(self, f"Conv_{i}", Conv(
                in_channels if i == 0 else out_channels, out_channels,
                kernel_size, stride=stride or (2 if downsampling else 1),
                padding=_padding(padding)))
            setattr(self, f"BatchNorm_{i}", BatchNorm(out_channels))
            setattr(self, f"Activation_{i}", make_activation(activations))
        self.dropout_rate = 0.0
        if dropout:
            self.dropout_rate = self.DROPOUT_RATE \
                if isinstance(dropout, bool) else float(dropout["rate"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.size):
            x = getattr(self, f"Conv_{i}")(x)
            x = getattr(self, f"BatchNorm_{i}")(x)
            x = getattr(self, f"Activation_{i}")(x)
        return dropout(x, self.dropout_rate, self.training, self.generator,
                       (x.shape[0], 1, 1, x.shape[-1]))


@register("segmentation.models.blocks.UpConvBlock", "up_conv_block")
class UpConvBlock(nn.Module):
    """Upsample (x2 nearest) -> conv with lax SAME padding -> act.  The
    2 x 2 kernel pads (0, 1) per axis."""

    PARAMS = {
        "activation": "relu",
        "kernel_size": 2,
        "scale_factor": 2,
    }

    @staticmethod
    def fill_kwargs(config_dict: ConfigDict):
        fill_activation_spec(config_dict, "activation")

    def __init__(self, in_channels: int = 0, out_channels: int = 0,
                 activation: Any = "relu", kernel_size: int = 2,
                 scale_factor: int = 2, channel_decrease_ratio: float = 0.5):
        super().__init__()
        self.Upsample_0 = Upsample(scale_factor)
        self.Conv_0 = Conv(in_channels, out_channels, kernel_size,
                           padding="SAME")
        self.Activation_0 = make_activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Activation_0(self.Conv_0(self.Upsample_0(x)))


# ---------------------------------------------------------------------------
# the residual block zoo, layer scaling and the U-Net's shortcuts
# ---------------------------------------------------------------------------

@register("segmentation.models.blocks.ChannelwiseLayerNorm",
          "channelwise_layer_norm")
class ChannelwiseLayerNorm(nn.Module):
    """LayerNorm over the channel axis, the last one of an NHWC tensor."""

    def __init__(self, num_features: int = 0, smoothing_term: float = 1e-6):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(num_features, eps=smoothing_term)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm_0(x)


@register("segmentation.models.blocks.LayerScale", "layer_scale")
class LayerScale(nn.Module):
    """``x * scale`` per channel.  The scale (flax's ``scale``, named
    ``weight`` here as every flax ``scale`` is) stays float32 and is cast
    to the activation's dtype, so a bf16 branch stays bf16."""

    def __init__(self, n_channels: int = 0, init_value: float = 1e-6):
        super().__init__()
        self.init_value = float(init_value)
        self.weight = nn.Parameter(torch.empty(n_channels))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        nn.init.constant_(self.weight, self.init_value)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * full(self.weight).to(x.dtype)


class _BottleneckTriple(nn.Module):
    """1 x 1 -> depthwise k x k -> 1 x 1, each conv + BN + act, through
    *mid* channels."""

    def __init__(self, in_channels: int, mid: int, out_channels: int,
                 kernel_size: int, activations: Any):
        super().__init__()
        self.Conv_0 = Conv(in_channels, mid, 1, padding="SAME")
        self.Conv_1 = Conv(mid, mid, kernel_size, padding="SAME", groups=mid)
        self.Conv_2 = Conv(mid, out_channels, 1, padding="SAME")
        for i in range(3):
            setattr(self, f"BatchNorm_{i}", BatchNorm(
                out_channels if i == 2 else mid))
            setattr(self, f"Activation_{i}", make_activation(activations))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(3):
            x = getattr(self, f"Conv_{i}")(x)
            x = getattr(self, f"BatchNorm_{i}")(x)
            x = getattr(self, f"Activation_{i}")(x)
        return x


@register("segmentation.models.blocks.ResNeXtBlock", "resnext_block")
class ResNeXtBlock(_BottleneckTriple):
    """(1 x 1 C -> C/4) -> (depthwise k x k) -> (1 x 1 C/4 -> C)."""

    @staticmethod
    def fill_kwargs(config_dict: ConfigDict):
        fill_activation_spec(config_dict, "activations")

    def __init__(self, in_channels: int = 0, out_channels: int = 0,
                 kernel_size: int = 3, activations: Any = "relu"):
        super().__init__(in_channels, out_channels // 4, out_channels,
                         kernel_size, activations)


@register("segmentation.models.blocks.InvertedBottleneckBlock",
          "inverted_bottleneck_block")
class InvertedBottleneckBlock(_BottleneckTriple):
    """(1 x 1 C -> 4C) -> (depthwise k x k) -> (1 x 1 4C -> C)."""

    @staticmethod
    def fill_kwargs(config_dict: ConfigDict):
        fill_activation_spec(config_dict, "activations")

    def __init__(self, in_channels: int = 0, out_channels: int = 0,
                 kernel_size: int = 3, activations: Any = "relu"):
        super().__init__(in_channels, out_channels * 4, out_channels,
                         kernel_size, activations)


@register("segmentation.models.blocks.ConvNeXtBlock", "convnext_block")
class ConvNeXtBlock(nn.Module):
    """Depthwise k x k conv -> norm -> 1 x 1 (4x) -> act -> 1 x 1.  The
    depthwise conv has ``min(in_channels, channels[0])`` groups; with
    ``reduce_number_of_*`` off, a norm follows each 1 x 1 conv and an
    activation each norm.  The norm is any registered one; its width fills
    ``num_features`` or ``normalized_shape``."""

    #: the flax module name of a norm, where it is not its class's name
    _FLAX_NAMES = {"TorchLayerNorm": "LayerNorm"}

    @staticmethod
    def fill_kwargs(config_dict: ConfigDict):
        fill_activation_spec(config_dict, "activations")

    def __init__(self, in_channels: int = 0, out_channels: int = 0,
                 kernel_size: int = 3, activations: Any = "gelu",
                 normalisation: Any =
                 "segmentation.models.blocks.ChannelwiseLayerNorm",
                 reduce_number_of_activations: bool = True,
                 reduce_number_of_norm_layers: bool = True,
                 channel_change_index: int = 1):
        super().__init__()
        if channel_change_index not in (1, 2, 3):
            raise ValueError("channel_change_index should be in (1, 2, 3)")
        i = channel_change_index
        channels = (in_channels,) * (i - 1) + (out_channels,) * (3 - i)
        self.full = (not reduce_number_of_activations,
                     not reduce_number_of_norm_layers)
        self.Conv_0 = Conv(in_channels, channels[0], kernel_size,
                           padding="SAME",
                           groups=min(in_channels, channels[0]))
        self.Conv_1 = Conv(channels[0], 4 * channels[1], 1, padding="SAME")
        self.Conv_2 = Conv(4 * channels[1], out_channels, 1, padding="SAME")
        widths = [channels[0]]
        if not reduce_number_of_norm_layers:
            widths += [4 * channels[1], out_channels]
        self.norms = [self._add_norm(normalisation, k, width)
                      for k, width in enumerate(widths)]
        for k in range(3 if not reduce_number_of_activations else 1):
            setattr(self, f"Activation_{k}", make_activation(activations))

    def _add_norm(self, cfg, k: int, num_features: int) -> str:
        if isinstance(cfg, str):
            name, params = cfg, ConfigDict()
        else:
            name, params = cfg.item()
            if not isinstance(params, ConfigDict):
                params = ConfigDict()
        constructor = resolve(name)
        kwargs = get_kwargs(constructor, params)
        for field in ("num_features", "normalized_shape"):
            if block_accepts(constructor, field):
                kwargs[field] = num_features
                break
        attr = f"{self._FLAX_NAMES.get(constructor.__name__, constructor.__name__)}_{k}"
        setattr(self, attr, constructor(**kwargs))
        return attr

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        full_acts, full_norms = self.full
        x = getattr(self, self.norms[0])(self.Conv_0(x))
        if full_acts:
            x = self.Activation_0(x)
        x = self.Conv_1(x)
        if full_norms:
            x = getattr(self, self.norms[1])(x)
        x = getattr(self, f"Activation_{int(full_acts)}")(x)
        x = self.Conv_2(x)
        if full_norms:
            x = getattr(self, self.norms[2])(x)
        if full_acts:
            x = self.Activation_2(x)
        return x


class ResConnection(nn.Module):
    """A U-Net block's shortcut: identity, with the channels adapted by
    ``fill_with_zeros`` / ``repeat`` (more out than in) or ``add`` /
    ``cut_off`` (fewer), or a projection, a conv (1 x 1 by default, stride
    2 when the block downsamples) with optional BatchNorm and ReLU."""

    CONV_PARAMS = {"kernel_size": 1, "batch_norm": True, "activation": False}

    def __init__(self, in_channels: int = 0, out_channels: int = 0,
                 downsampling: bool = False, type_config: Any = "identity"):
        super().__init__()
        if isinstance(type_config, str):
            kind, params = type_config, ConfigDict()
        else:
            kind, params = type_config.item()
            if not isinstance(params, ConfigDict):
                params = ConfigDict()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kind, self.method = kind, None
        if kind == "identity":
            if downsampling:
                raise NotImplementedError(
                    "identity shortcut with spatial downsampling")
            if in_channels < out_channels:
                self.method = params.get_str("expand_method") \
                    if params.has("expand_method") else "fill_with_zeros"
                if self.method == "repeat" and out_channels % in_channels:
                    raise ValueError("repeat expand needs divisibility")
                if self.method not in ("fill_with_zeros", "repeat"):
                    raise ValueError(
                        f"unknown expand_method {self.method!r}")
            elif in_channels > out_channels:
                self.method = params.get_str("contract_method") \
                    if params.has("contract_method") else "add"
                if self.method == "add" and in_channels % out_channels:
                    raise ValueError("add contract needs divisibility")
                if self.method not in ("add", "cut_off"):
                    raise ValueError(
                        f"unknown contract_method {self.method!r}")
        elif kind in ("conv", "convolution"):
            merged = dict(self.CONV_PARAMS)
            merged.update({k.replace(" ", "_"): v
                           for k, v in params.trim().to_dict().items()})
            kernel = merged["kernel_size"]
            self.Conv_0 = Conv(in_channels, out_channels, kernel,
                               stride=2 if downsampling else 1,
                               padding="VALID" if kernel == 1 else "SAME")
            if merged["batch_norm"]:
                self.BatchNorm_0 = BatchNorm(out_channels)
            self.relu = bool(merged["activation"])
        else:
            raise ValueError(f"shortcut type must be identity/convolution, "
                             f"got {kind!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cin, cout = self.in_channels, self.out_channels
        if self.kind == "identity":
            if self.method == "fill_with_zeros":
                return torch.cat([x, x.new_zeros(x.shape[:-1]
                                                 + (cout - cin,))], dim=-1)
            if self.method == "repeat":
                return torch.cat([x] * (cout // cin), dim=-1)
            if self.method == "add":
                return x.reshape(x.shape[:-1] + (cin // cout, cout)).sum(-2)
            if self.method == "cut_off":
                return x[..., :cout]
            return x
        y = self.Conv_0(x)
        if hasattr(self, "BatchNorm_0"):
            y = self.BatchNorm_0(y)
        return F.relu(y) if self.relu else y


# ---------------------------------------------------------------------------
# mixing blocks (decoder skip-connection aggregation)
# ---------------------------------------------------------------------------

@register("segmentation.models.blocks.ConcatBlock", "concatenate")
class ConcatBlock(nn.Module):
    """Channel concat of the upsampled path and the skip value."""

    def __init__(self):
        super().__init__()

    @staticmethod
    def get_out_ch(x_channels, x_up_channels, skip_channels,
                   level_out_channels):
        return x_up_channels + skip_channels

    def forward(self, x, x_up, skip_val):
        return _cat([x_up, skip_val])


@register("segmentation.models.blocks.ConcatLinearBlock",
          "concat_linear_block")
class ConcatLinearBlock(nn.Module):
    """Channel concat + linear projection (Swin decoder mixing) on (B, L, C)
    sequences."""

    def __init__(self, x_channels: int = 0, x_up_channels: int = 0,
                 skip_channels: int = 0, level_out_channels: int = 0):
        super().__init__()
        self.Dense_0 = Dense(x_up_channels + skip_channels,
                             level_out_channels)

    @staticmethod
    def get_out_ch(x_channels, x_up_channels, skip_channels,
                   level_out_channels):
        return level_out_channels

    def forward(self, x, x_up, skip_val):
        return self.Dense_0(_cat([x_up, skip_val]))


@register("segmentation.models.blocks.AttentionBlock", "attention_block")
class AttentionBlock(nn.Module):
    """The attention-U-Net gate (arXiv:1804.03999): a gating signal from the
    coarse path *x* reweights the skip tensor before the concat.  The
    gating block (a 1 x 1 ``ConvBlock`` by default) and a 1 x 1 conv with
    BatchNorm on *x*, a 2 x 2 stride-2 conv with BatchNorm on the skip,
    their sum through a ReLU, a 1 x 1 conv to the skip's channels with
    BatchNorm, a sigmoid, nearest upsampling by 2; out: [x_up, skip * p].
    ``halve_channels`` is accepted and, as in the JAX package, unused."""

    PARAMS = {
        "gating signal": {
            "argument name": "gating_signal",
            "default": {"segmentation.models.blocks.ConvBlock": {
                "size": 1, "kernel size": 1, "padding": 0}},
        },
        "halve_channels": False,
    }

    @staticmethod
    def fill_kwargs(config_dict: ConfigDict):
        fill_spec(config_dict, "gating signal")

    @staticmethod
    def get_out_ch(x_channels, x_up_channels, skip_channels,
                   level_out_channels):
        return x_up_channels + skip_channels

    def __init__(self, x_channels: int = 0, x_up_channels: int = 0,
                 skip_channels: int = 0, level_out_channels: int = 0,
                 gating_signal: Any = None, halve_channels: bool = False):
        super().__init__()
        if gating_signal is None:
            gating_signal = ConfigDict(
                {"segmentation.models.blocks.ConvBlock": {
                    "size": 1, "kernel_size": 1, "padding": 0}})
        self.ConvBlock_0 = make_block_builder(gating_signal)(x_channels,
                                                             x_channels)
        self.Conv_0 = Conv(x_channels, x_channels, 1)
        self.BatchNorm_0 = BatchNorm(x_channels)
        self.Conv_1 = Conv(skip_channels, x_channels, 2, stride=2)
        self.BatchNorm_1 = BatchNorm(x_channels)
        self.Conv_2 = Conv(x_channels, skip_channels, 1)
        self.BatchNorm_2 = BatchNorm(skip_channels)
        self.Upsample_0 = Upsample(2)

    def forward(self, x, x_up, skip_val):
        g1 = self.BatchNorm_0(self.Conv_0(self.ConvBlock_0(x)))
        x1 = self.BatchNorm_1(self.Conv_1(skip_val))
        p = self.BatchNorm_2(self.Conv_2(F.relu(x1 + g1)))
        p = self.Upsample_0(torch.sigmoid(p))
        return _cat([x_up, skip_val * p])


def mixing_out_channels(mixing, **channel_kwargs) -> int:
    """Output channels of a mixing block constructor or instance."""
    fn = getattr(mixing, "get_out_ch", None)
    if fn is None:
        return channel_kwargs["x_up_channels"] + channel_kwargs["skip_channels"]
    return fn(**channel_kwargs)


# ---------------------------------------------------------------------------
# config -> block factory plumbing
# ---------------------------------------------------------------------------

def block_accepts(constructor, field: str) -> bool:
    try:
        return field in inspect.signature(constructor).parameters
    except (TypeError, ValueError):
        return False


def make_block_builder(block_cfg: Any):
    """Resolve a block config to ``builder(in_ch, out_ch, **ctx) -> Module``.

    *ctx* keys (``downsample_in_block``, ``position``,
    ``stochastic_depth_rate``, ...) are forwarded only when the block's
    constructor takes such an argument.
    """
    if isinstance(block_cfg, str):
        block_cfg = ConfigDict({block_cfg: {}})
    elif not isinstance(block_cfg, ConfigDict):
        block_cfg = ConfigDict(dict(block_cfg))
    name, params = block_cfg.item()
    if not isinstance(params, ConfigDict):
        params = ConfigDict()
        block_cfg[name] = params
    constructor = resolve(name)
    fill_spec(block_cfg)  # idempotent: injects missing defaults in place
    base_kwargs = get_kwargs(constructor, params)
    base_kwargs = {k: v for k, v in base_kwargs.items()
                   if block_accepts(constructor, k)}

    def build(in_channels: int, out_channels: int, **ctx) -> nn.Module:
        kwargs = dict(base_kwargs)
        if block_accepts(constructor, "in_channels"):
            kwargs["in_channels"] = in_channels
        if block_accepts(constructor, "out_channels"):
            kwargs["out_channels"] = out_channels
        for key, value in ctx.items():
            if block_accepts(constructor, key):
                kwargs[key] = value
        return constructor(**kwargs)

    build.constructor = constructor
    return build
