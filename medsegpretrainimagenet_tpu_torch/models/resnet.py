"""Deep ResNet encoder/classifier on NHWC images: the port of
``models/resnet.py``.

ResNet v1/v2 with basic or bottleneck blocks, configurable widths and
channel ladders (the defaults are ResNet-50), a 7x7 stride-2 stem and a
max pool, zero-fill shortcuts with stride-2 subsampling, linearly spaced
stochastic depth and an optional classifier head.  ``forward`` can return
the per-level skip tensors (the stem's output and the first three stages'),
which the robustness sweep scores.

Submodules carry the flax parameter paths (``stem_conv``, ``stem_bn``,
``levels.{i}.{j}.Conv_k|BatchNorm_k``, ``head_bn``, ``head_dense``), so
``transfer.state_dict_from_jax`` maps a JAX checkpoint key by key.  Flax
infers the stem's input channels from the first input it sees; a torch
module declares them, so here ``in_channels`` sizes the stem (the JAX
package never reads its ``in_channels``).
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import register
from ..parallel import spatial
from .blocks import (BatchNorm, Conv, Dense, Stochastic, max_pool,
                     maybe_remat)

__all__ = ["DeepResNet", "BasicResBlock", "BottleneckResBlock", "drop_path"]


def drop_path(x: torch.Tensor, rate: float, training: bool,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """The reference's *classification* DropPath, distinct from the
    segmentation one in ``blocks.drop_path``: training keeps each sample's
    branch with probability 1 - rate *without* rescaling it, drawing from
    *generator*, and eval multiplies by that probability."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    if not training:
        return x * torch.tensor(keep, dtype=x.dtype)
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = torch.rand(shape, device=x.device, generator=generator) < keep
    return torch.where(mask, x, torch.zeros_like(x))


def _zero_fill_shortcut(x: torch.Tensor, out_channels: int,
                        downsample: bool) -> torch.Tensor:
    """A 1x1 average pool of stride 2 (every other pixel) and zero channels
    appended up to *out_channels*."""
    if downsample:
        x = x[:, ::2, ::2]
    cin = x.shape[-1]
    if out_channels == cin:
        return x
    if out_channels < cin:
        raise ValueError("out channels must not shrink in ResNet shortcut")
    return torch.cat([x, x.new_zeros(*x.shape[:-1], out_channels - cin)],
                     dim=-1)


def _conv3(cin: int, cout: int, stride: int, bias: bool) -> Conv:
    return Conv(cin, cout, 3, stride=stride, padding=((1, 1), (1, 1)),
                use_bias=bias)


class BasicResBlock(Stochastic, nn.Module):
    """Two 3x3 convs.  v2 runs its first BatchNorm and ReLU on the input
    and discards the result, as the reference does: conv1 takes the raw
    input, and the BatchNorm's parameters (and, in training, its running
    statistics) still exist."""

    RATES = ("drop_probability",)

    def __init__(self, in_channels: int, out_channels: int,
                 version: str = "v1", downsample: bool = False,
                 bias: bool = True, drop_probability: float = 0.0):
        super().__init__()
        self.out_channels, self.version = out_channels, version
        self.downsample, self.drop_probability = downsample, drop_probability
        stride = 2 if downsample else 1
        self.Conv_0 = _conv3(in_channels, out_channels, stride, bias)
        self.Conv_1 = _conv3(out_channels, out_channels, 1, bias)
        norms = (out_channels, out_channels) if version == "v1" \
            else (in_channels, out_channels)
        self.BatchNorm_0 = BatchNorm(norms[0])
        self.BatchNorm_1 = BatchNorm(norms[1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = _zero_fill_shortcut(x, self.out_channels, self.downsample)
        if self.version == "v1":
            y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
            y = self.BatchNorm_1(self.Conv_1(y))
            y = drop_path(y, self.drop_probability, self.training,
                          self.generator)
            return F.relu(y + shortcut)
        self.BatchNorm_0(x)  # output discarded (see the class docstring)
        y = F.relu(self.BatchNorm_1(self.Conv_0(x)))
        y = self.Conv_1(y)
        y = drop_path(y, self.drop_probability, self.training,
                      self.generator)
        return y + shortcut


class BottleneckResBlock(Stochastic, nn.Module):
    """1x1 down to a quarter of the channels, 3x3 (strided when
    downsampling), 1x1 up; v2 is pre-activation."""

    RATES = ("drop_probability",)

    def __init__(self, in_channels: int, out_channels: int,
                 version: str = "v1", downsample: bool = False,
                 bias: bool = True, drop_probability: float = 0.0):
        super().__init__()
        self.out_channels, self.version = out_channels, version
        self.downsample, self.drop_probability = downsample, drop_probability
        mid = out_channels // 4
        self.Conv_0 = Conv(in_channels, mid, 1, use_bias=bias)
        self.Conv_1 = _conv3(mid, mid, 2 if downsample else 1, bias)
        self.Conv_2 = Conv(mid, out_channels, 1, use_bias=bias)
        norms = (mid, mid, out_channels) if version == "v1" \
            else (in_channels, mid, mid)
        for k, features in enumerate(norms):
            setattr(self, f"BatchNorm_{k}", BatchNorm(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = _zero_fill_shortcut(x, self.out_channels, self.downsample)
        if self.version == "v1":
            y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
            y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
            y = self.BatchNorm_2(self.Conv_2(y))
            y = drop_path(y, self.drop_probability, self.training,
                          self.generator)
            return F.relu(y + shortcut)
        y = self.Conv_0(F.relu(self.BatchNorm_0(x)))
        y = self.Conv_1(F.relu(self.BatchNorm_1(y)))
        y = self.Conv_2(F.relu(self.BatchNorm_2(y)))
        y = drop_path(y, self.drop_probability, self.training,
                      self.generator)
        return y + shortcut


@register("classification.models.DeepResNet", "deep_resnet", "resnet")
class DeepResNet(nn.Module):
    """ResNet v1/v2 (the defaults are ResNet-50) with skip-value output."""

    #: the channel chain a U-Net reads when its encoder names none
    DEFAULT_CHANNEL_SIZES = (256, 512, 1024, 2048)

    def __init__(self, version: Any = "v1", bottleneck: bool = True,
                 channel_sizes: Sequence[int] = (256, 512, 1024, 2048),
                 widths: Sequence[int] = (3, 4, 6, 3), in_channels: int = 3,
                 base_channel_size: int = 64, bias: bool = True,
                 head: Any = False, stochastic_depth_rate: float = 0.0,
                 output_size: int = 1000):
        super().__init__()
        if isinstance(version, int):
            version = f"v{version}"
        if version not in ("v1", "v2"):
            raise ValueError(f"ResNet version must be v1/v2, got {version!r}")
        if len(widths) != len(channel_sizes):
            raise ValueError("each level needs one width and one channel size")
        self.version, self.head = version, bool(head)
        block_cls = BottleneckResBlock if bottleneck else BasicResBlock
        probs = np.linspace(0.0, stochastic_depth_rate or 0.0, sum(widths))
        self.stem_conv = Conv(in_channels, base_channel_size, 7, stride=2,
                              padding=((3, 3), (3, 3)), use_bias=bias)
        if version == "v1":
            self.stem_bn = BatchNorm(base_channel_size)
        self.levels = nn.ModuleList()
        offset, cin = 0, base_channel_size
        for i, (width, out_ch) in enumerate(zip(widths, channel_sizes)):
            level = nn.ModuleList()
            for j in range(width):
                level.append(block_cls(
                    cin, out_ch, version=version,
                    downsample=bool(i) and j == 0, bias=bias,
                    drop_probability=float(probs[offset + j])))
                cin = out_ch
            self.levels.append(level)
            offset += width
        if self.head:
            if version == "v2":
                self.head_bn = BatchNorm(cin)
            self.head_dense = Dense(cin, output_size)

    def forward(self, x: torch.Tensor, return_skip_vals: bool = False):
        y = self.stem_conv(x)
        if self.version == "v1":
            y = F.relu(self.stem_bn(y))
        skip_values = [y]
        y = max_pool(y, (3, 3), (2, 2), ((1, 1), (1, 1)))
        for level in self.levels:
            for block in level:
                y = maybe_remat(block, y)
            skip_values.append(y)
        if self.head:
            if self.version == "v2":
                y = F.relu(self.head_bn(y))
            # the image's mean, over the bands under spatial sharding
            y = self.head_dense(spatial.mean_rows(y, (1, 2), keepdim=False))
        if return_skip_vals:
            return y, skip_values[:-1]
        return y
