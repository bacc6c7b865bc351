"""The plain U-Net (U-Net, arXiv:1505.04597) as the config tree arranges
it: two 3x3 conv-BatchNorm-ReLU a block, 2x2 max pooling, nearest
upsampling and a 2x2 conv up, a 1x1 conv and a sigmoid out; NHWC, float32,
every product through :class:`~portbench.reference.ops.Ops`.  The
parameters are keyed by the port's state-dict names.  ``ckpt=True``
recomputes each block in the backward, so that the float32 step at the
timed batch fits beside nothing else on the card."""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.ops import Ops, same_pads

__all__ = ["UNetShape", "shape_of", "forward", "drop_rates", "small",
           "attention_calls"]


@dataclass
class UNetShape:
    channels: Sequence[int]
    in_channels: int
    out_channels: int


def _arch(tree: dict) -> dict:
    return tree["model"]["segmentation.models.UNet"]["architecture"]


def shape_of(tree: dict) -> UNetShape:
    arch = _arch(tree)
    depth = arch.get("depth", 4)
    channels = arch.get("channels") or [64 * 2 ** i for i in range(depth + 1)]
    return UNetShape(channels=tuple(channels),
                     in_channels=arch.get("in_channel_size", 3),
                     out_channels=arch.get("out_channel_size", 1))


def drop_rates(shape: UNetShape) -> list:
    """No stochastic depth."""
    return []


def attention_calls(shape: UNetShape, batch: int) -> list:
    """No window attention."""
    return []


def small(tree: dict) -> dict:
    """*tree* cut to channels 8, 16, 32 at depth 2, for 32 x 32 images."""
    tree = copy.deepcopy(tree)
    _arch(tree).update(channels=[8, 16, 32], depth=2)
    return tree


def _conv_block(ops: Ops, p, name: str, x, train: bool,
                running: Dict[str, torch.Tensor]):
    for i in range(2):
        x = ops.conv(x, p[f"{name}.Conv_{i}.weight"],
                     p[f"{name}.Conv_{i}.bias"], pads=((1, 1), (1, 1)))
        bn = f"{name}.BatchNorm_{i}"
        x = ops.batch_norm(bn, x, p[f"{bn}.weight"], p[f"{bn}.bias"],
                           running[f"{bn}.running_mean"],
                           running[f"{bn}.running_var"], train)
        x = torch.relu(x)
    return x


def forward(ops: Ops, p, x, s: UNetShape, train: bool, keeps=None,
            running: Optional[Dict[str, torch.Tensor]] = None,
            ckpt: bool = False):
    """(B, H, W, C) images in [0, 1] -> (B, H, W, out) probabilities.
    *running*: the BatchNorm running statistics (read in eval; training
    leaves the batch statistics in ``ops.stats``)."""
    running = running if running is not None else p
    depth = len(s.channels) - 1

    def block(name, h):
        def fn(h_):
            return _conv_block(ops, p, name, h_, train, running)
        if ckpt:
            return checkpoint(fn, h, use_reentrant=False)
        return fn(h)

    h = ops.conv(x, p["enc.stem_block.Conv_0.weight"],
                 p["enc.stem_block.Conv_0.bias"], pads=((1, 1), (1, 1)),
                 first=True)
    skips = []
    for i in range(depth):
        h = block(f"enc.level_convs.{i}.0", h)
        skips.append(h)
        h = F.max_pool2d(h.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    h = block("enc.bottom_convs.0", h)
    for i in range(depth):
        u = F.interpolate(h.permute(0, 3, 1, 2), scale_factor=2,
                          mode="nearest").permute(0, 2, 3, 1)
        pad = same_pads(u.shape[1], 2)
        u = torch.relu(ops.conv(u, p[f"dec.upsamples.{i}.Conv_0.weight"],
                                p[f"dec.upsamples.{i}.Conv_0.bias"],
                                pads=(pad, pad)))
        h = block(f"dec.level_convs.{i}.0",
                  torch.cat([u, skips.pop()], dim=-1))
    out = ops.conv(h, p["dec.final.Conv_0.weight"], p["dec.final.Conv_0.bias"])
    return ops.output(torch.sigmoid(out))
