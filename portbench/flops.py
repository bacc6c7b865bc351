"""Model FLOPs of one image, from the reference's output shapes.

The reference's forward runs on the meta device (shapes only, no
arithmetic) and counts the multiply-adds of every convolution, dense layer
and window-attention product (q k^T and P v, N x N x C a window each).  A
forward is 2 FLOPs a multiply-add; a training step adds both backward
products (input and weight gradients) of every product, less the input
gradient of the products that read the image.  Recomputation is never
counted.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .reference.ops import Ops

__all__ = ["forward_macs", "train_flops", "eval_flops"]


def forward_macs(arch, tree: dict, size: int, channels: int,
                 leaves: Dict[str, Tuple[int, ...]]) -> Tuple[int, int]:
    """(all multiply-adds, those of the products on the image) of one
    forward of one image through the model of the architecture module
    *arch* and *tree*; *leaves* maps the parameter names to shapes."""
    meta = torch.device("meta")
    params = {k: torch.empty(s, device=meta) for k, s in leaves.items()}
    ops = Ops()
    arch.forward(ops, params,
                 torch.empty((1, size, size, channels), device=meta),
                 arch.shape_of(tree), train=False, running=params)
    return ops.macs, ops.first_macs


def train_flops(macs: Tuple[int, int]) -> int:
    """FLOPs of one image's training step: forward, weight and input
    gradients, less the image's input gradient."""
    every, first = macs
    return 2 * (3 * every - first)


def eval_flops(macs: Tuple[int, int]) -> int:
    return 2 * macs[0]
