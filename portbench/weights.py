"""Seeded weights, made on the device in a few calls and handed to the
program and to the reference alike.

Every kernel (a leaf of two or more dimensions: convolution and dense
weights, the relative-position-bias tables) is drawn from the scheme the
configuration names, all kernels in one draw; biases are 0, norm scales 1,
running means 0 and running variances 1.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

from .traffic import stream_seed

__all__ = ["make_weights", "SCHEMES"]

#: "trunc_normal": std 0.02 cut at +-2 (timm's trunc_normal_);
#: "kaiming_normal": std sqrt(2 / fan_in) (ReLU gain, fan-in mode)
SCHEMES = ("trunc_normal", "kaiming_normal")


def make_weights(leaves: Iterable[Tuple[str, Tuple[int, ...], torch.dtype]],
                 scheme: str, seed: int, device) -> Dict[str, torch.Tensor]:
    """*leaves*: (name, shape, dtype) of every state-dict entry."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown weight scheme {scheme!r}")
    leaves = list(leaves)
    kernels = [(n, s) for n, s, d in leaves if len(s) >= 2]
    total = sum(math.prod(s) for _, s in kernels)
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, 0))
    flat = torch.empty(total, device=device)
    if scheme == "trunc_normal":
        torch.nn.init.trunc_normal_(flat, std=0.02, a=-2.0, b=2.0,
                                    generator=gen)
    else:
        flat.normal_(generator=gen)
    out, offset = {}, 0
    for name, shape in kernels:
        size = math.prod(shape)
        leaf = flat[offset:offset + size].view(shape)
        if scheme == "kaiming_normal":
            leaf.mul_(math.sqrt(2.0 / math.prod(shape[1:])))
        out[name] = leaf
        offset += size
    for name, shape, dtype in leaves:
        if name in out:
            continue
        ones = name.endswith("running_var") or (
            name.endswith("weight") and len(shape) == 1)
        out[name] = (torch.ones if ones else torch.zeros)(
            shape, dtype=dtype, device=device)
    return out
