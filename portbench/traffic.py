"""The one generator of the benchmark's traffic: a pool of distinct
segmentation batches made from the seed.

Each image is a gray field of noise with bright discs on it, and the discs
are its mask (as chest-X-ray infection masks are bright blobs on a noisy
background), replicated to the configuration's input channels.  A traffic
file sets the batch, the pool, the discs and the grays, and may set
``"order": "mask_area"``: each batch's images sorted by the area of their
mask, so the first half of a batch holds its smaller masks (a step that
sees part of a batch then reads far from one that sees it whole, where
alike images would differ by sampling noise alone).  The image side and
channels come from the configuration.  The pool is made on the device in a
few calls and kept in pinned host memory as uint8, as the port's loader
hands batches over.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

__all__ = ["stream_seed", "make_pool", "pin"]


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    value = np.random.SeedSequence([int(seed), int(stream)]).generate_state(
        1, np.uint64)[0]
    return int(value) & ((1 << 63) - 1)


def make_pool(traffic: dict, size: int, channels: int, seed: int,
              device) -> List[Dict[str, torch.Tensor]]:
    """``traffic["pool"]`` batches of ``traffic["batch"]`` images, each
    ``{"x": (B, size, size, channels) uint8, "mask": (B, size, size)
    uint8}`` on *device*."""
    batch, pool = int(traffic["batch"]), int(traffic["pool"])
    discs = int(traffic["discs"])
    lo, hi = (int(size * r) for r in traffic["radius"])
    n = batch * pool
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, 1))
    centres = torch.randint(0, size, (n, discs, 2), generator=gen,
                            device=device)
    radii = torch.randint(lo, hi, (n, discs), generator=gen, device=device)
    axis = torch.arange(size, device=device)
    masks = torch.zeros((n, size, size), dtype=torch.bool, device=device)
    for d in range(discs):
        dy = (axis[None, :] - centres[:, d, 0:1]) ** 2
        dx = (axis[None, :] - centres[:, d, 1:2]) ** 2
        masks |= dy[:, :, None] + dx[:, None, :] < (radii[:, d] ** 2)[:, None,
                                                                    None]
    noise = torch.randn((n, size, size), generator=gen, device=device)
    gray = (float(traffic["background"]) + float(traffic["foreground"])
            * masks.float() + float(traffic["noise"]) * noise)
    x = gray.clamp_(0, 255).to(torch.uint8)[..., None] \
        .expand(n, size, size, channels).contiguous()
    masks = masks.to(torch.uint8)
    order = traffic.get("order")
    if order == "mask_area":
        area = masks.view(pool, batch, -1).sum(-1, dtype=torch.int64)
        rank = (area.argsort(dim=1, stable=True)
                + batch * torch.arange(pool, device=device)[:, None])
        x, masks = x[rank.flatten()], masks[rank.flatten()]
    elif order is not None:
        raise ValueError(f"unknown traffic order {order!r}")
    return [{"x": x[i * batch:(i + 1) * batch],
             "mask": masks[i * batch:(i + 1) * batch]} for i in range(pool)]


def pin(pool: List[Dict[str, torch.Tensor]]) -> List[Dict[str, torch.Tensor]]:
    """The pool in pinned host memory (plain host memory without a card)."""
    out = []
    for batch in pool:
        host = {k: v.cpu() for k, v in batch.items()}
        if torch.cuda.is_available():
            host = {k: v.pin_memory() for k, v in host.items()}
        out.append(host)
    return out
