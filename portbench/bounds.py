"""Least device time of the window attention (K1) of one forward, from
its shapes: per call the larger of bytes over the memory rate and
operations over the peak rate.

Forward: q, k, v, the (H, N, N) bias and the (nW, N, N) mask read once,
the output written once; two products of 2 N^2 D operations a window and
head.  Backward: q, k, v and the output's gradient read, dq, dk, dv
written, the bias read and its gradient written, the mask read; five
products (S, dP, dV, dQ, dK).  Both as the port's kernel measurements
count them (0.126 ms and 0.220 ms for a bf16 forward and backward of
``swin_unet_224`` at batch 24).
"""
from __future__ import annotations

from typing import Iterable, List, NamedTuple

from .peaks import HBM_BYTES_PER_S, PEAK_FLOPS

__all__ = ["Call", "attention_calls", "forward_bound_s", "backward_bound_s"]


class Call(NamedTuple):
    batch: int       # images
    windows: int     # windows an image
    heads: int
    tokens: int      # N
    head_dim: int    # D
    masked: bool


def attention_calls(batch: int, img_size: int, patch: int, embed: int,
                    heads: Iterable[int], window: int, depth: int,
                    width: int) -> List[Call]:
    """The window-attention calls of one Swin U-Net forward: every block
    of the encoder levels, the bottom and the decoder levels; odd
    positions are shifted (masked) where a level holds more than one
    window."""
    heads = list(heads)
    calls = []
    for level in list(range(depth)) + [depth] + list(range(depth - 1, -1,
                                                           -1)):
        res = (img_size // patch) // 2 ** level
        win = min(window, res)
        channels = embed * 2 ** level
        for j in range(width):
            calls.append(Call(batch, (res // win) ** 2, heads[level],
                              win * win, channels // heads[level],
                              bool(j % 2) and res > window))
    return calls


def _bound_s(calls: Iterable[Call], dtype: str, backward: bool) -> float:
    elem = 2 if dtype == "bfloat16" else 4
    total = 0.0
    for c in calls:
        qkv = c.batch * c.windows * c.heads * c.tokens * c.head_dim
        table = c.heads * c.tokens * c.tokens * 4
        mask = c.windows * c.tokens * c.tokens * 4 if c.masked else 0
        pairs = c.batch * c.windows * c.heads * c.tokens * c.tokens \
            * c.head_dim
        if backward:
            moved, ops = 7 * qkv * elem + 2 * table + mask, 10 * pairs
        else:
            moved, ops = 4 * qkv * elem + table + mask, 4 * pairs
        total += max(moved / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype])
    return total


def forward_bound_s(calls: List[Call], dtype: str) -> float:
    """Seconds: the least time of K1 over *calls*."""
    return _bound_s(calls, dtype, False)


def backward_bound_s(calls: List[Call], dtype: str) -> float:
    """Seconds: the least time of K1's backward over *calls*."""
    return _bound_s(calls, dtype, True)
