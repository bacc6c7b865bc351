"""The Swin U-Net (Swin-Unet, arXiv:2105.05537) as the config tree
arranges it: PatchEmbed, Swin blocks with shifted windows and relative
position bias, patch merging and expanding, the final X4 expansion, a 1x1
conv and a sigmoid; NHWC tokens, LayerNorm epsilon 1e-6, float32, every
product through :class:`~portbench.reference.ops.Ops`.  The parameters are
keyed by the port's state-dict names.  ``ckpt=True`` recomputes each block
in the backward, so that the float32 step at the timed batch fits beside
nothing else on the card."""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from portbench import bounds
from portbench.reference.ops import Ops, drop_path, gelu

__all__ = ["SwinShape", "shape_of", "forward", "drop_rates", "small",
           "attention_calls", "shift_mask", "relative_position_index"]

Params = Dict[str, torch.Tensor]
_BLOCK = "segmentation.models.blocks.SwinTransformerBlock"


@dataclass
class SwinShape:
    img_size: int
    patch: int
    embed: int
    heads: Sequence[int]
    window: int
    mlp_ratio: float
    depth: int
    width: int
    rate: float
    in_channels: int
    out_channels: int


def _arch(tree: dict) -> dict:
    return tree["model"]["segmentation.models.UNet"]["architecture"]


def shape_of(tree: dict) -> SwinShape:
    arch = _arch(tree)
    swin = (arch.get("basic_block") or arch.get("basic block"))[_BLOCK]
    return SwinShape(
        img_size=swin["img_size"], patch=swin["patch_size"],
        embed=swin["embed_dim"], heads=tuple(swin["num_heads_layers"]),
        window=swin["window_size"], mlp_ratio=swin["mlp_ratio"],
        depth=arch["depth"], width=arch["width"],
        rate=float(arch.get("stochastic depth rate", 0.0)),
        in_channels=arch["in_channel_size"],
        out_channels=arch["out_channel_size"])


def small(tree: dict) -> dict:
    """*tree* cut to embed 8, heads 2 and 4, window 4, depth 1, for 32 x
    32 images."""
    tree = copy.deepcopy(tree)
    arch = _arch(tree)
    arch.update(channels=[8, 16], depth=1)
    arch["basic_block"][_BLOCK].update(img_size=32, embed_dim=8,
                                       num_heads_layers=[2, 4],
                                       window_size=4)
    return tree


def attention_calls(s: SwinShape, batch: int) -> List[bounds.Call]:
    """The window-attention (K1) calls of one forward of *batch* images."""
    return bounds.attention_calls(batch, s.img_size, s.patch, s.embed,
                                  s.heads, s.window, s.depth, s.width)


def relative_position_index(window: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel + (window - 1)
    return rel[:, :, 0] * (2 * window - 1) + rel[:, :, 1]


def shift_mask(resolution: int, window: int, shift: int) -> np.ndarray:
    """(nW, N, N) additive mask of the shifted windows: -100 between
    tokens that came from different regions of the unshifted image."""
    region = np.zeros((resolution, resolution), np.float32)
    cuts = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    label = 0
    for rows in cuts:
        for cols in cuts:
            region[rows, cols] = label
            label += 1
    n_w = resolution // window
    win = region.reshape(n_w, window, n_w, window).transpose(0, 2, 1, 3) \
        .reshape(-1, window * window)
    return np.where(win[:, None, :] != win[:, :, None], -100.0,
                    0.0).astype(np.float32)


def _block_geometry(s: SwinShape, channels: int, position: int):
    level = int(np.log2(channels // s.embed))
    resolution = (s.img_size // s.patch) // 2 ** level
    window, shift = s.window, (position % 2) * (s.window // 2)
    if resolution <= window:
        window, shift = resolution, 0
    return level, resolution, window, shift


def _swin_block(ops: Ops, p: Params, name: str, x, s: SwinShape,
                position: int, keeps, rate: float):
    b, length, c = x.shape
    level, res, window, shift = _block_geometry(s, c, position)
    heads = s.heads[level]
    n = window * window
    shortcut = x
    h = ops.layer_norm(x, p[f"{name}.norm1.weight"], p[f"{name}.norm1.bias"])
    h = h.reshape(b, res, res, c)
    if shift:
        h = torch.roll(h, (-shift, -shift), dims=(1, 2))
    n_w = res // window
    win = h.reshape(b, n_w, window, n_w, window, c).permute(0, 1, 3, 2, 4, 5) \
        .reshape(-1, n, c)
    qkv = ops.linear(win, p[f"{name}.attn.qkv.weight"],
                     p[f"{name}.attn.qkv.bias"])
    q, k, v = qkv.reshape(-1, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    table = p[f"{name}.attn.relative_position_bias_table"]
    index = torch.as_tensor(relative_position_index(window).reshape(-1),
                            device=x.device)
    bias = table[index].reshape(n, n, heads).permute(2, 0, 1)
    mask = None
    if shift:
        mask = torch.as_tensor(shift_mask(res, window, shift),
                               device=x.device)
    att = ops.attention(q, k, v, bias, mask, (c // heads) ** -0.5)
    att = att.transpose(1, 2).reshape(-1, n, c)
    att = ops.linear(att, p[f"{name}.attn.proj.weight"],
                     p[f"{name}.attn.proj.bias"])
    h = att.reshape(b, n_w, n_w, window, window, c).permute(0, 1, 3, 2, 4, 5) \
        .reshape(b, res, res, c)
    if shift:
        h = torch.roll(h, (shift, shift), dims=(1, 2))
    x = shortcut + drop_path(h.reshape(b, length, c), keeps[0], rate)
    m = ops.layer_norm(x, p[f"{name}.norm2.weight"], p[f"{name}.norm2.bias"])
    m = gelu(ops.linear(m, p[f"{name}.mlp.Dense_0.weight"],
                        p[f"{name}.mlp.Dense_0.bias"]))
    m = ops.linear(m, p[f"{name}.mlp.Dense_1.weight"],
                   p[f"{name}.mlp.Dense_1.bias"])
    return x + drop_path(m, keeps[1], rate)


def drop_rates(s: SwinShape) -> List[float]:
    """The stochastic-depth rate of every block in forward order (encoder
    levels, bottom, decoder levels): linearly spaced over the encoder's
    blocks, the decoder's mirrored."""
    probs = np.linspace(0.0, s.rate, (s.depth + 1) * s.width)
    down = list(probs[:s.depth * s.width])
    bottom = list(probs[s.depth * s.width:])
    up = [probs[(s.depth - 1 - i) * s.width + j]
          for i in range(s.depth) for j in range(s.width)]
    return [float(r) for r in down + bottom + up]


def _tokens_grid(length: int) -> int:
    side = int(round(length ** 0.5))
    return side


def forward(ops: Ops, p: Params, x, s: SwinShape, train: bool,
            keeps: Optional[list] = None, running=None, ckpt: bool = False):
    """(B, H, W, C) images in [0, 1] -> (B, H, W, out) probabilities.
    *keeps*: per block in forward order, the two drawn (B, 1, 1) keep
    masks of its branches, or (None, None); *running* is unused (no
    BatchNorm)."""
    rates = drop_rates(s)
    keeps = keeps or [(None, None)] * len(rates)
    blocks = iter(zip(keeps, rates))

    def run_block(name, h, position):
        pair, rate = next(blocks)

        def fn(h_, *masks):
            return _swin_block(ops, p, name, h_, s, position,
                               masks if masks else (None, None), rate)
        args = tuple(m for m in pair if m is not None)
        if ckpt:
            return checkpoint(fn, h, *args, use_reentrant=False)
        return fn(h, *args)

    h = ops.conv(x, p["enc.stem_block.Conv_0.weight"],
                 p["enc.stem_block.Conv_0.bias"], stride=s.patch, first=True)
    b, rows, cols, c = h.shape
    h = ops.layer_norm(h.reshape(b, rows * cols, c),
                       p["enc.stem_block.LayerNorm_0.weight"],
                       p["enc.stem_block.LayerNorm_0.bias"])
    skips = []
    for i in range(s.depth):
        for j in range(s.width):
            h = run_block(f"enc.level_convs.{i}.{j}", h, j)
        skips.append(h)
        b, length, c = h.shape
        side = _tokens_grid(length)
        g = h.reshape(b, side, side, c)
        g = torch.cat([g[:, 0::2, 0::2], g[:, 1::2, 0::2],
                       g[:, 0::2, 1::2], g[:, 1::2, 1::2]], dim=-1)
        g = g.reshape(b, -1, 4 * c)
        name = f"enc.downsamples.{i}"
        g = ops.layer_norm(g, p[f"{name}.LayerNorm_0.weight"],
                           p[f"{name}.LayerNorm_0.bias"])
        h = ops.linear(g, p[f"{name}.Dense_0.weight"])
    for j in range(s.width):
        h = run_block(f"enc.bottom_convs.{j}", h, j)
    for i in range(s.depth):
        name = f"dec.upsamples.{i}"
        b, length, c = h.shape
        side = _tokens_grid(length)
        u = ops.linear(h, p[f"{name}.Dense_0.weight"])
        c_out = u.shape[-1] // 4
        u = u.reshape(b, side, side, 2, 2, c_out).permute(0, 1, 3, 2, 4, 5) \
            .reshape(b, 4 * length, c_out)
        u = ops.layer_norm(u, p[f"{name}.LayerNorm_0.weight"],
                           p[f"{name}.LayerNorm_0.bias"])
        h = ops.linear(torch.cat([u, skips.pop()], dim=-1),
                       p[f"dec.mixings.{i}.Dense_0.weight"],
                       p[f"dec.mixings.{i}.Dense_0.bias"])
        for j in range(s.width):
            h = run_block(f"dec.level_convs.{i}.{j}", h, j)
    b, length, c = h.shape
    side = _tokens_grid(length)
    scale = s.patch
    f = ops.layer_norm(h, p["dec.final.LayerNorm_0.weight"],
                       p["dec.final.LayerNorm_0.bias"])
    f = ops.linear(f, p["dec.final.Dense_0.weight"])
    f = f.reshape(b, side, side, scale, scale, c).permute(0, 1, 3, 2, 4, 5) \
        .reshape(b, scale * scale * length, c)
    f = ops.layer_norm(f, p["dec.final.LayerNorm_1.weight"],
                       p["dec.final.LayerNorm_1.bias"])
    f = f.reshape(b, scale * side, scale * side, c)
    f = ops.conv(f, p["dec.final.Conv_0.weight"])
    return ops.output(torch.sigmoid(f))
