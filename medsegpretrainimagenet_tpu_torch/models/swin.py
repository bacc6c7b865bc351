"""Swin-Transformer blocks for the Swin U-Net on (B, L, C) token sequences.

The port of ``models/swin.py``: PatchEmbed / PatchMerging / PatchExpand /
FinalPatchExpand_X4, windowed multi-head attention with a
relative-position-bias table, and the W-MSA / SW-MSA SwinTransformerBlock
with cyclic shift and a precomputed additive mask.  The Swin U-Net itself
is the generic ``UNet`` configured with these blocks.

The relative-position index and the shift mask are computed with numpy when
a block is built and kept as non-persistent buffers, so checkpoints hold
parameters only.  The attention core is ``ops.window_attention_core``: the
hand-written CUDA kernel on the card, the plain PyTorch version on the CPU.
Under ``ops.set_fused_image_mode("on")`` (or "auto" for the no-grad bf16
forward on the card) a block takes the image-layout path instead,
``WindowAttention.attend_image``: the qkv projection in image layout, then
one kernel (``ops.fused_image_window_attention``) for window partition,
head split, attention, head merge and window reverse.  Both paths share
the same parameters.  The mode is off by default, as in the JAX package.

A module in training passes ``train=True`` to the attention dispatch (the
JAX package's ``train`` flag); on the card training takes the forward
kernel and its backward kernel (``ops.window_attention_core``: the
registered operators ``medseg_torch::window_attention`` and
``::window_attention_backward``, or K2's under the image layout), as
inference takes the forward kernel.  Attention dropout runs the plain
version (the kernel has no dropout).  Every draw (dropout, attention dropout,
stochastic depth) comes from the module's ``generator``, which the train
step sets (``blocks.Stochastic``).

Under spatial sharding (``parallel.spatial``) a token sequence is a band of
``rows = cols / S`` rows of the square grid (``spatial.token_grid``): the
patch merge and expands and the blocks read that grid, a block's cyclic
shift crosses the bands along the height (``spatial.roll_rows``), and its
shift mask is cut to the band's windows.  A block whose windows do not lie
inside the bands (``fits_bands``) runs on the whole image, which the U-Net
gathers before its level (``models.unet``).
"""
from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import register
from ..parallel import spatial
from ..ops import (fused_image_window_attention, use_fused_image,
                   window_attention_core)
from ..ops.window_attention import _logits
from . import blocks as B
from .activations import make_activation
from .init import trunc_normal_

__all__ = [
    "PatchEmbed", "PatchMerging", "PatchExpand", "FinalPatchExpand_X4",
    "Mlp", "WindowAttention", "SwinTransformerBlock",
    "DoubleSwinTransformerBlock", "window_partition", "window_reverse",
]


def window_partition(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, window_size, window_size, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window_size, window_size,
                  w // window_size, window_size, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(
        -1, window_size, window_size, c)


def window_reverse(windows: torch.Tensor, window_size: int,
                   h: int, w: int) -> torch.Tensor:
    """(B * nW, window_size, window_size, C) -> (B, H, W, C)."""
    b = windows.shape[0] // ((h // window_size) * (w // window_size))
    x = windows.reshape(b, h // window_size, w // window_size,
                        window_size, window_size, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


@register("segmentation.models.blocks.PatchEmbed", "patch_embed")
class PatchEmbed(B.Stochastic, nn.Module):
    """Conv stride=patch -> (B, L, C) tokens -> LN -> dropout."""

    PARAMS = {"patch_size": 4, "bias": True, "dilation": 1, "groups": 1,
              "drop_rate": 0.0}
    RATES = ("drop_rate",)

    def __init__(self, in_channels: int = 3, out_channels: int = 96,
                 patch_size: int = 4, bias: bool = True, dilation: int = 1,
                 groups: int = 1, drop_rate: float = 0.0):
        super().__init__()
        self.drop_rate, self.patch_size = drop_rate, patch_size
        self.Conv_0 = B.Conv(in_channels, out_channels, patch_size,
                             stride=patch_size, use_bias=bias,
                             dilation=dilation, groups=groups)
        self.LayerNorm_0 = B.make_layer_norm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(x)
        b, h, w, c = x.shape
        x = self.LayerNorm_0(x.reshape(b, h * w, c))
        return B.dropout(x, self.drop_rate, self.training, self.generator)


@register("segmentation.models.blocks.PatchMerging", "patch_merging")
class PatchMerging(nn.Module):
    """2x2 token gather -> LN(4C) -> Linear 4C->2C."""

    PARAMS = {"norm_layer": "torch.nn.LayerNorm"}

    def __init__(self, in_channels: int = 0, out_channels: int = 0,
                 norm_layer: Any = "torch.nn.LayerNorm"):
        super().__init__()
        if 2 * in_channels != out_channels:
            raise ValueError(f"PatchMerging needs out=2*in, got "
                             f"({in_channels}, {out_channels})")
        self.LayerNorm_0 = B.make_layer_norm(4 * in_channels)
        self.Dense_0 = B.Dense(4 * in_channels, 2 * in_channels,
                               use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, length, c = x.shape
        x = x.reshape(b, *spatial.token_grid(length), c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        x = x.reshape(b, -1, 4 * c)
        return self.Dense_0(self.LayerNorm_0(x))


@register("segmentation.models.blocks.PatchExpand", "patch_expand")
class PatchExpand(nn.Module):
    """Linear C->2C -> 2x2 pixel-shuffle -> LN(C/2)."""

    PARAMS = {"dim_scale": 2, "norm_layer": "torch.nn.LayerNorm"}

    def __init__(self, in_channels: int = 0, out_channels: int = 0,
                 dim_scale: int = 2, norm_layer: Any = "torch.nn.LayerNorm",
                 channel_decrease_ratio: float = 0.5):
        super().__init__()
        if in_channels != 2 * out_channels:
            raise ValueError(f"PatchExpand needs in=2*out, got "
                             f"({in_channels}, {out_channels})")
        self.dim_scale = dim_scale
        c = in_channels
        if dim_scale == 2:
            self.Dense_0 = B.Dense(in_channels, 2 * in_channels,
                                   use_bias=False)
            c = 2 * in_channels
        self.LayerNorm_0 = B.make_layer_norm(c // 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, length, _ = x.shape
        rows, cols = spatial.token_grid(length)
        if self.dim_scale == 2:
            x = self.Dense_0(x)
        c_out = x.shape[-1] // 4
        # b (h w) (p1 p2 c) -> b (h p1 w p2) c
        x = x.reshape(b, rows, cols, 2, 2, c_out)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, 4 * length, c_out)
        return self.LayerNorm_0(x)


@register("segmentation.models.blocks.FinalPatchExpand_X4",
          "final_patch_expand_x4")
class FinalPatchExpand_X4(nn.Module):
    """x4 pixel-shuffle expand + 1x1 conv head; tokens -> NHWC image."""

    PARAMS = {"dim_scale": 4, "norm_layer": "torch.nn.LayerNorm"}

    def __init__(self, in_channels: int = 0, out_channels: int = 0,
                 dim_scale: int = 4, norm_layer: Any = "torch.nn.LayerNorm"):
        super().__init__()
        s, c = dim_scale, in_channels
        self.dim_scale = s
        self.LayerNorm_0 = B.make_layer_norm(c)               # init_norm
        self.Dense_0 = B.Dense(c, s * s * c, use_bias=False)  # expand
        self.LayerNorm_1 = B.make_layer_norm(c)
        self.Conv_0 = B.Conv(c, out_channels, 1, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.dim_scale
        b, length, c = x.shape
        rows, cols = spatial.token_grid(length)
        x = self.Dense_0(self.LayerNorm_0(x))
        x = x.reshape(b, rows, cols, s, s, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, s * rows * s * cols, c)
        x = self.LayerNorm_1(x).reshape(b, s * rows, s * cols, c)
        return self.Conv_0(x)


@register("segmentation.models.blocks.Mlp", "swin_mlp")
class Mlp(B.Stochastic, nn.Module):
    """Dense -> act -> drop -> Dense -> drop."""

    RATES = ("drop",)

    def __init__(self, in_features: int = 0,
                 hidden_features: Optional[int] = None,
                 out_features: Optional[int] = None,
                 activations: Any = "gelu", drop: float = 0.0):
        super().__init__()
        hidden = hidden_features or in_features
        out = out_features or in_features
        self.drop = drop
        self.Dense_0 = B.Dense(in_features, hidden)
        self.act = make_activation(activations)
        self.Dense_1 = B.Dense(hidden, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = B.dropout(self.act(self.Dense_0(x)), self.drop, self.training,
                      self.generator)
        return B.dropout(self.Dense_1(x), self.drop, self.training,
                         self.generator)


def _relative_position_index(ws: Tuple[int, int]) -> np.ndarray:
    """Static (Wh*Ww, Wh*Ww) index into the (2Wh-1)(2Ww-1) bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws[0]), np.arange(ws[1]),
                                  indexing="ij"))          # 2, Wh, Ww
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]              # 2, N, N
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += ws[0] - 1
    rel[:, :, 1] += ws[1] - 1
    rel[:, :, 0] *= 2 * ws[1] - 1
    return rel.sum(-1)


@register("segmentation.models.blocks.WindowAttention", "window_attention")
class WindowAttention(B.Stochastic, nn.Module):
    """Windowed MHSA with relative position bias.  Input: (num_windows * B,
    N, C)."""

    RATES = ("attn_drop", "proj_drop")

    def __init__(self, dim: int = 0, window_size: Tuple[int, int] = (7, 7),
                 num_heads: int = 1, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, attn_drop: float = 0.0,
                 proj_drop: float = 0.0):
        super().__init__()
        if dim <= 0:
            raise ValueError("WindowAttention needs dim set")
        ws = tuple(window_size)
        self.window_size, self.num_heads = ws, num_heads
        self.qk_scale, self.attn_drop, self.proj_drop = \
            qk_scale, attn_drop, proj_drop
        self.qkv = B.Dense(dim, 3 * dim, use_bias=qkv_bias)
        self.proj = B.Dense(dim, dim)
        self.relative_position_bias_table = nn.Parameter(torch.empty(
            (2 * ws[0] - 1) * (2 * ws[1] - 1), num_heads))
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(_relative_position_index(ws).reshape(-1)),
            persistent=False)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        trunc_normal_(self.relative_position_bias_table, std=0.02,
                      generator=generator)

    def _bias(self) -> torch.Tensor:
        n = self.window_size[0] * self.window_size[1]
        return self.relative_position_bias_table[
            self.relative_position_index].reshape(
                n, n, self.num_heads).permute(2, 0, 1).contiguous()

    def _scale(self, head_dim: int) -> float:
        return self.qk_scale or head_dim ** -0.5

    def _dropout(self, x: torch.Tensor, rate: float,
                 windows: Optional[int]) -> torch.Tensor:
        """Dropout on a windows-layout tensor: its dim 0 read as (batch,
        *windows* an image), so that on a band of rows the mask is drawn at
        the whole image's windows and cut to the band's
        (``spatial.draw_uniform``)."""
        if not windows:
            return B.dropout(x, rate, self.training, self.generator)
        return B.dropout(x.reshape(-1, windows, *x.shape[1:]), rate,
                         self.training, self.generator).reshape(x.shape)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                windows: Optional[int] = None) -> torch.Tensor:
        """*x*: (B_, N, C) windows, B_ = batch * *windows* (the windows of
        an image, or of a band of rows; needed for the draws on a band)."""
        b_, n, c = x.shape
        heads = self.num_heads
        head_dim = c // heads
        scale = self._scale(head_dim)
        bias = self._bias()

        qkv = self.qkv(x).reshape(b_, n, 3, heads, head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).contiguous()   # (B_, H, N, D)

        if self.attn_drop and self.training:
            # dropout on the softmaxed probabilities, which the kernel
            # cannot do: attention-dropout training takes the plain path
            probs = torch.softmax(_logits(q, k, bias, mask, scale), dim=-1)
            probs = self._dropout(probs, self.attn_drop, windows)
            x = torch.matmul(probs.to(v.dtype).float(), v.float()) \
                .to(v.dtype)
        else:
            x = window_attention_core(q, k, v, bias, mask, scale,
                                      train=self.training)
        x = x.transpose(1, 2).reshape(b_, n, c)
        return self._dropout(self.proj(x), self.proj_drop, windows)

    def attend_image(self, x: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Image-layout forward: (B, Rh, Rw, C) -> (B, Rh, Rw, C), a square
        image or a band of its rows.  The qkv and proj projections are
        pointwise over tokens, so they apply in image layout; what lies
        between them is one kernel.  The same parameters and the same
        values as :meth:`forward` on partitioned windows."""
        c = x.shape[-1]
        out = fused_image_window_attention(
            self.qkv(x), self._bias(), mask, self._scale(c // self.num_heads),
            self.window_size[0], train=self.training)
        return B.dropout(self.proj(out), self.proj_drop, self.training,
                         self.generator)


def _shift_attn_mask(resolution: Tuple[int, int], window_size: int,
                     shift_size: int) -> np.ndarray:
    """Static (nW, N, N) additive mask for SW-MSA."""
    h, w = resolution
    img_mask = np.zeros((1, h, w, 1), np.float32)
    slices = (slice(0, -window_size),
              slice(-window_size, -shift_size),
              slice(-shift_size, None))
    cnt = 0
    for hs in slices:
        for ws_ in slices:
            img_mask[:, hs, ws_, :] = cnt
            cnt += 1
    mw = img_mask.reshape(1, h // window_size, window_size,
                          w // window_size, window_size, 1)
    mw = mw.transpose(0, 1, 3, 2, 4, 5).reshape(-1, window_size * window_size)
    attn_mask = mw[:, None, :] - mw[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


@register("segmentation.models.blocks.SwinTransformerBlock",
          "swin_transformer_block")
class SwinTransformerBlock(B.Stochastic, nn.Module):
    """W-MSA / SW-MSA block.

    The level index is recovered from the channel count
    (``i = log2(C / embed_dim)``), so the block drops into the generic
    U-Net as a ``basic_block``; ``position`` selects W-MSA (even) or
    SW-MSA (odd).
    """

    PARAMS = {
        "img_size": 224,
        "patch_size": 4,
        "num_heads_layers": (3, 6, 12, 24),
        "activations": "gelu",
        "embed_dim": 96,
        "window_size": 7,
        "mlp_ratio": 4.0,
        "qkv_bias": True,
        "qk_scale": None,
        "drop": 0.0,
        "attn_drop": 0.0,
        "norm_layer": "torch.nn.LayerNorm",
    }
    RATES = ("stochastic_depth_rate",)

    def __init__(self, in_channels: int = 96,
                 out_channels: Optional[int] = None, img_size: int = 224,
                 patch_size: int = 4,
                 num_heads_layers: Any = (3, 6, 12, 24),
                 activations: Any = "gelu", embed_dim: int = 96,
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 drop: float = 0.0, attn_drop: float = 0.0,
                 norm_layer: Any = "torch.nn.LayerNorm", position: int = 0,
                 stochastic_depth_rate: float = 0.0):
        super().__init__()
        out = out_channels or in_channels
        if in_channels != out:
            raise ValueError(
                "Swin transformer block should not change channel size, "
                f"but got in {in_channels} and out {out}.")
        level, resolution, window, shift = self._geometry(
            in_channels, embed_dim, img_size, patch_size, window_size,
            position)
        self.resolution, self.window, self.shift = resolution, window, shift
        self.stochastic_depth_rate = stochastic_depth_rate

        heads = list(num_heads_layers)[level]
        self.norm1 = B.make_layer_norm(in_channels)
        self.attn = WindowAttention(
            dim=in_channels, window_size=(window, window), num_heads=heads,
            qkv_bias=qkv_bias, qk_scale=qk_scale, attn_drop=attn_drop,
            proj_drop=drop)
        self.norm2 = B.make_layer_norm(in_channels)
        self.mlp = Mlp(in_features=in_channels,
                       hidden_features=int(in_channels * mlp_ratio),
                       activations=activations, drop=drop)
        mask = _shift_attn_mask((resolution, resolution), window, shift) \
            if shift > 0 else None
        self.register_buffer(
            "attn_mask", None if mask is None else torch.from_numpy(mask),
            persistent=False)

    @staticmethod
    def _geometry(channels, embed_dim, img_size, patch_size, window_size,
                  position):
        """(level, resolution, window, shift) of a block: the level from
        the channel count, no partition and no shift once the resolution
        fits in one window."""
        level = int(math.log2(channels // embed_dim))
        resolution = (img_size // patch_size) // (2 ** level)
        window = window_size
        shift = (position % 2) * window // 2
        if resolution <= window:
            window, shift = resolution, 0
        return level, resolution, window, shift

    def fits_bands(self, size: int) -> bool:
        """Do this block's windows lie inside *size* bands of rows (spatial
        sharding)?  Each band must hold a whole number of window rows; a
        level of one window never splits."""
        return self.resolution % size == 0 \
            and (self.resolution // size) % self.window == 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        resolution, window, shift = self.resolution, self.window, self.shift
        b, length, c = x.shape
        rows, cols = spatial.token_grid(length)
        if cols != resolution:
            raise ValueError(f"wrong token count L={length} for resolution "
                             f"{resolution}")
        # on a band of rows: the band's windows of the shift mask (window
        # i * nWc + j of the grid is mask row i * nWc + j)
        mask = self.attn_mask if self.attn_mask is None \
            else spatial.band_part(self.attn_mask)

        shortcut = x
        x = self.norm1(x).reshape(b, rows, cols, c)
        if shift > 0:
            x = torch.roll(spatial.roll_rows(x, -shift), -shift, dims=2)
        if use_fused_image(self.training, B.compute_dtype() or torch.float32,
                           x.device) \
                and not (self.attn.attn_drop and self.training):
            # image-layout path: the cyclic shift stays outside the kernel
            x = self.attn.attend_image(x, mask=mask)
        else:
            windows = window_partition(x, window).reshape(
                -1, window * window, c)
            attn_windows = self.attn(
                windows, mask=mask,
                windows=(rows // window) * (cols // window))
            attn_windows = attn_windows.reshape(-1, window, window, c)
            x = window_reverse(attn_windows, window, rows, cols)
        if shift > 0:
            x = torch.roll(spatial.roll_rows(x, shift), shift, dims=2)
        x = x.reshape(b, length, c)

        rate, training = self.stochastic_depth_rate, self.training
        x = shortcut + B.drop_path(x, rate, training, self.generator)
        return x + B.drop_path(self.mlp(self.norm2(x)), rate, training,
                               self.generator)


@register("segmentation.models.blocks.DoubleSwinTransformerBlock",
          "double_swin_transformer_block")
class DoubleSwinTransformerBlock(nn.Module):
    """``depth`` stacked Swin blocks with alternating W-MSA / SW-MSA and a
    final LayerNorm at the deepest channel width."""

    def __init__(self, in_channels: int = 96,
                 out_channels: Optional[int] = None, img_size: int = 224,
                 patch_size: int = 4, depth: int = 2,
                 num_heads_layers: Any = (3, 6, 12, 24),
                 activations: Any = "gelu", embed_dim: int = 96,
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 dropout_rate: float = 0.0, dropout_att_rate: float = 0.0,
                 stochastic_depth_rate: Any = 0.0):
        super().__init__()
        out = out_channels or in_channels
        if in_channels != out:
            raise ValueError(f"in_channels and out_channels are not equal "
                             f"({in_channels}, {out})")
        rates = stochastic_depth_rate
        if not isinstance(rates, (list, tuple)):
            rates = [rates] * depth
        self.swin_blocks = nn.ModuleList(SwinTransformerBlock(
            in_channels=in_channels, img_size=img_size,
            patch_size=patch_size, num_heads_layers=num_heads_layers,
            activations=activations, embed_dim=embed_dim,
            window_size=window_size, mlp_ratio=mlp_ratio,
            qkv_bias=qkv_bias, qk_scale=qk_scale, drop=dropout_rate,
            attn_drop=dropout_att_rate, position=i,
            stochastic_depth_rate=float(rates[i])) for i in range(depth))
        heads = list(num_heads_layers)
        self.last_norm = B.make_layer_norm(out) \
            if embed_dim * 2 ** (len(heads) - 1) == out else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.swin_blocks:
            x = block(x)
        if self.last_norm is not None:
            x = self.last_norm(x)
        return x
