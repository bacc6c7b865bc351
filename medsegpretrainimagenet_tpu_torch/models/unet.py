"""Configurable U-Net encoder / decoder / U-Net: the port of ``models/unet.py``.

A config-generic U-Net: stem / basic-block / down- / up-sampling / mixing
blocks are all pluggable components, with arbitrary channel ladders and
stochastic depth.  The Swin U-Net is this U-Net with PatchEmbed stem, Swin
blocks, PatchMerging / PatchExpand and ConcatLinear mixing.  Blocks run on
NHWC images or (B, L, C) token sequences.

Residual shortcuts, layer scaling and an external encoder (the ResNet
U-Nets) are not ported yet; asking for them raises NotImplementedError.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from ..config import ConfigDict, register
from ..config.registry import fill_spec, get_kwargs, resolve
from . import blocks as B
from .activations import make_activation

__all__ = ["UNetEncoder", "UNetDecoder", "UNet", "stoch_depth_probs"]


def stoch_depth_probs(depth: int, width: int, max_prob: float = 0.0,
                      min_prob: float = 0.0):
    """Linearly spaced stochastic-depth probabilities (swin_unet layout):
    ``(depth+1)*width`` values split into per-level down lists, the bottom
    list, and reversed up lists."""
    probs = np.linspace(min_prob, max_prob, (depth + 1) * width)
    down = [probs[i * width:(i + 1) * width] for i in range(depth)]
    bottom = probs[depth * width:(depth + 1) * width]
    up = [probs[(depth - 1 - i) * width:(depth - i) * width]
          for i in range(depth)]
    return down, bottom, up


def _as_channels(value, depth) -> list:
    if isinstance(value, ConfigDict):
        value = value.key()
    if value in (None, "default"):
        return [64 * 2 ** i for i in range(depth + 1)]
    return list(value)


def _normalize_block_cfg(cfg):
    if cfg is None:
        return None
    if isinstance(cfg, str):
        return ConfigDict({cfg: {}})
    if not isinstance(cfg, ConfigDict):
        return ConfigDict(dict(cfg))
    return cfg


def _make_mixing_builder(mixing_cfg):
    """Resolve a mixing-block config to ``(builder, get_out_ch)``."""
    mixing_cfg = _normalize_block_cfg(mixing_cfg)
    name, params = mixing_cfg.item()
    if not isinstance(params, ConfigDict):
        params = ConfigDict()
    constructor = resolve(name)
    fill_spec(mixing_cfg)
    base = get_kwargs(constructor, params)
    base = {k: v for k, v in base.items() if B.block_accepts(constructor, k)}

    def build(**channel_kwargs) -> nn.Module:
        kwargs = dict(base)
        for key, value in channel_kwargs.items():
            if B.block_accepts(constructor, key):
                kwargs[key] = value
        return constructor(**kwargs)

    def out_ch(**channel_kwargs) -> int:
        return B.mixing_out_channels(constructor, **channel_kwargs)

    return build, out_ch


def _not_ported(residual_connections, layer_scaling):
    if residual_connections or layer_scaling is not False:
        raise NotImplementedError(
            "residual connections and layer scaling are not ported yet")


class UNetEncoder(nn.Module):
    """General U-Net encoder: ``depth`` levels of ``width`` basic blocks
    with a downsampling block between levels (or stride-in-block when
    ``downsampling`` is None), plus a bottom level.  ``forward`` optionally
    returns the per-level skip tensors.  Registered on its own as
    ``segmentation.models.UNet_encoder``, the first layer of the
    pretraining ``FeedForwardModel``."""

    PARAMS = {
        "in_channel_size": 3,
        "basic_block": "segmentation.models.blocks.ConvBlock",
        "stem": {"torch.nn.Conv2d": {"kernel_size": 3, "padding": "same"}},
        "downsampling": {"torch.nn.MaxPool2d": {"kernel_size": 2}},
        "depth": 4,
        "width": 1,
        "channels": "default",
        "residual_connections": False,
        "change_channel_in_block": True,
        "trainable_downsampling": False,
        "stochastic_depth_rate": 0.0,
        "layer_scaling": False,
    }

    @staticmethod
    def fill_kwargs(config_dict: ConfigDict):
        for key in ("basic_block", "downsampling", "stem"):
            value = config_dict.get(key)
            if isinstance(value, str):
                config_dict[key] = ConfigDict({value: {}})
            if isinstance(config_dict.get(key), ConfigDict):
                fill_spec(config_dict[key])

    def __init__(self, in_channel_size: int = 3,
                 basic_block: Any = "segmentation.models.blocks.ConvBlock",
                 stem: Any = "default_stem",
                 downsampling: Any = "default_downsampling", depth: int = 4,
                 width: int = 1, channels: Any = "default",
                 residual_connections: Any = False,
                 change_channel_in_block: bool = True,
                 trainable_downsampling: bool = False,
                 stochastic_depth_rate: float = 0.0,
                 layer_scaling: Any = False):
        super().__init__()
        _not_ported(residual_connections, layer_scaling)
        self.depth, self.in_channel_size = depth, in_channel_size
        channels = _as_channels(channels, depth)
        if len(channels) < depth + 2:
            channels = [channels[0], *channels]
        ccib = change_channel_in_block
        stem_cfg = _normalize_block_cfg(
            None if stem is None else (
                ConfigDict({"torch.nn.Conv2d":
                            {"kernel_size": 3, "padding": "same"}})
                if stem == "default_stem" else stem))
        down_cfg = _normalize_block_cfg(
            ConfigDict({"torch.nn.MaxPool2d": {"kernel_size": 2}})
            if downsampling == "default_downsampling" else downsampling)
        self._integrated_downsample = down_cfg is None

        if stem_cfg is not None:
            self.stem_block = B.make_block_builder(stem_cfg)(
                in_channel_size, channels[0])
        else:
            self.stem_block = B.Identity()

        block_builder = B.make_block_builder(_normalize_block_cfg(
            basic_block))
        down_builder = None if down_cfg is None \
            else B.make_block_builder(down_cfg)
        down_probs, bottom_probs, _ = stoch_depth_probs(
            depth, width, stochastic_depth_rate or 0.0)

        self.level_convs = nn.ModuleList()
        self.downsamples = nn.ModuleList()
        for i in range(depth):
            convs = nn.ModuleList()
            for j in range(width):
                cin = channels[i + (not ccib)] if j == 0 else channels[i + 1]
                downs = self._integrated_downsample and j == width - 1
                convs.append(block_builder(
                    cin, channels[i + 1], downsample_in_block=downs,
                    position=j, stochastic_depth_rate=float(down_probs[i][j])))
            self.level_convs.append(convs)
            if down_builder is not None:
                out = channels[i + 1 + (not ccib)] if trainable_downsampling \
                    else channels[i + 1]
                self.downsamples.append(down_builder(channels[i + 1], out))

        self.bottom_convs = nn.ModuleList()
        for j in range(width):
            cin = channels[-2 + (not ccib)] if j == 0 else channels[-1]
            self.bottom_convs.append(block_builder(
                cin, channels[-1], downsample_in_block=False, position=j,
                stochastic_depth_rate=float(bottom_probs[j])))

    def forward(self, x: torch.Tensor, return_skip_vals: bool = False):
        skip_values = []
        x = self.stem_block(x)
        for i in range(self.depth):
            for conv in self.level_convs[i]:
                x = conv(x)
            skip_values.append(x)
            if not self._integrated_downsample:
                x = self.downsamples[i](x)
        for conv in self.bottom_convs:
            x = conv(x)
        if return_skip_vals:
            return x, skip_values
        return x


class UNetDecoder(nn.Module):
    """General U-Net decoder: per level an upsampling block, a mixing block
    with the skip value, and ``width`` basic blocks; then a final block."""

    def __init__(self,
                 basic_block: Any = "segmentation.models.blocks.ConvBlock",
                 upsampling_block: Any =
                 "segmentation.models.blocks.UpConvBlock",
                 mixing_block: Any = "concatenate",
                 residual_connections: Any = False,
                 stochastic_depth_rate: float = 0.0, output_ch: int = 1,
                 depth: int = 4, width: int = 1, channels: Any = None,
                 final_block: Any = None, layer_scaling: Any = False,
                 skip_con_channels_list: Any = None):
        super().__init__()
        _not_ported(residual_connections, layer_scaling)
        self.depth = depth
        channels = list(channels)
        skip_channels = list(skip_con_channels_list or [])
        self._skip_con_nr = len(skip_channels)

        block_builder = B.make_block_builder(_normalize_block_cfg(basic_block))
        ups_cfg = _normalize_block_cfg(upsampling_block)
        ups_builder = B.make_block_builder(ups_cfg)
        ratio = 0.5
        if isinstance(ups_cfg.value(), ConfigDict):
            ratio = ups_cfg.value().get("channel_decrease_ratio", 0.5)
        mix_builder, mix_out_ch = _make_mixing_builder(mixing_block)
        _, _, up_probs = stoch_depth_probs(depth, width,
                                           stochastic_depth_rate or 0.0)

        self.upsamples = nn.ModuleList()
        self.mixings = nn.ModuleList()
        self.level_convs = nn.ModuleList()
        for i in range(depth):
            ups_out = int(channels[i] * ratio)
            self.upsamples.append(ups_builder(channels[i], ups_out))
            ch_kwargs = dict(x_channels=channels[i], x_up_channels=ups_out,
                             skip_channels=skip_channels[i]
                             if i < self._skip_con_nr else 0,
                             level_out_channels=channels[i + 1])
            if i < self._skip_con_nr:
                self.mixings.append(mix_builder(**ch_kwargs))
                mixed_ch = mix_out_ch(**ch_kwargs)
            else:
                mixed_ch = ups_out
            convs = nn.ModuleList()
            for j in range(width):
                cin = mixed_ch if j == 0 else channels[i + 1]
                convs.append(block_builder(
                    cin, channels[i + 1], position=j,
                    stochastic_depth_rate=float(up_probs[i][j])))
            self.level_convs.append(convs)

        if final_block is not None:
            self.final = B.make_block_builder(_normalize_block_cfg(
                final_block))(channels[-1], output_ch)
        else:
            self.final = B.Identity()

    def forward(self, x: torch.Tensor, skip_values) -> torch.Tensor:
        skip_values = list(skip_values)
        for i in range(self.depth):
            x_up = self.upsamples[i](x)
            if i < self._skip_con_nr:
                x = self.mixings[i](x, x_up, skip_values.pop())
            else:
                x = x_up
            for conv in self.level_convs[i]:
                x = conv(x)
        return self.final(x)


class UNet(nn.Module):
    """Composable U-Net.  Decoder channels default to the reversed encoder
    ladder; skip-connection channels to the reversed non-bottom encoder
    channels."""

    PARAMS = {
        "architecture/in channel size": {"argument name": "img_ch",
                                         "default": 3},
        "architecture/out channel size": {"argument name": "output_ch",
                                          "default": 1},
        "architecture/depth": {"argument name": "depth", "default": 4},
        "architecture/width": {"argument name": "width", "default": 1},
        "architecture/basic block": {
            "argument name": "basic_block",
            "default": "segmentation.models.blocks.ConvBlock"},
        "architecture/mixing block": {"argument name": "mixing_block",
                                      "default": "concatenate"},
        "architecture/stem": {
            "argument name": "preproc_block",
            "default": {"torch.nn.Conv2d": {"kernel_size": 3,
                                            "padding": "same"}}},
        "architecture/final_block": {
            "argument name": "final_block",
            "default": {"torch.nn.Conv2d": {"kernel_size": 1}}},
        "architecture/upsampling": {
            "argument name": "upsampling_block",
            "default": "segmentation.models.blocks.UpConvBlock"},
        "architecture/downsampling": {
            "argument name": "downsampling_block",
            "default": {"torch.nn.MaxPool2d": {"kernel_size": 2}}},
        "architecture/channels": {"argument name": "channels",
                                  "default": "default"},
        "architecture/encoder_channels": {"argument name": "encoder_channels",
                                          "default": None},
        "architecture/decoder_channels": {"argument name": "decoder_channels",
                                          "default": None},
        "architecture/skip_con_channels": {
            "argument name": "skip_con_channels", "default": None},
        "architecture/residual_connections": {
            "argument name": "residual_connections", "default": False},
        "architecture/stochastic depth rate": {
            "argument name": "stochastic_depth_rate", "default": 0},
        "architecture/activation function/final": {
            "argument name": "final_activation", "default": "sigmoid"},
        "architecture/layer_scaling": {"argument name": "layer_scaling",
                                       "default": False},
        "architecture/change_channels_in_block": {
            "argument name": "change_channels_in_block", "default": True},
        "architecture/trainable_downsampling": {
            "argument name": "trainable_downsampling", "default": False},
        "architecture/encoder": {"argument name": "encoder", "default": None},
        "weight_init": {"torch.nn.init.kaiming_normal_":
                        {"nonlinearity": "relu"}},
    }

    @staticmethod
    def fill_kwargs(config_dict: ConfigDict):
        for key in ("architecture/basic block", "architecture/upsampling",
                    "architecture/downsampling", "architecture/stem",
                    "architecture/final_block"):
            value = config_dict.get(key)
            if isinstance(value, str):
                config_dict[key] = ConfigDict({value: {}})
            if isinstance(config_dict.get(key), ConfigDict):
                fill_spec(config_dict[key])

        mixing = config_dict["architecture/mixing block"]
        if isinstance(mixing, ConfigDict) and mixing.key() != "concatenate":
            fill_spec(mixing)

        if config_dict.get("architecture/encoder") is None:
            config_dict.pop("architecture/encoder", None)

    def __init__(self, img_ch: int = 3, output_ch: int = 1, depth: int = 4,
                 width: int = 1,
                 basic_block: Any = "segmentation.models.blocks.ConvBlock",
                 mixing_block: Any = "concatenate",
                 preproc_block: Any = "default_stem",
                 final_block: Any = "default_final",
                 upsampling_block: Any =
                 "segmentation.models.blocks.UpConvBlock",
                 downsampling_block: Any = "default_downsampling",
                 channels: Any = "default", encoder_channels: Any = None,
                 decoder_channels: Any = None, skip_con_channels: Any = None,
                 residual_connections: Any = False,
                 stochastic_depth_rate: float = 0.0,
                 final_activation: Any = "sigmoid",
                 layer_scaling: Any = False,
                 change_channels_in_block: bool = True,
                 trainable_downsampling: bool = False, encoder: Any = None):
        super().__init__()
        if encoder is not None:
            raise NotImplementedError(
                "U-Nets with an external encoder are not ported yet")
        _not_ported(residual_connections, layer_scaling)
        channels = _as_channels(channels, depth)
        enc_channels = channels if encoder_channels is None \
            else list(encoder_channels)
        dec_channels = channels[::-1] if decoder_channels is None \
            else [enc_channels[-1], *decoder_channels]
        skip_list = skip_con_channels or enc_channels[:-1][::-1]

        stem = None if preproc_block is None else (
            preproc_block if preproc_block != "default_stem"
            else ConfigDict({"torch.nn.Conv2d":
                             {"kernel_size": 3, "padding": "same"}}))
        down = downsampling_block \
            if downsampling_block != "default_downsampling" \
            else ConfigDict({"torch.nn.MaxPool2d": {"kernel_size": 2}})
        self.enc = UNetEncoder(
            in_channel_size=img_ch, basic_block=basic_block, stem=stem,
            downsampling=down, depth=len(enc_channels) - 1, width=width,
            channels=enc_channels,
            change_channel_in_block=change_channels_in_block,
            trainable_downsampling=trainable_downsampling,
            stochastic_depth_rate=stochastic_depth_rate)

        final = final_block if final_block != "default_final" \
            else ConfigDict({"torch.nn.Conv2d": {"kernel_size": 1}})
        self.dec = UNetDecoder(
            basic_block=basic_block, mixing_block=mixing_block,
            upsampling_block=upsampling_block,
            stochastic_depth_rate=stochastic_depth_rate,
            output_ch=output_ch, depth=len(dec_channels) - 1, width=width,
            skip_con_channels_list=skip_list, channels=dec_channels,
            final_block=final)
        self.final_act = None if final_activation is None \
            else make_activation(final_activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, skip_vals = self.enc(x, return_skip_vals=True)
        out = self.dec(x, skip_vals)
        if self.final_act is not None:
            out = self.final_act(out)
        return out


register("segmentation.models.UNet", "unet")(UNet)
register("segmentation.models.UNet_encoder", "unet_encoder")(UNetEncoder)
register("segmentation.models.UNet_decoder", "unet_decoder")(UNetDecoder)
