"""Configurable U-Net encoder / decoder / U-Net: the port of ``models/unet.py``.

A config-generic U-Net: stem / basic-block / down- / up-sampling / mixing
blocks are all pluggable components, with arbitrary channel ladders and
stochastic depth.  The Swin U-Net is this U-Net with PatchEmbed stem, Swin
blocks, PatchMerging / PatchExpand and ConcatLinear mixing; the ResNet-50
attention U-Net is this U-Net with an external encoder
(``architecture/encoder``: ``classification.models.DeepResNet``) and
``AttentionBlock`` mixing.  Blocks run on NHWC images or (B, L, C) token
sequences.  A basic block may carry a residual shortcut
(:class:`blocks.ResConnection`), a layer scale and, on the residual
branch, stochastic depth drawn from the train step's generator.
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


class _ResidualLevels(B.Stochastic):
    """The basic blocks of a U-Net half with their optional shortcuts and
    layer scales, kept in lists parallel to the blocks' (``*_shortcuts``,
    ``*_scales``; empty when off).  A block's output is scaled, then, with
    a shortcut, dropped per sample at its stochastic-depth rate and added
    to the shortcut of its input."""

    RATES = ("residual_drop_rate",)

    def _extras(self, shortcuts: nn.ModuleList, scales: nn.ModuleList,
                residual_connections, layer_scaling, cin: int, cout: int,
                downsampling: bool = False) -> None:
        if residual_connections:
            shortcuts.append(B.ResConnection(cin, cout, downsampling,
                                             residual_connections))
        if layer_scaling is not False:
            scales.append(B.LayerScale(n_channels=cout,
                                       init_value=float(layer_scaling)))

    def _run_block(self, x, conv, scales, shortcuts, j, prob):
        y = conv(x)
        if scales:
            y = scales[j](y)
        if shortcuts:
            if self.residual_drop_rate:
                y = B.drop_path(y, float(prob), self.training,
                                self.generator)
            return y + shortcuts[j](x)
        return y


class UNetEncoder(_ResidualLevels, nn.Module):
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
        self._down_probs, self._bottom_probs, _ = stoch_depth_probs(
            depth, width, stochastic_depth_rate or 0.0)
        self.residual_drop_rate = float(stochastic_depth_rate or 0.0) \
            if residual_connections else 0.0

        self.level_convs = nn.ModuleList()
        self.level_shortcuts = nn.ModuleList()
        self.level_scales = nn.ModuleList()
        self.downsamples = nn.ModuleList()
        for i in range(depth):
            convs, shortcuts, scales = (nn.ModuleList(), nn.ModuleList(),
                                        nn.ModuleList())
            for j in range(width):
                cin = channels[i + (not ccib)] if j == 0 else channels[i + 1]
                downs = self._integrated_downsample and j == width - 1
                convs.append(block_builder(
                    cin, channels[i + 1], downsample_in_block=downs,
                    position=j,
                    stochastic_depth_rate=float(self._down_probs[i][j])))
                self._extras(shortcuts, scales, residual_connections,
                             layer_scaling, cin, channels[i + 1], downs)
            self.level_convs.append(convs)
            self.level_shortcuts.append(shortcuts)
            self.level_scales.append(scales)
            if down_builder is not None:
                out = channels[i + 1 + (not ccib)] if trainable_downsampling \
                    else channels[i + 1]
                self.downsamples.append(down_builder(channels[i + 1], out))

        self.bottom_convs = nn.ModuleList()
        self.bottom_shortcuts = nn.ModuleList()
        self.bottom_scales = nn.ModuleList()
        for j in range(width):
            cin = channels[-2 + (not ccib)] if j == 0 else channels[-1]
            self.bottom_convs.append(block_builder(
                cin, channels[-1], downsample_in_block=False, position=j,
                stochastic_depth_rate=float(self._bottom_probs[j])))
            self._extras(self.bottom_shortcuts, self.bottom_scales,
                         residual_connections, layer_scaling, cin,
                         channels[-1])

    def forward(self, x: torch.Tensor, return_skip_vals: bool = False):
        skip_values = []
        x = self.stem_block(x)
        for i in range(self.depth):
            for j, conv in enumerate(self.level_convs[i]):
                x = self._run_block(x, conv, self.level_scales[i],
                                    self.level_shortcuts[i], j,
                                    self._down_probs[i][j])
            skip_values.append(x)
            if not self._integrated_downsample:
                x = self.downsamples[i](x)
        for j, conv in enumerate(self.bottom_convs):
            x = self._run_block(x, conv, self.bottom_scales,
                                self.bottom_shortcuts, j,
                                self._bottom_probs[j])
        if return_skip_vals:
            return x, skip_values
        return x


class UNetDecoder(_ResidualLevels, nn.Module):
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
        _, _, self._up_probs = stoch_depth_probs(
            depth, width, stochastic_depth_rate or 0.0)
        self.residual_drop_rate = float(stochastic_depth_rate or 0.0) \
            if residual_connections else 0.0

        self.upsamples = nn.ModuleList()
        self.mixings = nn.ModuleList()
        self.level_convs = nn.ModuleList()
        self.level_shortcuts = nn.ModuleList()
        self.level_scales = nn.ModuleList()
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
            convs, shortcuts, scales = (nn.ModuleList(), nn.ModuleList(),
                                        nn.ModuleList())
            for j in range(width):
                cin = mixed_ch if j == 0 else channels[i + 1]
                convs.append(block_builder(
                    cin, channels[i + 1], position=j,
                    stochastic_depth_rate=float(self._up_probs[i][j])))
                self._extras(shortcuts, scales, residual_connections,
                             layer_scaling, cin, channels[i + 1])
            self.level_convs.append(convs)
            self.level_shortcuts.append(shortcuts)
            self.level_scales.append(scales)

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
            for j, conv in enumerate(self.level_convs[i]):
                x = self._run_block(x, conv, self.level_scales[i],
                                    self.level_shortcuts[i], j,
                                    self._up_probs[i][j])
        return self.final(x)


def _is_identity(cfg) -> bool:
    return cfg == "identity" or (isinstance(cfg, ConfigDict)
                                 and cfg.key() == "identity")


def _fill_residual_connections(config_dict: ConfigDict, res_con) -> None:
    """``architecture/residual_connections`` as ``{down: ..., up: ...}``
    with the defaults filled: identity on both sides, the encoder's
    identity expanding by zeros where blocks change the channels, the
    decoder's contracting by adding channel groups, a conv shortcut's
    ``CONV_PARAMS``."""
    if isinstance(res_con, str):
        res_con = ConfigDict({res_con: {}})
    if len(res_con) == 1 and res_con.key() not in ("up", "down"):
        res_cons = ConfigDict({"down": res_con.copy().to_dict(),
                               "up": res_con.copy().to_dict()})
    else:
        res_cons = res_con
    down = res_cons.get_or_update("down", "identity")
    up = res_cons.get_or_update("up", "identity")
    res_cons.expand()
    if down and _is_identity(down) \
            and config_dict["architecture/change_channels_in_block"]:
        res_cons.get_or_update("down/identity/expand_method",
                               "fill_with_zeros")
    if up and _is_identity(up):
        res_cons.get_or_update("up/identity/contract_method", "add")
    for kw in ("down", "up"):
        sub = res_cons.get(kw)
        if sub and isinstance(sub, ConfigDict) \
                and sub.key() in ("conv", "convolution"):
            sub.value().fill_with_defaults(B.ResConnection.CONV_PARAMS)
    config_dict["architecture/residual_connections"] = res_cons


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

        res_con = config_dict["architecture/residual_connections"]
        if res_con:
            _fill_residual_connections(config_dict, res_con)

        if config_dict.get("architecture/encoder") is None:
            config_dict.pop("architecture/encoder", None)
        else:
            # the external encoder takes the image as it comes: no stem,
            # downsampling or channel options of the U-Net's own encoder,
            # and no shortcuts on its side
            for key in ("in_channel_size", "stem", "downsampling",
                        "trainable_downsampling", "change_channels_in_block"):
                config_dict.pop("architecture/" + key, None)
            if res_con:
                config_dict.pop("architecture/residual_connections/down",
                                None)
            fill_spec(config_dict["architecture/encoder"])

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
        channels = _as_channels(channels, depth)
        enc_cfg = _normalize_block_cfg(encoder)
        if enc_cfg is not None:
            # channel chain: the encoder's channel_sizes, else its class's
            # defaults (the skips are its stem's and levels' outputs)
            enc_channels = enc_cfg.value().get("channel_sizes")
            if enc_channels is None:
                enc_channels = resolve(enc_cfg.key()).DEFAULT_CHANNEL_SIZES
            enc_channels = list(enc_channels)
        else:
            enc_channels = channels if encoder_channels is None \
                else list(encoder_channels)
        dec_channels = channels[::-1] if decoder_channels is None \
            else [enc_channels[-1], *decoder_channels]
        skip_list = skip_con_channels or enc_channels[:-1][::-1]
        down_res = up_res = residual_connections or False
        if isinstance(residual_connections, ConfigDict) and (
                "down" in residual_connections or "up" in residual_connections):
            down_res = residual_connections.get("down", False)
            up_res = residual_connections.get("up", False)

        if enc_cfg is not None:
            constructor = resolve(enc_cfg.key())
            kwargs = get_kwargs(constructor, enc_cfg.value())
            self.enc = constructor(**{k: v for k, v in kwargs.items()
                                      if B.block_accepts(constructor, k)})
        else:
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
                channels=enc_channels, residual_connections=down_res,
                change_channel_in_block=change_channels_in_block,
                trainable_downsampling=trainable_downsampling,
                stochastic_depth_rate=stochastic_depth_rate,
                layer_scaling=layer_scaling)

        final = final_block if final_block != "default_final" \
            else ConfigDict({"torch.nn.Conv2d": {"kernel_size": 1}})
        self.dec = UNetDecoder(
            basic_block=basic_block, mixing_block=mixing_block,
            upsampling_block=upsampling_block, residual_connections=up_res,
            stochastic_depth_rate=stochastic_depth_rate,
            output_ch=output_ch, depth=len(dec_channels) - 1, width=width,
            skip_con_channels_list=skip_list, channels=dec_channels,
            final_block=final, layer_scaling=layer_scaling)
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
