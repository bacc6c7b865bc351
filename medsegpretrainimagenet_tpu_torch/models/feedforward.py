"""Sequential compound models: the port of ``models/feedforward.py``.

``FeedForwardModel`` chains a list of config-built layers; it is the
pretraining classifier of the pretraining configs: ``encoder ->
AdaptiveAvgPool2d -> Flatten -> Linear``.  The layers are an
``nn.ModuleList`` named ``layers``, so the encoder's parameters sit under
``layers.0.``, the prefix of the JAX package's checkpoints (``layers_0``,
through ``transfer.state_dict_from_jax``) and of the reference's released
ones.  Layers without parameters keep their index, so the head's Linear is
``layers.3``.  The downstream U-Net's encoder transfer reads that first
subtree (``train/checkpoint.py``).
"""
from __future__ import annotations

from typing import Any, List

import torch
from torch import nn

from ..config import ConfigDict, register
from ..config.registry import fill_spec, get_kwargs, resolve
from .blocks import block_accepts
from .init import init_spec_defaults

__all__ = ["CompoundModel", "FeedForwardModel", "build_layer"]


def _normalize_layers(layers) -> List[ConfigDict]:
    if layers is None:
        return []
    if not isinstance(layers, (tuple, list)):
        layers = [layers]
    out = []
    for layer in layers:
        if isinstance(layer, str):
            layer = ConfigDict({layer: {}})
        elif isinstance(layer, dict) and not isinstance(layer, ConfigDict):
            layer = ConfigDict(layer)
        out.append(layer)
    return out


def build_layer(layer_cfg: ConfigDict) -> nn.Module:
    """Instantiate one layer module from its ``{name: params}`` config."""
    name, params = layer_cfg.item()
    if not isinstance(params, ConfigDict):
        params = ConfigDict()
    constructor = resolve(name)
    kwargs = get_kwargs(constructor, params)
    kwargs = {k: v for k, v in kwargs.items()
              if block_accepts(constructor, k)
              and k not in ("weight_initialisation",)}
    return constructor(**kwargs)


def _fill_layers(config_dict: ConfigDict, key: str) -> None:
    for layer_dict in config_dict.elements_of(key):
        fill_spec(layer_dict)
        if "weight initialisation" in layer_dict.value():
            init_cfg = layer_dict.value()["weight initialisation"]
            if isinstance(init_cfg, ConfigDict) and len(init_cfg) == 1:
                name, params = init_cfg.item()
                if isinstance(params, ConfigDict):
                    params.fill_with_defaults(init_spec_defaults(name))


@register("model.CompoundModel")
class CompoundModel(nn.Module):
    """Container building its layers from a list of layer configs."""

    PARAMS = {"submodels": {"argument name": "submodels", "default": None}}

    @staticmethod
    def fill_kwargs(config_dict: ConfigDict):
        _fill_layers(config_dict, "submodels" if "submodels" in config_dict
                     else "layers")

    def __init__(self, submodels: Any = None):
        super().__init__()
        self.layers = nn.ModuleList(
            build_layer(cfg) for cfg in _normalize_layers(submodels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


@register("model.FeedForwardModel", "feed_forward_model")
class FeedForwardModel(nn.Module):
    """Sequential chain of config-built layers (the reference's published
    forward fans one input into every layer, which its own pretraining
    configs could not run; the JAX package chains them, and so does the
    port)."""

    PARAMS = {"layers": {"argument name": "threads", "default": None}}

    @staticmethod
    def fill_kwargs(config_dict: ConfigDict):
        _fill_layers(config_dict, "threads" if "threads" in config_dict
                     else "layers")

    def __init__(self, threads: Any = None):
        super().__init__()
        self.layers = nn.ModuleList(
            build_layer(cfg) for cfg in _normalize_layers(threads))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x

    def encoder_features(self, x: torch.Tensor,
                         return_skip_vals: bool = True):
        """Run only the first layer (the encoder), with its skip outputs."""
        return self.layers[0](x, return_skip_vals=return_skip_vals)
