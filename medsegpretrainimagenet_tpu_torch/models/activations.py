"""Activation registry: the port of ``models/activations.py``.

Named activations with declarative argument specs, usable anywhere a config
names one; the channel axis is -1 (NHWC / (B, L, C)), as in the JAX
package.  PReLU carries its slope as a parameter ``alpha``, the name of the
flax leaf.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ConfigDict, register
from ..config.registry import get_kwargs, resolve

__all__ = ["Activation", "make_activation", "fill_activation_spec",
           "ACTIVATIONS"]


class Activation(nn.Module):
    """A named activation with optional kwargs; channel axis is -1."""

    def __init__(self, kind: str = "relu", negative_slope: float = 0.2,
                 prelu_init: float = 0.2):
        super().__init__()
        if kind not in ACTIVATIONS:
            raise ValueError(f"Unknown activation {kind!r}")
        self.kind = kind
        self.negative_slope = negative_slope
        self.prelu_init = prelu_init
        if kind == "prelu":
            self.alpha = nn.Parameter(torch.tensor(float(prelu_init)))

    def reset_parameters(self, generator=None):
        if self.kind == "prelu":
            nn.init.constant_(self.alpha, self.prelu_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kind = self.kind
        if kind == "relu":
            return F.relu(x)
        if kind == "sigmoid":
            return torch.sigmoid(x)
        if kind == "softmax":
            return torch.softmax(x, dim=-1)
        if kind == "leaky relu":
            return F.leaky_relu(x, self.negative_slope)
        if kind == "gelu":
            # exact (erf) form, as flax's gelu(approximate=False)
            return F.gelu(x)
        if kind == "linear":
            return x
        if kind == "prelu":
            # the float32 slope is cast to the activations' dtype, so a
            # bf16 path stays bf16
            return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)
        if kind == "tanh":
            return torch.tanh(x)
        return F.silu(x)


#: declarative specs, the JAX package's table
ACTIVATIONS = {
    "relu": {},
    "sigmoid": {},
    "softmax": {},
    "gelu": {},
    "linear": {},
    "tanh": {},
    "silu": {},
    "prelu": {
        "initial negative slope": {"argument name": "prelu_init",
                                   "default": 0.2},
    },
    "leaky relu": {
        "negative slope": {"argument name": "negative_slope",
                           "default": 0.2},
    },
}


def make_activation(config: Any, default: str = "relu") -> nn.Module:
    """Build an activation from a bare name, a ``{name: {kwargs}}``
    ConfigDict, or None (*default*).  Names outside :data:`ACTIVATIONS`
    resolve through the component registry."""
    if config is None:
        config = default
    if isinstance(config, dict) and not isinstance(config, ConfigDict):
        config = ConfigDict(config)
    if isinstance(config, str):
        name, params = config, ConfigDict()
    elif isinstance(config, ConfigDict):
        name, params = config.item()
        if not isinstance(params, ConfigDict):
            params = ConfigDict()
    else:
        raise TypeError(f"Cannot build activation from {config!r}")
    # the framework-wide space/underscore key equivalence
    if name not in ACTIVATIONS and name.replace("_", " ") in ACTIVATIONS:
        name = name.replace("_", " ")
    if name in ACTIVATIONS:
        kwargs = {}
        for key, entry in ACTIVATIONS[name].items():
            kwargs[entry["argument name"]] = params.get(key, entry["default"])
        return Activation(kind=name, **kwargs)
    constructor = resolve(name)
    return constructor(**get_kwargs(constructor, params))


def fill_activation_spec(config_dict: ConfigDict, key: str) -> None:
    """fill_kwargs helper: inject activation argument defaults in place."""
    if not config_dict.has(key):
        return
    value = config_dict[key]
    if isinstance(value, str):
        return
    name, params = value.item()
    if name in ACTIVATIONS and isinstance(params, ConfigDict):
        params.fill_with_defaults(ACTIVATIONS[name])


register("model.Activation")(Activation)
