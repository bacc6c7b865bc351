"""Parameter initialisers and weight-init schemes, with explicit generators.

The port of ``models/init.py`` together with the flax defaults of the
port's layers: flax's ``lecun_normal`` for Dense and Conv kernels, timm's
``trunc_normal_`` for the relative-position-bias tables, zeros and ones for
biases and norm scales; and the named scheme zoo (glorot/he uniform/normal,
constant, fix uniform/normal, default, the ``torch.nn.init.*`` aliases)
that :func:`apply_init` applies per layer type with an ``otherwise``
fallback.  Every sampler takes a ``torch.Generator``, so a model made from
one seed is the same model every time.  The values are not those JAX draws
from the same seed: threefry and Philox differ, and tests that compare the
two packages transplant weights instead.

Layer types are recognised as the JAX package recognises its leaves: a
parameter ``weight`` of rank 4 is a conv kernel (fans from the torch
layout (out, in, kh, kw)), of rank 2 a dense kernel (out, in), of rank 1 a
norm scale.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..config import ConfigDict

__all__ = ["trunc_normal_", "lecun_normal_", "init_module", "INIT_SCHEMES",
           "make_sampler", "apply_init", "init_spec_defaults"]


@torch.no_grad()
def trunc_normal_(tensor: torch.Tensor, std: float = 0.02, mean: float = 0.0,
                  a: float = -2.0, b: float = 2.0,
                  generator: Optional[torch.Generator] = None):
    """timm ``trunc_normal_``: a normal(mean, std) cut at the *absolute*
    bounds a and b (for std 0.02 that is +/-100 sigma, effectively uncut),
    sampled by inverting the CDF of a uniform draw."""
    cdf = lambda x: (1.0 + math.erf(x / math.sqrt(2.0))) / 2.0  # noqa: E731
    lo, hi = cdf((a - mean) / std), cdf((b - mean) / std)
    tensor.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
    tensor.erfinv_().mul_(std * math.sqrt(2.0)).add_(mean)
    return tensor.clamp_(min=a, max=b)


@torch.no_grad()
def lecun_normal_(tensor: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None):
    """flax's default kernel init: variance 1/fan_in, a normal truncated at
    two standard deviations and rescaled to keep that variance."""
    std = math.sqrt(1.0 / max(fan_in, 1)) / 0.87962566103423978
    return trunc_normal_(tensor, std=std, a=-2 * std, b=2 * std,
                         generator=generator)


def init_module(module: nn.Module,
                generator: Optional[torch.Generator] = None) -> nn.Module:
    """Re-initialise every layer of *module* that has a
    ``reset_parameters(generator)`` method, in module order."""
    for sub in module.modules():
        reset = getattr(sub, "reset_parameters", None)
        if reset is not None:
            reset(generator)
    return module


# ---------------------------------------------------------------------------
# the scheme zoo: factories of ``sampler(generator, shape) -> tensor``
# (None: leave the parameter as it is)
# ---------------------------------------------------------------------------

def _fans(shape) -> Tuple[float, float]:
    """fan_in / fan_out of (out, in, kh, kw) conv and (out, in) dense
    weights."""
    if len(shape) < 2:
        return 1.0, 1.0
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def _variance_sampler(scale: float, mode: str, distribution: str) -> Callable:
    def sample(generator, shape):
        fan_in, fan_out = _fans(shape)
        denom = {"fan_in": fan_in, "fan_out": fan_out,
                 "fan_avg": (fan_in + fan_out) / 2.0}[mode]
        variance = scale / max(denom, 1.0)
        if distribution == "normal":
            return torch.randn(shape, generator=generator) \
                * math.sqrt(variance)
        bound = math.sqrt(3.0 * variance)
        return torch.empty(shape).uniform_(-bound, bound, generator=generator)
    return sample


def _norm_mode(mode: Any) -> str:
    mode = str(mode).replace(" ", "_")
    return mode if mode.startswith("fan_") else f"fan_{mode}"


def _kaiming(distribution: str):
    def factory(a: float = 0.0, mode: str = "fan_in",
                nonlinearity: str = "relu", **_ignored):
        if nonlinearity == "relu":
            gain_sq = 2.0
        elif nonlinearity in ("leaky_relu", "leaky relu"):
            gain_sq = 2.0 / (1.0 + a ** 2)
        else:
            gain_sq = 1.0
        return _variance_sampler(gain_sq, _norm_mode(mode), distribution)
    return factory


def _xavier(distribution: str):
    def factory(gain: float = 1.0, **_ignored):
        return _variance_sampler(gain ** 2, "fan_avg", distribution)
    return factory


def _constant(value: float = 1.0, **_ignored):
    return lambda generator, shape: torch.full(shape, float(value))


def _uniform(a: float = 0.0, b: float = 1.0, **_ignored):
    return lambda generator, shape: torch.empty(shape).uniform_(
        a, b, generator=generator)


def _normal(mean: float = 0.0, std: float = 1.0, **_ignored):
    return lambda generator, shape: (
        mean + std * torch.randn(shape, generator=generator))


def _trunc_normal(mean: float = 0.0, std: float = 0.02, a: float = -2.0,
                  b: float = 2.0, **_ignored):
    """timm ``trunc_normal_`` semantics: a and b are absolute cutoffs."""
    def sample(generator, shape):
        if std <= 0:
            return torch.full(shape, float(mean))
        return trunc_normal_(torch.empty(shape), std=std, mean=mean, a=a, b=b,
                             generator=generator)
    return sample


def _keep(generator, shape):  # "torch default": leave as it is
    return None


#: scheme name -> (sampler factory, declarative argument spec)
INIT_SCHEMES: Dict[str, Tuple[Callable, dict]] = {
    "glorot uniform": (_xavier("uniform"), {"gain": {"default": 1.0}}),
    "glorot normal": (_xavier("normal"), {"gain": {"default": 1.0}}),
    "he uniform": (_kaiming("uniform"), {"mode": {"default": "fan in"}}),
    "he normal": (_kaiming("normal"), {"mode": {"default": "fan in"}}),
    "constant": (_constant, {"value": {"argument name": "value",
                                       "default": 1.0}}),
    "fix uniform": (_uniform, {"minium": {"argument name": "a",
                                          "default": 0.0},
                               "maximum": {"argument name": "b",
                                           "default": 1.0}}),
    "fix normal": (_normal, {"mean": {"default": 0.0},
                             "std": {"default": 1.0}}),
    "torch default": (lambda **kw: _keep, {}),
    "default": (lambda **kw: _keep, {}),
    # dotted aliases used verbatim by the shipped configs
    "torch.nn.init.kaiming_normal_": (_kaiming("normal"), {}),
    "torch.nn.init.kaiming_uniform_": (_kaiming("uniform"), {}),
    "torch.nn.init.xavier_normal_": (_xavier("normal"), {}),
    "torch.nn.init.xavier_uniform_": (_xavier("uniform"), {}),
    "torch.nn.init.constant_": (
        lambda val=0.0, **kw: _constant(value=val), {}),
    "torch.nn.init.normal_": (_normal, {}),
    "torch.nn.init.uniform_": (_uniform, {}),
    "timm.models.layers.trunc_normal_": (_trunc_normal, {}),
    "trunc normal": (_trunc_normal, {"mean": {"default": 0.0},
                                     "std": {"default": 0.02}}),
}


def init_spec_defaults(name: str) -> dict:
    return INIT_SCHEMES[name][1] if name in INIT_SCHEMES else {}


def make_sampler(config: Any) -> Tuple[Callable, float]:
    """Resolve a scheme config (a bare name or ``{name: {kwargs}}``) to
    ``(sampler, bias_fill_value)``."""
    if isinstance(config, str):
        name, params = config, ConfigDict()
    elif isinstance(config, ConfigDict):
        name, params = config.item()
        if not isinstance(params, ConfigDict):
            params = ConfigDict()
    else:
        raise TypeError(f"Cannot build init scheme from {config!r}")
    if name not in INIT_SCHEMES:
        raise KeyError(f"Unknown weight-init scheme {name!r}")
    factory, _spec = INIT_SCHEMES[name]
    kwargs = {k.replace(" ", "_"): v
              for k, v in params.trim().to_dict().items()}
    bias_fill = kwargs.pop("bias_init", 0.0)
    remap = {"value": "value", "minium": "a", "maximum": "b"}
    kwargs = {remap.get(k, k): v for k, v in kwargs.items()}
    return factory(**kwargs), bias_fill


#: layer-type name -> predicate on (flax leaf name, rank)
_LAYER_PREDICATES = {
    "torch.nn.Conv2d": lambda name, ndim: name == "kernel" and ndim == 4,
    "conv": lambda name, ndim: name == "kernel" and ndim == 4,
    "torch.nn.Linear": lambda name, ndim: name == "kernel" and ndim == 2,
    "linear": lambda name, ndim: name == "kernel" and ndim == 2,
    "dense": lambda name, ndim: name == "kernel" and ndim == 2,
    "torch.nn.LayerNorm": lambda name, ndim: name == "scale" and ndim == 1,
    "layer_norm": lambda name, ndim: name == "scale" and ndim == 1,
    "otherwise": lambda name, ndim: name == "kernel" and ndim >= 2,
}


def _flax_leaf(name: str, param: torch.Tensor) -> str:
    """The flax leaf name of a port parameter: ``weight`` is a ``kernel``
    (rank >= 2) or a norm ``scale`` (rank 1)."""
    if name != "weight":
        return name
    return "kernel" if param.ndim >= 2 else "scale"


def _resolve_sampler(sub, layer_name=None):
    # a *list* of schemes per layer type is tried in order until one
    # resolves; for kernel leaves every parametric scheme applies
    if isinstance(sub, (list, tuple)):
        last_exc = None
        for element in sub:
            try:
                return make_sampler(element)
            except (KeyError, TypeError) as exc:
                last_exc = exc
        raise last_exc or KeyError(
            f"No resolvable scheme in list for {layer_name!r}")
    if isinstance(sub, (str, ConfigDict)):
        return make_sampler(sub)
    return make_sampler(ConfigDict({layer_name: {}}))


@torch.no_grad()
def apply_init(module: nn.Module, scheme_config: Any,
               generator: Optional[torch.Generator] = None) -> nn.Module:
    """Re-sample the kernels of *module* in place by a scheme config.

    *scheme_config* is one scheme (``{name: kwargs}`` or a bare name) or a
    per-layer-type table ``{'torch.nn.Conv2d': scheme, 'otherwise':
    scheme}``.  Matched kernels are drawn on the CPU from *generator*, in
    parameter order; the ``bias`` of each matched layer is filled with the
    scheme's ``bias_init`` (default 0).  Parameters no scheme matches (norm
    scales, PReLU slopes, ...) keep their constructor defaults."""
    table = []
    if isinstance(scheme_config, ConfigDict) and any(
            k in _LAYER_PREDICATES for k in scheme_config.keys()):
        items = sorted(scheme_config.items(),
                       key=lambda kv: kv[0] == "otherwise")  # otherwise last
        for layer_name, sub in items:
            pred = _LAYER_PREDICATES.get(layer_name)
            if pred is not None:
                table.append((pred, _resolve_sampler(sub, layer_name)))
    else:
        table.append((_LAYER_PREDICATES["otherwise"],
                      _resolve_sampler(scheme_config)))

    for layer in module.modules():
        own = dict(layer.named_parameters(recurse=False))
        bias_fill = None
        for name, param in own.items():
            for pred, (sampler, fill) in table:
                if pred(_flax_leaf(name, param), param.ndim):
                    sampled = sampler(generator, tuple(param.shape))
                    if sampled is not None:
                        param.copy_(sampled)
                        bias_fill = fill
                    break
        if bias_fill is not None and own.get("bias") is not None:
            own["bias"].fill_(bias_fill)
    return module
