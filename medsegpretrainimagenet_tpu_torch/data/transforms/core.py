"""Generic transform machinery (host-side, channels-last numpy).

The port's own copy of ``medsegpretrainimagenet_tpu/data/transforms/core.py``
(the reference's ``transform/transforms.py``): ``TransformWrapper``
(dict-in/dict-out with ``data_to_transform`` selection and k-datapoint
replication), ``ConvertToType``, ``Compose``, ``LambdaTransform`` (numpy
expression -> new keyword), ``RepeatChannels``, ``Mixup`` and axis-slice
``CutMix``.  The numpy draws are the JAX package's, so the same seed gives
the same batches.

Layout note: per-sample arrays are channels-last (H, W, C), as in the JAX
package, and ``RepeatChannels`` repeats the last axis.  Casting targets use
torch dtype names for YAML compatibility and produce the JAX package's
numpy dtypes (``torch.LongTensor`` -> int32), so the two packages assemble
equal batches.
"""
from __future__ import annotations

import builtins
from typing import Any, Callable, Dict, Optional

import numpy as np

from ...config import ConfigDict, register
from ...config.registry import get_kwargs

__all__ = ["TransformWrapper", "ConvertToType", "Compose", "LambdaTransform",
           "RepeatChannels", "Mixup", "CutMix", "build_transform"]


class TransformWrapper:
    """Applies a single-value transform to selected keywords, passing the
    rest through; replicates over ``k`` grouped datapoints (mixup pairs)."""

    def __init__(self, transform: Callable, config_dict: Optional[ConfigDict]
                 = None, data_to_transform=("x",), **kwargs):
        if config_dict is not None:
            kwargs = {**get_kwargs(transform, config_dict), **kwargs}
        if isinstance(transform, type) or kwargs:
            self.trsf_func = transform(**kwargs)
        else:
            self.trsf_func = transform
        self.data_to_transform = data_to_transform

    def _apply(self, data: Dict[str, Any]):
        keys = self.data_to_transform
        if keys == "all":
            keys = [k for k in data if k != "_index"]
        if list(keys) == ["x"]:
            return self.trsf_func(data["x"])
        return self.trsf_func(**{k: v for k, v in data.items() if k in keys})

    def __call__(self, k: int = 1, **data):
        output = data
        if k == 1:
            transformed = self._apply(data)
        else:
            per_item = [self._apply({key: value[i]
                                     for key, value in data.items()})
                        for i in range(k)]
            first = per_item[0]
            if isinstance(first, dict):
                transformed = {key: [item[key] for item in per_item]
                               for key in first}
            else:
                transformed = per_item
        if isinstance(transformed, dict):
            output.update(transformed)
        else:
            output["x"] = transformed
        output["k"] = output.get("k") or k
        return output


_NUMPY_DTYPES = {
    "torch.FloatTensor": np.float32,
    "torch.DoubleTensor": np.float64,
    "torch.HalfTensor": np.float16,
    "torch.ByteTensor": np.uint8,
    "torch.CharTensor": np.int8,
    "torch.ShortTensor": np.int16,
    "torch.IntTensor": np.int32,
    "torch.LongTensor": np.int32,   # as the JAX package casts it
    "torch.BoolTensor": np.bool_,
    "float32": np.float32, "float": np.float32, "int32": np.int32,
    "int": np.int32, "bool": np.bool_, "uint8": np.uint8,
}


@register("transform.ConvertToType")
class ConvertToType:
    """Casts each keyword to its configured dtype (default float32)."""

    def __init__(self, types_dict=None, default=None, *args, **kwargs):
        if isinstance(types_dict, ConfigDict):
            types_dict = types_dict.trim().to_dict()
        types_dict = types_dict or {}
        self.types = {}
        for key, name in types_dict.items():
            if name is None:
                self.types[key] = None
            else:
                self.types[key] = _NUMPY_DTYPES.get(str(name), name)
        self.default = default or np.float32

    def _cast(self, value, dtype):
        if dtype is None:
            return value
        return np.asarray(value).astype(dtype)

    def __call__(self, k: int = 1, **data):
        out = {}
        for key, value in data.items():
            if key in ("_index",):
                out[key] = value
                continue
            dtype = self.types.get(key, self.default)
            if k > 1 and isinstance(value, list):
                out[key] = [self._cast(v, dtype) for v in value]
            else:
                out[key] = self._cast(value, dtype)
        out["k"] = k
        return out


class Compose:
    """Composes dict-in/dict-out transforms in order."""

    def __init__(self, *transforms):
        self.transforms = transforms

    def __call__(self, **data):
        for transform in self.transforms:
            data = transform(**data)
        return data


@register("transform.LambdaTransform")
class LambdaTransform:
    """Evaluates a numpy expression over the data dict into a new keyword."""

    def __init__(self, config_dict: ConfigDict, *args, **kwargs):
        self.func = config_dict.get_str("function")
        self.kw = config_dict.get_str("out_keyword")
        self.globals = {"__builtins__": {**builtins.__dict__,
                                         **np.__dict__}}

    def __call__(self, k: int = 1, **data):
        data[self.kw] = eval(self.func, self.globals, dict(data))  # noqa: S307
        data["k"] = k
        return data


@register("transform.RepeatChannels")
class RepeatChannels:
    """Grayscale -> multi-channel by repeating the channel (last) axis."""

    PARAMS = {"repeats": 3}

    def __init__(self, repeats: int = 3, *args, **kwargs):
        self.repeats = repeats

    def __call__(self, k: int = 1, **data):
        x = np.asarray(data["x"])
        if x.ndim == 2:
            x = x[..., None]
        data["x"] = np.repeat(x, self.repeats, axis=-1)
        data["k"] = k
        return data


@register("transform.Mixup")
class Mixup:
    """Blend a pair of datapoints (requires ``num_datapoints = 2``)."""

    PARAMS = {"distribution": "symmetric_beta", "probability": 1.0}
    ALPHA = 1.0
    MAX = 1.0
    num_datapoints = 2

    def __init__(self, config_dict: Optional[ConfigDict] = None,
                 seed: Optional[int] = None, *args, **kwargs):
        config_dict = config_dict or ConfigDict()
        distribution = config_dict.trim().get("distribution",
                                              "symmetric_beta")
        self.rng = np.random.default_rng(seed)
        if distribution == "symmetric_beta":
            alpha = config_dict.get_or_update("alpha", self.ALPHA)
            self.get_lambda = lambda: self.rng.beta(alpha, alpha)
        elif distribution == "uniform":
            high = config_dict.get_or_update("maximum", self.MAX)
            self.get_lambda = lambda: self.rng.uniform(0, high)
        else:
            raise ValueError(f"Unknown mixup distribution {distribution!r}")
        self.p = config_dict.get("probability", 1.0)

    def __call__(self, k: int = 1, **data):
        if self.rng.binomial(1, self.p):
            (x1, x2), (y1, y2) = data["x"][:2], data["label"][:2]
            data = {key: value[0] for key, value in data.items()
                    if isinstance(value, list)}
            lam = self.get_lambda()
            data["x"] = (1 - lam) * np.asarray(x1) + lam * np.asarray(x2)
            data["label"] = (1 - lam) * np.asarray(y1) + lam * np.asarray(y2)
            data["k"] = 1
        else:
            data["k"] = k
        return data


@register("transform.CutMix")
class CutMix:
    """Axis-slice CutMix over a pair of datapoints (reference
    ``transform/transforms.py:176-211``); channels-last, so spatial axes
    default to (0, 1)."""

    PARAMS = {"distribution": "uniform", "axes": (0, 1), "probability": 1}
    num_datapoints = 2

    def __init__(self, config_dict: Optional[ConfigDict] = None,
                 seed: Optional[int] = None, *args, **kwargs):
        config_dict = config_dict or ConfigDict()
        self.rng = np.random.default_rng(seed)
        distribution = config_dict.trim().get("distribution", "uniform")
        if distribution != "uniform":
            raise ValueError(f"Unknown cutmix distribution {distribution!r}")
        self.p = config_dict.get("probability") or 1
        self.axes = np.array(config_dict.get("axes", (0, 1)))

    def __call__(self, k: int = 1, **data):
        if self.rng.binomial(1, self.p):
            (x1, x2), (y1, y2) = data["x"][:2], data["label"][:2]
            data = {key: value[0] for key, value in data.items()
                    if isinstance(value, list)}
            axis = int(self.rng.choice(self.axes))
            size = np.asarray(x1).shape[axis]
            cut = int(self.rng.integers(0, size))
            lam = cut / size
            x = np.array(x1, copy=True)
            slicer = [slice(None)] * x.ndim
            slicer[axis] = slice(cut, None)
            x[tuple(slicer)] = np.asarray(x2)[tuple(slicer)]
            data["x"] = x
            data["label"] = (1 - lam) * np.asarray(y1) + lam * np.asarray(y2)
            data["k"] = 1
        else:
            data["k"] = k
        return data


def build_transform(cfg: Any, seed: Optional[int] = None):
    """Build one transform from a ``{name: params}`` config entry."""
    from ...config.registry import accepts_kwarg, fill_spec, resolve
    if isinstance(cfg, str):
        cfg = ConfigDict({cfg: {}})
    name, params = cfg.item()
    if not isinstance(params, ConfigDict):
        params = ConfigDict()
        cfg[name] = params
    constructor = resolve(name)
    fill_spec(cfg)
    kwargs = {}
    if accepts_kwarg(constructor, "seed"):
        kwargs["seed"] = seed
    import inspect
    try:
        sig_params = inspect.signature(constructor).parameters
    except (TypeError, ValueError):
        sig_params = {}
    if "config_dict" in sig_params:
        return constructor(params, **kwargs)
    return constructor(**get_kwargs(constructor, params), **kwargs)
