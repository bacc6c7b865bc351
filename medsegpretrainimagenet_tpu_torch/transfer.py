"""Carry a JAX checkpoint across: flax variables -> the port's state dict.

The port names its submodules after the flax parameter paths, so the map is
mechanical:

* path components join with "."; a flax list attribute ``level_convs_0_1``
  is the torch ModuleList entry ``level_convs.0.1`` (flax's own auto-names,
  ``Dense_0``, start with a capital and stay as they are);
* a Dense ``kernel`` (in, out) becomes ``weight`` (out, in);
* a Conv ``kernel`` HWIO becomes ``weight`` OIHW;
* a LayerNorm or BatchNorm ``scale`` becomes ``weight``;
* ``bias``, ``alpha`` (PReLU) and ``relative_position_bias_table`` are
  copied as they are;
* the ``batch_stats`` of a BatchNorm, ``mean`` and ``var``, become its
  ``running_mean`` and ``running_var`` buffers, and its
  ``num_batches_tracked`` is filled with 0 (flax keeps no such count), so
  that a strict ``load_state_dict`` takes the result.

Usage, with the JAX package's ``load_params_file`` for the msgpack file::

    variables = jax_checkpoint.load_params_file("best_model_state_dict.msgpack")
    module.load_state_dict(state_dict_from_jax(variables, module))
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["state_dict_from_jax"]

_LIST_ENTRY = re.compile(r"^([a-z][a-z0-9_]*?)((?:_\d+)+)$")


_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _torch_name(path, stats: bool = False) -> str:
    parts = []
    for part in path[:-1]:
        match = _LIST_ENTRY.match(part)
        if match:
            parts.append(match.group(1))
            parts.extend(match.group(2).lstrip("_").split("_"))
        else:
            parts.append(part)
    leaf = path[-1]
    rename = _STAT_NAMES if stats else {"kernel": "weight", "scale": "weight"}
    parts.append(rename.get(leaf, leaf))
    return ".".join(parts)


def _torch_value(leaf: str, value) -> torch.Tensor:
    array = np.asarray(value, dtype=np.float32)
    if leaf == "kernel" and array.ndim == 2:
        array = array.T
    elif leaf == "kernel" and array.ndim == 4:
        array = array.transpose(3, 2, 0, 1)
    return torch.tensor(array)  # a copy: JAX's host arrays are read-only


def _leaves(tree: Mapping, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def state_dict_from_jax(variables: Mapping,
                        module: nn.Module) -> Dict[str, torch.Tensor]:
    """Map the JAX package's ``{"params": ..., "batch_stats": ...}`` tree
    (numpy or jax arrays) onto *module*'s state dict, buffers included.
    Raises KeyError on any key the module lacks or leaves unfilled,
    ValueError on a shape that does not match."""
    if "params" not in variables:
        variables = {"params": variables}
    target = module.state_dict()
    out = {}
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(collection) or {}):
            name = _torch_name(path, stats=collection == "batch_stats")
            if name not in target:
                raise KeyError(f"JAX {collection} leaf {'/'.join(path)} maps "
                               f"to {name!r}, which the module does not "
                               f"have")
            tensor = _torch_value(path[-1], value)
            if tuple(tensor.shape) != tuple(target[name].shape):
                raise ValueError(f"{'/'.join(path)}: shape "
                                 f"{tuple(tensor.shape)} after mapping, "
                                 f"module has {tuple(target[name].shape)} at "
                                 f"{name}")
            out[name] = tensor
    for name, value in target.items():
        if name.endswith("num_batches_tracked"):
            out[name] = torch.zeros_like(value)
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"the JAX variables fill no value for {missing[:8]}"
                       f"{' ...' if len(missing) > 8 else ''}")
    return out
