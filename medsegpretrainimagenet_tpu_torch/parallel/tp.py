"""Tensor parallelism over the grid's ``'model'`` axis: the port of
``parallel/tp.py``.

The JAX package shards the output-channel dim of the large conv and dense
kernels (and the wide 1-D biases and scales) over a ``'model'`` mesh axis
and lets XLA insert the collectives.  The port keeps the same rule
(:func:`tensor_parallel_shardings`, the rule of the JAX ``_spec_for`` on
torch's layouts) and does the rest by hand:

* :func:`shard_train_state` cuts each eligible parameter, and its optimizer
  moments, to this process's slice of dim 0 (torch keeps the output
  channels first: a conv weight is (O, I / groups, kh, kw), a dense one
  (O, I)), so each model rank keeps and updates only its slice;
* an eligible conv or dense layer is column-parallel
  (``models.blocks.Conv``, ``Dense``): its input goes through an identity
  whose backward sums over the model axis, it computes its own output
  channels, and they are gathered over the model axis (the backward keeps
  this rank's slice);
* an eligible norm scale or bias (and ``LayerScale``'s) is gathered in the
  forward (:func:`full`);
* the gradient norm counts each sharded slice once (``train.step``);
* the checkpoint files are written whole (:func:`full_state_dict`,
  :func:`full_optimizer_state_dict`), so a run's files load into a run of
  one process, as the JAX package's checkpoints gather to the host.

The port has no transposed convolution, and neither has the JAX package.
A grouped conv is column-parallel when the model axis divides its groups.
"""
from __future__ import annotations

import copy
from typing import Dict, Optional

import torch
from torch import nn

from .mesh import Axis, gather_axis, grid

__all__ = ["tensor_parallel_shardings", "shard_train_state", "full",
           "sharded", "full_state_dict", "full_optimizer_state_dict",
           "sharded_share"]


def _sharded_dim(name: str, shape, min_channels: int, size: int
                 ) -> Optional[int]:
    """The JAX rule (``tp._spec_for``) on a torch parameter: a conv or dense
    ``weight`` (JAX ``kernel``) whose output channels, torch's dim 0, are at
    least *min_channels* and divide by *size*; a 1-D ``bias`` or ``weight``
    (JAX ``scale``) of such a width."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf not in ("weight", "bias") or not shape:
        return None
    if leaf == "bias" and len(shape) != 1:
        return None
    channels = shape[0]
    if channels >= min_channels and channels % size == 0:
        return 0
    return None


def tensor_parallel_shardings(module: nn.Module, size: int,
                              min_channels: int = 256
                              ) -> Dict[str, Optional[int]]:
    """Per parameter name, the dim sharded over a *size*-way model axis
    (0), or None where it stays replicated.  Small parameters stay
    replicated: sharding tiny tensors costs more in collectives than it
    saves in memory and operations."""
    return {name: _sharded_dim(name, tuple(p.shape), min_channels, size)
            for name, p in module.named_parameters()}


class _Shard:
    """What a sharded parameter carries: its axis and whole shape."""

    def __init__(self, axis: Axis, shape):
        self.axis, self.shape = axis, tuple(shape)


def sharded(param: Optional[torch.Tensor]) -> Optional[_Shard]:
    """The shard record of a parameter cut by :func:`shard_train_state`."""
    return getattr(param, "_tp_shard", None)


def full(param: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The whole parameter: its slices gathered over the model axis
    (differentiable in this rank's slice), or the parameter itself."""
    shard = sharded(param)
    if shard is None:
        return param
    return gather_axis(param, 0, shard.axis)


def _slice(tensor: torch.Tensor, axis: Axis) -> torch.Tensor:
    return tensor.chunk(axis.size, 0)[axis.index].clone()


def shard_train_state(module: nn.Module, optimizer: torch.optim.Optimizer,
                      axis: str = "model", min_channels: int = 256) -> Dict[
                          str, Optional[int]]:
    """Cut *module*'s eligible parameters to this process's slice over the
    grid's *axis*, in place, and with each its optimizer moments (the
    optimizer state is keyed by the parameter, so the moments follow their
    parameter, never a same-shaped other one).  Everything else stays
    replicated.  Returns :func:`tensor_parallel_shardings`."""
    model_axis = grid().axis(axis)
    plan = tensor_parallel_shardings(module, model_axis.size, min_channels)
    if model_axis.group is None:
        return plan
    modules = dict(module.named_modules())
    for name, param in module.named_parameters():
        if plan[name] is None:
            continue
        owner = modules[name.rpartition(".")[0]]
        groups = getattr(owner, "groups", 1)
        if name.endswith("weight") and groups > 1 \
                and groups % model_axis.size:
            raise ValueError(
                f"tensor parallelism: {name} is a conv of {groups} groups, "
                f"which the {model_axis.size}-way model axis does not "
                f"divide")
        whole = tuple(param.shape)
        with torch.no_grad():
            param.data = _slice(param.data, model_axis)
        param._tp_shard = _Shard(model_axis, whole)
        for key, value in list(optimizer.state.get(param, {}).items()):
            if isinstance(value, torch.Tensor) \
                    and tuple(value.shape) == whole:
                optimizer.state[param][key] = _slice(value, model_axis)
    return plan


def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """*module*'s state dict with every sharded parameter whole (a
    collective over the model axis: every model rank calls it)."""
    state = module.state_dict()
    for name, param in module.named_parameters():
        shard = sharded(param)
        if shard is not None:
            state[name] = gather_axis(param.detach(), 0, shard.axis)
    return state


def full_optimizer_state_dict(optimizer: torch.optim.Optimizer) -> dict:
    """The optimizer's state dict with the moments of every sharded
    parameter whole (a collective over the model axis)."""
    state = optimizer.state_dict()
    params = [p for group in optimizer.param_groups for p in group["params"]]
    if not any(sharded(p) is not None for p in params):
        return state
    state = {**state, "state": copy.copy(state["state"])}
    for index, param in enumerate(params):
        shard = sharded(param)
        if shard is None or index not in state["state"]:
            continue
        state["state"][index] = {
            key: gather_axis(value, 0, shard.axis)
            if isinstance(value, torch.Tensor)
            and value.shape == param.shape else value
            for key, value in state["state"][index].items()}
    return state


def sharded_share(module: nn.Module) -> float:
    """The share of *module*'s parameter elements (whole shapes) that are
    sharded."""
    total = shard = 0
    for param in module.parameters():
        record = sharded(param)
        count = param.numel() if record is None \
            else int(torch.Size(record.shape).numel())
        total += count
        shard += count if record is not None else 0
    return shard / max(total, 1)
