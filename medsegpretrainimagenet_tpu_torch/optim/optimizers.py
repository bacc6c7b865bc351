"""Optimizers built from config: the port of ``optim/optimizers.py``.

Named optimizers (``sgd``, ``adam``) and the ``torch.optim.*`` aliases the
shipped configs use, with the nested ``learning_rate`` sub-config carrying
the schedule and the base lr.  The updates are ``torch.optim``'s, whose
rules are the ones the JAX package rebuilt in optax: SGD with weight decay
coupled into the gradient and a momentum buffer seeded with the undampened
first gradient; Adam with coupled decay, AdamW with decoupled decay; and
amsgrad's maximum taken over the raw second moment.  The learning rate is
a host function of the optimizer step (``schedules.py``) that the train
step sets into every param group before each update.  Frozen parameters
(a trainable mask) get no update, as optax's ``set_to_zero`` gives them:
they stay out of the param groups.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..config import ConfigDict, register
from .schedules import (DEFAULT_BASE_LR, ScheduleSpec, build_schedule,
                        fill_schedule_spec)

__all__ = ["Optimizer", "OPTIMIZERS", "build_optimizer"]


def _sgd(params, momentum=0.9, weight_decay=0.0, nesterov=False,
         dampening=0.0, **_ignored) -> torch.optim.Optimizer:
    """torch.optim.SGD: grad += wd*param; buf = g on the first step, then
    buf = m*buf + (1-d)*g; nesterov takes g + m*buf."""
    # without momentum there is no buffer, and nesterov has nothing to act on
    nesterov = bool(nesterov and momentum)
    sgd = torch.optim.SGD(params, lr=DEFAULT_BASE_LR, momentum=momentum,
                          weight_decay=weight_decay, dampening=dampening,
                          nesterov=nesterov and not dampening)
    if nesterov and dampening:
        # torch refuses the pair at construction, but its update applies
        # g + m*buf over the dampened buffer as the JAX package's
        # momentum does
        for group in sgd.param_groups:
            group["nesterov"] = True
    return sgd


def _adam(params, beta_1=0.9, beta_2=0.999, weight_decay=0.0,
          decoupled_weight_decay=False, amsgrad=False, eps=1e-8,
          betas=None, **_ignored) -> torch.optim.Optimizer:
    """torch.optim.Adam (decay coupled into the gradient) or AdamW (p -=
    lr*(adam_update + wd*p)); amsgrad keeps the maximum of the raw second
    moment and bias-corrects it afterwards, as the JAX package's
    ``_torch_amsgrad`` does."""
    if betas is not None:  # torch.optim.Adam spells the pair 'betas'
        beta_1, beta_2 = betas
    cls = torch.optim.AdamW if decoupled_weight_decay else torch.optim.Adam
    return cls(params, lr=DEFAULT_BASE_LR, betas=(beta_1, beta_2), eps=eps,
               weight_decay=weight_decay, amsgrad=bool(amsgrad))


def _adamw(params, betas=(0.9, 0.999), weight_decay=0.01, eps=1e-8,
           amsgrad=False, **_ignored) -> torch.optim.Optimizer:
    b1, b2 = betas
    return _adam(params, beta_1=b1, beta_2=b2, weight_decay=weight_decay,
                 decoupled_weight_decay=True, amsgrad=amsgrad, eps=eps)


OPTIMIZERS = {
    "sgd": {
        "init": _sgd,
        "arguments": {
            "momentum": {"argument name": "momentum", "default": 0.9},
            "weight decay": {"argument name": "weight_decay", "default": 0.0},
            "nesterov momentum": {"argument name": "nesterov",
                                  "default": False},
            "momentum dampening": {"argument name": "dampening",
                                   "default": 0.0},
        },
    },
    "adam": {
        "init": _adam,
        "arguments": {
            "beta_1": {"argument name": "beta_1", "default": 0.9},
            "beta_2": {"argument name": "beta_2", "default": 0.999},
            "weight decay": {"argument name": "weight_decay", "default": 0.0},
            "decoupled weight decay": {
                "argument name": "decoupled_weight_decay", "default": False},
            "amsgrad": {"argument name": "amsgrad", "default": False},
        },
    },
    "torch.optim.AdamW": {
        "init": _adamw,
        "arguments": {
            "betas": {"argument name": "betas", "default": (0.9, 0.999)},
            "weight_decay": {"argument name": "weight_decay",
                             "default": 0.01},
            "eps": {"argument name": "eps", "default": 1e-8},
            "amsgrad": {"argument name": "amsgrad", "default": False},
        },
    },
    "torch.optim.Adam": {
        "init": _adam,
        "arguments": {
            "betas": {"argument name": "betas", "default": (0.9, 0.999)},
            "weight_decay": {"argument name": "weight_decay", "default": 0.0},
            "eps": {"argument name": "eps", "default": 1e-8},
            "amsgrad": {"argument name": "amsgrad", "default": False},
        },
    },
    "torch.optim.SGD": {
        "init": _sgd,
        "arguments": {
            "momentum": {"argument name": "momentum", "default": 0.0},
            "weight_decay": {"argument name": "weight_decay", "default": 0.0},
            "nesterov": {"argument name": "nesterov", "default": False},
            "dampening": {"argument name": "dampening", "default": 0.0},
        },
    },
}


class Optimizer:
    """Config-built optimizer: a ``torch.optim`` factory, the lr schedule
    and the freeze mask.

    Usage::

        opt = Optimizer(config_dict['training/optimizer'],
                        num_epochs=E, batches_per_epoch=B,
                        trainable_mask=model.trainable_mask())
        torch_opt = opt.init(module)
        lr = opt.lr_at(step)
    """

    PARAMS = {"learning rate": DEFAULT_BASE_LR}

    @staticmethod
    def fill_kwargs(config_dict: ConfigDict):
        optim_name, optim_dict = config_dict.item()
        if optim_name in OPTIMIZERS:
            optim_dict.fill_with_defaults(OPTIMIZERS[optim_name]["arguments"])
        lr_dict = optim_dict.get_or_update("learning rate", "constant",
                                           final=False)
        if isinstance(lr_dict, ConfigDict):
            lr_dict.get_or_update(f"{lr_dict.key()}/base",
                                  Optimizer.PARAMS["learning rate"])
            fill_schedule_spec(lr_dict)

    def __init__(self, config_dict: ConfigDict,
                 num_epochs: Optional[int] = None,
                 batches_per_epoch: int = 1,
                 trainable_mask: Optional[Dict[str, bool]] = None):
        if isinstance(config_dict, str):
            config_dict = ConfigDict({config_dict: {}})
        Optimizer.fill_kwargs(config_dict)
        optim_name, optim_dict = config_dict.item()

        self.schedule: ScheduleSpec = build_schedule(
            optim_dict.get("learning rate"), num_epochs=num_epochs,
            batches_per_epoch=batches_per_epoch)
        self._lr_fn = self.schedule.global_fn(batches_per_epoch)

        spec = OPTIMIZERS.get(optim_name)
        if spec is None:
            from ..config.registry import RegistryError
            raise RegistryError(
                f"Unknown optimizer {optim_name!r} "
                f"(known: {sorted(OPTIMIZERS)})")
        self.kwargs: Dict[str, Any] = {}
        for arg_name, arg_spec in spec["arguments"].items():
            value = optim_dict.get(arg_name, arg_spec["default"])
            if isinstance(value, ConfigDict):
                value = value.key()
            self.kwargs[arg_spec["argument name"]] = value
        self._factory = spec["init"]
        self.trainable_mask = trainable_mask
        self.name = optim_name

    def init(self, module: torch.nn.Module) -> torch.optim.Optimizer:
        """The ``torch.optim`` optimizer over *module*'s trainable
        parameters (the analog of ``tx.init(params)``)."""
        mask = self.trainable_mask or {}
        params = [p for name, p in module.named_parameters()
                  if mask.get(name, True)]
        return self._factory(params, **self.kwargs)

    def lr_at(self, step: int) -> float:
        """Learning rate at a global optimizer step."""
        return self._lr_fn(step)

    def set_lr(self, optimizer: torch.optim.Optimizer, step: int) -> float:
        """Set the lr of optimizer step *step* into every param group and
        return it."""
        lr = self.lr_at(step)
        for group in optimizer.param_groups:
            group["lr"] = lr
        return lr


def build_optimizer(config_dict, **kwargs) -> Optimizer:
    return Optimizer(config_dict, **kwargs)


for _alias in OPTIMIZERS:
    register(_alias)(build_optimizer)
