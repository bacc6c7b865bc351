"""The system under test, built as its own command-line interface builds
it: the model from the config tree through the registry, the loss, the
optimizer with its schedule, the metric calculator, the train state and
the port's train and eval steps.  The benchmark's weights replace the
model's own initialisation through ``load_state_dict``.

This is the only module of the benchmark that imports the program.
"""
from __future__ import annotations

import copy
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

__all__ = ["Port", "build", "MetricsRange", "apply_switches"]


@dataclass
class Port:
    model: Any
    module: torch.nn.Module
    state: Any
    calculator: Any
    loss: Any
    optimizer: Any
    leaves: List[Tuple[str, Tuple[int, ...], torch.dtype]]


class MetricsRange:
    """The calculator handed to the steps: each update runs inside a
    profiler range ``metrics``, and the prediction and values of the batch
    in ``keep`` (pool index -> latest) are kept for the check."""

    def __init__(self, calculator):
        self._calculator = calculator
        self.current: Optional[int] = None
        self.keep: Dict[int, Optional[tuple]] = {}

    def __getattr__(self, name):
        return getattr(self._calculator, name)

    def update(self, state, prediction, batch, loss_value=None):
        with torch.profiler.record_function("metrics"):
            new_state, per_batch = self._calculator.update(
                state, prediction, batch, loss_value=loss_value)
        if self.current in self.keep:
            self.keep[self.current] = (prediction, per_batch)
        return new_state, per_batch


def apply_switches(tree: dict, device: torch.device) -> None:
    """The config's ``meta/technical`` switches, as the CLI applies
    them."""
    from medsegpretrainimagenet_tpu_torch.cli.run_experiment import \
        apply_host_switches
    from medsegpretrainimagenet_tpu_torch.config import ConfigDict

    technical = tree.get("meta", {}).get("technical", {})
    apply_host_switches(ConfigDict(copy.deepcopy(technical)), device)


@contextmanager
def route(workload: dict):
    """The cell's compute dtype and attention route, restored after."""
    from medsegpretrainimagenet_tpu_torch import ops
    from medsegpretrainimagenet_tpu_torch.models import blocks

    dtype = {"bfloat16": torch.bfloat16, "float32": None}[
        workload["compute_dtype"]]
    mode = {"k1": "off", "k2": "on"}[workload.get("attention", "k1")]
    blocks.set_compute_dtype(dtype)
    ops.set_fused_image_mode(mode)
    try:
        yield
    finally:
        blocks.set_compute_dtype(None)
        ops.set_fused_image_mode("off")


def _tuples(node):
    """A JSON tree with its lists as tuples, as the port's configs hold
    sizes (a list there is a grid axis)."""
    if isinstance(node, dict):
        return {k: _tuples(v) for k, v in node.items()}
    if isinstance(node, list):
        return tuple(_tuples(v) for v in node)
    return node


def build(tree: dict, metrics: List[str], device: torch.device, seed: int,
          weights_fn) -> Tuple[Port, Dict[str, torch.Tensor]]:
    """The port's objects for *tree* with the metric set *metrics*, its
    weights from ``weights_fn(leaves)``.  Returns (port, the weights
    loaded)."""
    from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
    from medsegpretrainimagenet_tpu_torch.losses import Loss
    from medsegpretrainimagenet_tpu_torch.metrics import MetricsCalculator
    from medsegpretrainimagenet_tpu_torch.models import Model
    from medsegpretrainimagenet_tpu_torch.optim import Optimizer
    from medsegpretrainimagenet_tpu_torch.train import TrainState

    tree = _tuples(tree)
    tree.pop("meta", None)
    tree["metrics"] = {"metrics": tuple(metrics)}
    cd = ConfigDict(tree)
    cd.expand()
    for key in ("model", "training/loss"):
        registry.fill_spec(cd, key)
    Model.fill_weight_init_kwargs(cd["model"].value())
    cd = cd.trim()
    model = registry.build(cd, key="model", wrapper=Model)
    module = model.module.to(device)
    leaves = [(k, tuple(v.shape), v.dtype)
              for k, v in module.state_dict().items()]
    weights = weights_fn(leaves)
    module.load_state_dict(weights, strict=True)
    optimizer = Optimizer(cd["training/optimizer"], num_epochs=1,
                          batches_per_epoch=1000)
    state = TrainState.create(module, optimizer.init(module), seed)
    loss = registry.build(cd, key="training/loss", wrapper=Loss)
    calculator = MetricsCalculator(cd, loss=loss)
    return Port(model, module, state, calculator, loss, optimizer,
                leaves), weights


def train_step(port: Port, calculator):
    from medsegpretrainimagenet_tpu_torch.train import make_train_step
    return make_train_step(port.model, port.loss, calculator, port.optimizer)


def eval_step(port: Port, calculator):
    from medsegpretrainimagenet_tpu_torch.train import make_eval_step
    return make_eval_step(port.model, port.loss, calculator)
