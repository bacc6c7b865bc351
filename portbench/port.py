"""The system under test, built as its own command-line interface builds
it: the model from the config tree through the registry, the loss, the
optimizer with its schedule, the metric calculator, the train state and
the port's train and eval steps.  The benchmark's weights replace the
model's own initialisation through ``load_state_dict``.

This is the only module of the benchmark that imports the program.
"""
from __future__ import annotations

import copy
import fcntl
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

__all__ = ["Port", "build", "MetricsRange", "apply_switches", "join",
           "replicate", "shard", "no_exchange", "local_stats",
           "one_build_at_a_time"]


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


# ---------------------------------------------------------------------------
# data parallelism, as the command line runs it under a launcher
# ---------------------------------------------------------------------------

def join(device: torch.device) -> torch.device:
    """Join the launcher's process group on *device* (``RANK``,
    ``WORLD_SIZE``, an ``env://`` rendezvous): NCCL on a card, gloo on the
    CPU."""
    from medsegpretrainimagenet_tpu_torch.parallel import \
        initialize_distributed
    return initialize_distributed(device)


def replicate(module: torch.nn.Module) -> None:
    """Every rank starts from rank 0's weights."""
    from medsegpretrainimagenet_tpu_torch.parallel import put_replicated
    put_replicated(module)


def shard(batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """This rank's slice of a global batch, marked as a slice: the step
    then takes BatchNorm's statistics and the loss over the global batch
    and sums the gradients."""
    from medsegpretrainimagenet_tpu_torch.parallel import shard_batch
    return shard_batch(batch, batch_dim=0)


@contextmanager
def no_exchange():
    """A fault: each rank steps on its own slice's gradient (the step's
    gradient sum left out)."""
    from medsegpretrainimagenet_tpu_torch.train import step

    saved = step.reduce_gradients
    step.reduce_gradients = lambda grads, replicated=False: None
    try:
        yield
    finally:
        step.reduce_gradients = saved


@contextmanager
def local_stats():
    """A fault: BatchNorm takes the statistics of the rank's own slice,
    not of the global batch."""
    from medsegpretrainimagenet_tpu_torch.parallel import mesh
    from medsegpretrainimagenet_tpu_torch.train import step

    saved = step.sync_batch_stats
    step.sync_batch_stats = lambda active=True: mesh.sync_batch_stats(False)
    try:
        yield
    finally:
        step.sync_batch_stats = saved


@contextmanager
def one_build_at_a_time():
    """The port's kernels build at first use into ``build/kernels/``:
    while active, one process of the checkout builds and the others wait
    on a file lock beside it, then find the library built."""
    from medsegpretrainimagenet_tpu_torch.ops import _build

    original = _build.build
    lock = _build.BUILD_DIR.parent / "kernels.lock"

    def build(names=None):
        lock.parent.mkdir(parents=True, exist_ok=True)
        with open(lock, "a") as handle:
            fcntl.flock(handle, fcntl.LOCK_EX)
            try:
                return original(names)
            finally:
                fcntl.flock(handle, fcntl.LOCK_UN)
    _build.build = build
    try:
        yield
    finally:
        _build.build = original
