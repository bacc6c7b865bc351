"""Train and eval steps (the hot path): the port of ``train/step.py``.

One call is one optimizer step over a ``(n_fragments, fragment_bs, ...)``
stack of batch tensors on the device:

* gradient accumulation: a forward and backward per fragment, the
  gradients summed and scaled by 1 / n_fragments (the mean of the
  fragments' gradients), BatchNorm running statistics chained from
  fragment to fragment (each train-mode forward updates them, as torch
  does);
* global-norm gradient clipping with torch's ``clip_grad_norm_`` rule
  (norm + 1e-6), the norm logged whether or not a clip applies;
* the optimizer update, with the lr of this step set into the optimizer
  first;
* the metric-state fold-in over the merged fragments.

Under data parallelism (``parallel``) a batch stack marked by
``parallel.shard_batch`` holds this process's slice of each fragment: the
forward runs on the slice with BatchNorm taking the global batch's
statistics, the predictions and targets of every slice are gathered (the
predictions with autograd), and the loss and the metrics are those of the
global fragment, as the JAX step computes them on its sharded batch.  The
processes' gradients are summed once per step, before clipping.  A stack
that is not marked (a ragged tail, replicated on every process) draws the
same masks on every process, and the processes' gradients are averaged.
Under spatial sharding (the grid's ``'spatial'`` axis) the forward runs on
this process's band of rows (``parallel.spatial``): the device
augmentation first takes the whole image, then the rows are cut (unless
``shard_batch`` cut them already), and the rows are gathered with the
samples before the loss.  A classifier's logits come out whole on every
member of the spatial axis, and their gradient is counted once per
spatial group (``gather_shards``), so that every process's gradient is
its share and the sum over data x spatial is the gradient, for every
model family.  Under tensor parallelism the gradient norm counts each
sharded parameter's slices once.

A step queues device work only: it returns device tensors and reads no
value back (no ``.item()``, no ``.cpu()``, no branch on a tensor), so the
host runs ahead of the card.  The learning rate is a host float.

Under a ``torch.profiler`` session each call opens the spans
``medseg.train_step`` (or ``medseg.eval_step``), ``medseg.forward`` and
``medseg.backward`` per fragment, and ``medseg.optimizer``
(``utils/profiling.py``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from ..models.blocks import draws, set_dropout_generator
from ..parallel import (ROWS_KEY, SHARDED_KEY, data_parallel, gather_batch,
                        gather_shards, grid, reduce_gradients, split_rows,
                        sync_batch_stats)
from ..parallel.spatial import row_shards
from ..parallel.tp import sharded as tp_sharded
from ..utils.profiling import span
from .state import TrainState

__all__ = ["make_train_step", "make_eval_step", "global_norm"]


def global_norm(tensors, norm_type: float = 2.0) -> torch.Tensor:
    """The norm of all *tensors* taken as one vector: per-tensor norms
    (one foreach launch) and the norm of those, with no concatenation."""
    tensors = list(tensors)
    if norm_type == float("inf"):
        return torch.stack([t.abs().max() for t in tensors]).max()
    norms = torch._foreach_norm(tensors, norm_type)
    return torch.linalg.vector_norm(torch.stack(norms), norm_type)


def _parameters_norm(params, grads, norm_type: float) -> torch.Tensor:
    """The norm of the gradients of the whole parameters: under tensor
    parallelism the sharded parameters' slices are summed over the model
    axis (each counted once), the replicated ones taken as they are."""
    shards = [g for p, g in zip(params, grads) if tp_sharded(p) is not None]
    if not shards:
        return global_norm(grads, norm_type)
    group = tp_sharded(next(p for p in params
                            if tp_sharded(p) is not None)).axis.group
    whole = [g for p, g in zip(params, grads) if tp_sharded(p) is None]
    sliced = global_norm(shards, norm_type)
    if norm_type == float("inf"):
        dist.all_reduce(sliced, op=dist.ReduceOp.MAX, group=group)
        return torch.maximum(sliced, global_norm(whole, norm_type)) \
            if whole else sliced
    total = sliced ** norm_type
    dist.all_reduce(total, group=group)
    if whole:
        total = total + global_norm(whole, norm_type) ** norm_type
    return total ** (1.0 / norm_type)


def _clip_by_norm(params, grads, max_norm: float,
                  norm_type: float) -> torch.Tensor:
    """Scale *grads* in place by min(1, max_norm / (norm + 1e-6)) and
    return the norm before the scaling."""
    norm = _parameters_norm(params, grads, norm_type)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    torch._foreach_mul_(grads, scale)
    return norm


def _merge(values):
    """Fragments' tensors (or tuples of them) -> one batch along dim 0."""
    if isinstance(values[0], (tuple, list)):
        return type(values[0])(_merge(list(v)) for v in zip(*values))
    return values[0] if len(values) == 1 else torch.cat(values)


def _select_prediction(pred, prediction_index: int):
    """The metric-side output of a multi-output model; single-output
    models pass through."""
    if isinstance(pred, (tuple, list)):
        return pred[prediction_index]
    return pred


def _dequantize_inputs(batch: Dict[str, Any]) -> Dict[str, Any]:
    """uint8 inputs widen on the device: images -> float32/255, integer
    targets (mask/label) -> int32.  Shipping uint8 batches to the card
    quarters the host-to-device traffic."""
    out = dict(batch)
    if out.get("x") is not None and out["x"].dtype == torch.uint8:
        out["x"] = out["x"].float() / 255.0
    for key in ("mask", "label"):
        value = out.get(key)
        if isinstance(value, torch.Tensor) and value.dtype == torch.uint8:
            out[key] = value.int()
    return out


def _fragments(batch_stack: Dict[str, Any]):
    n_frag = next(v for v in batch_stack.values()
                  if isinstance(v, torch.Tensor)).shape[0]
    return [{k: v[i] for k, v in batch_stack.items()}
            for i in range(n_frag)]


def _split_sharded(batch_stack: Dict[str, Any]):
    """(batch stack without the shard marks, is it a slice of the global
    batch?, the spatial axis of its forward or None, are its rows cut
    already?)"""
    if SHARDED_KEY not in batch_stack:
        return batch_stack, False, None, False
    rest = {k: v for k, v in batch_stack.items()
            if k not in (SHARDED_KEY, ROWS_KEY)}
    sharded = bool(batch_stack[SHARDED_KEY])
    rows = None
    if sharded and data_parallel():
        inner = grid().inner
        if inner.name == "spatial" and inner.group is not None:
            rows = inner
    return rest, sharded, rows, bool(batch_stack.get(ROWS_KEY, False))


def make_train_step(model, loss_fn: Callable, calculator, optimizer,
                    grad_clip_value: Optional[float] = None,
                    grad_clip_norm_type: float = 2.0,
                    device_augment: Optional[Callable] = None,
                    prediction_index: int = 0):
    """Build the train step ``(state, metrics_state, batch_stack) ->
    (state, metrics_state, per_batch)``.

    ``model``: the Model wrapper (or a bare module).
    ``loss_fn(prediction, batch) -> scalar``.
    ``calculator``: MetricsCalculator or None.
    ``optimizer``: ``optim.Optimizer`` (``lr_at``, ``set_lr``); the
    ``torch.optim`` optimizer it made is ``state.optimizer``.
    ``device_augment``: optional ``(generator, fragment) -> fragment``
    applied on the device before the forward.
    """
    module = getattr(model, "module", model)
    # every draw of the step (dropout, attention dropout, stochastic depth,
    # the device augmentation) comes from the fragment's generator
    uses_rng = device_augment is not None or draws(module)

    def train_step(state: TrainState, metrics_state, batch_stack):
        with span("medseg.train_step"):
            return _train_step(state, metrics_state, batch_stack)

    def _train_step(state: TrainState, metrics_state, batch_stack):
        batch_stack, sharded, rows, rows_cut = _split_sharded(batch_stack)
        fragments = _fragments(batch_stack)
        n_frag = len(fragments)
        module.train()
        # every gradient, frozen parameters' too: those stay out of the
        # optimizer but count in the norm, so each step starts from none
        module.zero_grad(set_to_none=True)
        loss_sum, preds, seen = None, [], []
        for i, fragment in enumerate(fragments):
            fragment = _dequantize_inputs(fragment)
            generator = None
            if uses_rng:
                generator = state.fragment_generator(
                    i, fragment["x"].device, sharded)
                set_dropout_generator(module, generator)
            if device_augment is not None:
                fragment = device_augment(generator, fragment)
            if rows is not None and not rows_cut:
                # the augmentation took the whole image (a rotation is
                # global); now this process's band of rows
                fragment = split_rows(fragment, rows)
            with span("medseg.forward"), sync_batch_stats(sharded), \
                    row_shards(rows):
                pred = module(fragment["x"])
            if sharded:
                # the global fragment's loss, on every process
                pred = gather_shards(pred, rows is not None)
                fragment = gather_batch(fragment, rows is not None)
            loss = loss_fn(pred, fragment)
            with span("medseg.backward"):
                loss.backward()
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            # the (augmented) fragment rides along, so metrics compare
            # the prediction with the geometry it was computed on
            preds.append(pred.detach() if isinstance(pred, torch.Tensor)
                         else type(pred)(p.detach() for p in pred))
            seen.append(fragment)

        with span("medseg.optimizer"):
            # a trainable parameter the loss does not reach has no
            # gradient, and torch.optim would skip it; optax applies
            # momentum and decay to its zero gradient, so give it one
            for group in state.optimizer.param_groups:
                for p in group["params"]:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
            params = [p for p in module.parameters() if p.grad is not None]
            grads = [p.grad for p in params]
            reduce_gradients(grads, replicated=not sharded)
            if n_frag > 1:
                torch._foreach_mul_(grads, 1.0 / n_frag)
            if grad_clip_value is not None \
                    and grad_clip_value != float("inf"):
                grad_norm = _clip_by_norm(params, grads, grad_clip_value,
                                          grad_clip_norm_type)
            else:
                grad_norm = _parameters_norm(params, grads,
                                             grad_clip_norm_type)
            lr = optimizer.set_lr(state.optimizer, state.step)
            state.optimizer.step()
        state.step += 1
        state.micro_step += 1
        loss_value = loss_sum * (1.0 / n_frag)

        per_batch = {"gradient_magnitude": grad_norm, "learning_rate": lr}
        if calculator is not None:
            merged_batch = {k: _merge([f[k] for f in seen]) for k in seen[0]
                            if isinstance(seen[0][k], torch.Tensor)}
            metrics_state, metric_values = calculator.update(
                metrics_state,
                _select_prediction(_merge(preds), prediction_index),
                merged_batch, loss_value=loss_value)
            per_batch.update(metric_values)
        else:
            per_batch["loss"] = loss_value
        return state, metrics_state, per_batch

    return train_step


def make_eval_step(model, loss_fn: Optional[Callable], calculator,
                   prediction_index: int = 0):
    """Build the eval step ``(state, metrics_state, batch_stack) ->
    (metrics_state, per_batch)``: no gradients, running BatchNorm
    statistics."""
    module = getattr(model, "module", model)

    def eval_step(state: TrainState, metrics_state, batch_stack):
        with span("medseg.eval_step"):
            return _eval_step(state, metrics_state, batch_stack)

    def _eval_step(state: TrainState, metrics_state, batch_stack):
        batch_stack, sharded, rows, rows_cut = _split_sharded(batch_stack)
        module.eval()
        with torch.inference_mode():
            preds, seen = [], []
            for fragment in _fragments(batch_stack):
                fragment = _dequantize_inputs(fragment)
                if rows is not None and not rows_cut:
                    fragment = split_rows(fragment, rows)
                with span("medseg.forward"), row_shards(rows):
                    pred = module(fragment["x"])
                if sharded:
                    pred = gather_shards(pred, rows is not None)
                    fragment = gather_batch(fragment, rows is not None)
                preds.append(pred)
                seen.append(fragment)
            # the loss sees the full (possibly multi-output) prediction and
            # applies its own train_prediction_index; metrics get the
            # training/prediction_index selection
            merged_pred = _merge(preds)
            merged_batch = {k: _merge([f[k] for f in seen]) for k in seen[0]
                            if isinstance(seen[0][k], torch.Tensor)}
            loss_value = loss_fn(merged_pred, merged_batch) \
                if loss_fn is not None else None
            per_batch = {}
            if calculator is not None:
                metrics_state, per_batch = calculator.update(
                    metrics_state,
                    _select_prediction(merged_pred, prediction_index),
                    merged_batch, loss_value=loss_value)
        return metrics_state, per_batch

    return eval_step
