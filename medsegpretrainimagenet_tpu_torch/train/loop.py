"""Epoch/step training loop with CSV logging and checkpoint policy: the
port of ``train/loop.py``.

Per epoch: the train pass, the validation pass, one ``epoch_logs.csv`` row
(``val_``-prefixed validation columns, the learning rate, an ``epoch``
column), ``batch_logs.csv`` rows per optimizer step, the last, best and
epoch-tagged model files, the optimizer and scheduler files and the
durable-epoch stamp; then the test pass into ``test_logs.csv``.  Every batch
and every epoch runs inside the catch-log-continue error envelope of the
reference, except a CUDA error, which is sticky (every later launch would
fail the same way): it ends the run.  With ``meta/technical/profile: true``
the loop writes ``profile/epoch_times.csv`` (host wall time per phase) and
``profile/step_times.csv`` (per-step device time, from CUDA events).

Batches are regrouped on the host into ``(n_fragments, fragment_bs, ...)``
stacks (the step accumulates gradients over the fragments) and copied to
the card ahead of the step through pinned memory.  The loop reads the card
only at window boundaries: the step's scalars stay on the card and a whole
``batch_log_flush`` window of them comes back in one copy, the epoch's
metrics in one more, the step timings once per epoch.

Not ported yet (ROADMAP queue M4): the host loggers, the confusion-matrix
export and the metrics' last pass; a config that asks for them raises
NotImplementedError when the calculator is built.
"""
from __future__ import annotations

import csv
import math
import os
import sys
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..config import ConfigDict
from ..utils import handle_exception, swallow
from ..utils.device import resolve_device
from . import checkpoint as ckpt
from .state import TrainState
from .step import make_eval_step, make_train_step

__all__ = ["train_model", "run_epoch", "append_csv_row"]


def append_csv_row(path: str, row: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_header = not os.path.isfile(path)
    with open(path, "a", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=list(row.keys()))
        if write_header:
            writer.writeheader()
        writer.writerow(row)


def is_sticky_cuda_error(exc: BaseException) -> bool:
    """A CUDA error other than out-of-memory poisons the context: every
    later launch raises it again, so no envelope may swallow it."""
    accelerator_error = getattr(torch, "AcceleratorError", None)
    if accelerator_error is not None and isinstance(exc, accelerator_error):
        return True
    return isinstance(exc, RuntimeError) and "CUDA error" in str(exc)


def _resume_best_value(csv_path: str, metric: str, pick, epoch_start: int):
    """The best already-achieved *metric* over the first *epoch_start*
    epochs of an existing epoch_logs.csv, or None.  A ``--continued``
    resume re-seeds its best-model tracking from this: restarting at ±inf
    would let the first epoch after the resume overwrite
    best_model_state_dict.pt even when it is worse than the best before.

    Rows key on their ``epoch`` column: the last row per epoch number <=
    *epoch_start* wins (a crash and resume append duplicate rows).  Rows
    without the column fall back to the first *epoch_start* rows.
    Non-finite values are skipped: a NaN seed would disable every later
    best-model write."""
    try:
        with open(csv_path, newline="") as fh:
            rows = list(csv.DictReader(fh))
    except OSError:
        return None
    if rows and "epoch" in rows[0]:
        last_per_epoch: Dict[int, Any] = {}
        for row in rows:
            try:
                ep = int(float(row["epoch"]))
            except (TypeError, ValueError):
                continue
            if ep <= epoch_start:
                last_per_epoch[ep] = row
        rows = [last_per_epoch[ep] for ep in sorted(last_per_epoch)]
    else:
        rows = rows[:epoch_start]
    values = []
    for row in rows:
        try:
            value = float(row[metric])
        except (KeyError, TypeError, ValueError):
            continue
        if math.isfinite(value):
            values.append(value)
    return pick(values) if values else None


def _stack_fragments(fragments):
    """List of equal-shaped fragment dicts -> (n_frag, frag_bs, ...) stack
    (one fragment: a view of it, with no copy)."""
    keys = fragments[0].keys()
    if len(fragments) == 1:
        return {k: np.asarray(fragments[0][k])[None] for k in keys}
    return {k: np.stack([f[k] for f in fragments]) for k in keys}


def _virtual_batches(loader, accumulation_scale: int):
    """Group loader fragments into virtual batches.

    Yields (n_frag, frag_bs, ...) stacks of equal-shaped fragments; a shape
    change or the epoch end flushes a partial group.  Every group, the
    ragged epoch tail included, is one optimizer step: the reference steps
    at each accumulation boundary and on the epoch's last fragment
    (``train_model.py:55``), ceil(len/acc) steps per epoch, which is also
    the schedules' batches_per_epoch."""
    pending = []
    for fragment in loader:
        if pending and (fragment.keys() != pending[0].keys() or any(
                fragment[k].shape != pending[0][k].shape
                for k in fragment)):
            yield _stack_fragments(pending)
            pending = []
        pending.append(fragment)
        if len(pending) == accumulation_scale:
            yield _stack_fragments(pending)
            pending = []
    if pending:
        yield _stack_fragments(pending)


def _prefetched(iterator, device: torch.device, depth: int = 2,
                threaded=None):
    """Copy *depth* batches ahead to *device*, through pinned memory, so
    the copy overlaps the step; a batch whose transfer fails is logged and
    skipped (the per-batch error envelope)."""
    from ..data.loader import prefetch_to_device

    def on_error(exc):
        if is_sticky_cuda_error(exc):
            raise exc
        handle_exception(exc, "Exception while transferring a batch.")

    return prefetch_to_device(iterator, size=depth, device=device,
                              on_error=on_error, threaded=threaded)


def run_epoch(step_fn, state, metrics_state, loader,
              accumulation_scale: int = 1, train: bool = True,
              device=None, log_path: Optional[str] = None,
              calculator=None, on_batch: Optional[Callable] = None,
              threaded_prefetch=None, log_flush: int = 512):
    """One pass over *loader*.  Returns (state, metrics_state).

    The step's scalars are not read back per step: a read waits for the
    card.  They stay on the card, and a window of ``log_flush`` steps comes
    back in one copy (``calculator.batch_values_window``); the same
    per-step CSV rows are then written in order.  ``log_flush=1`` writes
    each row as its step ends."""
    device = resolve_device(device)
    rows: list = []  # per-step scalar dicts on the card, awaiting read-back

    def _flush_rows():
        if not rows:
            return
        window = calculator.batch_values_window(rows)
        rows.clear()
        for values in window:
            append_csv_row(log_path, values)

    for i, batch_stack in enumerate(_prefetched(
            _virtual_batches(loader, accumulation_scale), device,
            threaded=threaded_prefetch)):
        try:
            if train:
                state, metrics_state, per_batch = step_fn(
                    state, metrics_state, batch_stack)
            else:
                metrics_state, per_batch = step_fn(
                    state, metrics_state, batch_stack)
            if log_path is not None and calculator is not None:
                rows.append(per_batch)
                if len(rows) >= max(1, int(log_flush)):
                    _flush_rows()
            if on_batch is not None:
                on_batch(i, per_batch)
        except Exception as exc:  # noqa: BLE001 - reference error envelope
            if is_sticky_cuda_error(exc):
                raise
            handle_exception(exc, f"Exception occured in batch {i}.")
    if rows:
        with swallow("Exception writing the batch log rows."):
            _flush_rows()
    return state, metrics_state


class _StepTimer:
    """Per-step times for ``profile/step_times.csv`` without a host wait
    per step: on the card a timing event is recorded on the stream after
    each step and the events are read once, at the epoch's end; on the CPU,
    where a step returns when it is done, the host clock."""

    def __init__(self, device: torch.device):
        self.on_cuda = device.type == "cuda"
        self.marks: list = []

    def __call__(self, i, per_batch) -> None:
        if self.on_cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append(event)
        else:
            self.marks.append(time.perf_counter())

    def durations(self) -> list:
        marks, self.marks = self.marks, []
        if len(marks) < 2:
            return []
        if self.on_cuda:
            marks[-1].synchronize()
            return [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
        return [b - a for a, b in zip(marks, marks[1:])]


def train_model(model, train_data, val_data, test_data,
                config_dict: ConfigDict, optimizer, state: TrainState,
                loss=None, metrics_and_loss=None, name: Optional[str] = None,
                virtual_batch_size: int = 32, true_batch_size: int = 1,
                verbose: bool = True, epoch_start: int = 0,
                grad_clip_value: Optional[float] = None,
                grad_clip_norm_type: float = 2.0, device=None,
                on_epoch: Optional[Callable] = None,
                device_augment=None, prediction_index: int = 0,
                **kwargs) -> TrainState:
    """Train for the configured number of epochs.  Returns the final state.

    *model*'s module and the metric state live on *device* (the card
    unless named); batches are copied there by the loop."""
    if virtual_batch_size % true_batch_size != 0:
        raise ValueError("true batch size must divide the virtual batch "
                         "size")
    accumulation_scale = virtual_batch_size // true_batch_size
    device = resolve_device(device)

    tech = config_dict["meta/technical"]
    destination = (tech.get("absolute path", "") or "") + (name or "") + "/"
    num_epochs = config_dict["experiment/number of epochs"]
    log_to_device = tech.get("log to device", True)
    log_batches = bool(log_to_device) and log_to_device != "epoch"
    log_last = tech.get("log_last_model", True)
    log_best = tech.get("log_best_model", True)
    # batch_logs.csv read-back window (steps per copy; 1 streams a row per
    # step like the reference)
    log_flush = int(tech.get("batch_log_flush", 512) or 512)
    threaded_prefetch = tech.get("threaded prefetch", None)
    checkpoints = tech.get_tuple("model_log_checkpoints", [])

    watched_metric, best_value, pick = None, None, max
    if log_best:
        eval_cfg = tech.get("model_evaluation", ConfigDict())
        if isinstance(eval_cfg, ConfigDict) and eval_cfg.has("metric"):
            watched_metric = eval_cfg.get_str("metric")
            mode = eval_cfg.get_str("mode") if eval_cfg.has("mode") else "max"
            pick = min if mode in ("min", "minimum") else max
            best_value = math.inf if pick is min else -math.inf
        else:
            log_best = False
    if log_best and epoch_start > 0:
        resumed = _resume_best_value(destination + "epoch_logs.csv",
                                     watched_metric, pick, epoch_start)
        if resumed is not None:
            best_value = resumed

    calculator = metrics_and_loss
    train_step = make_train_step(model, loss, calculator, optimizer,
                                 grad_clip_value=grad_clip_value,
                                 grad_clip_norm_type=grad_clip_norm_type,
                                 device_augment=device_augment,
                                 prediction_index=prediction_index)
    eval_step = make_eval_step(model, loss, calculator,
                               prediction_index=prediction_index)
    module = getattr(model, "module", model)

    profile_cfg = tech.get("profile", False)
    timer = _StepTimer(device) if profile_cfg else None
    if profile_cfg:
        profile_dir = destination + "profile/"
        os.makedirs(profile_dir, exist_ok=True)

    def _dump_step_times():
        durations = timer.durations() if timer is not None else []
        if durations:
            append_csv_row(profile_dir + "step_times.csv", {
                "steps": len(durations),
                "mean_s": float(np.mean(durations)),
                "p50_s": float(np.median(durations)),
                "max_s": float(np.max(durations))})

    async_writer = ckpt.AsyncCheckpointer() \
        if tech.get("async_checkpointing", False) else None

    def save(filenames, payload):
        """Write *payload* to every file in *filenames*: encoded once, on
        the worker thread in async mode."""
        if not filenames:
            return
        paths = [destination + f for f in filenames]
        if async_writer is not None:
            async_writer.save_many(paths, payload)
        else:
            blob = ckpt.encode_state(payload)
            for path in paths:
                ckpt.write_bytes_atomic(path, blob)

    # metrics_and_loss=None is a supported signature (loss-only training):
    # the epoch loop then writes empty metric rows
    def _init_metrics():
        return calculator.init_state(device) if calculator is not None \
            else None

    def _finalize(ms) -> Dict[str, Any]:
        return calculator.finalize_epoch(ms) if calculator is not None \
            else {}

    try:
        epochs = range(epoch_start, num_epochs)
        if verbose:
            try:
                from tqdm import tqdm
                epochs = tqdm(epochs, desc="Training model", unit="epoch")
            except ImportError:
                pass

        for epoch in epochs:
            try:
                row: Dict[str, Any] = {
                    "epoch": epoch + 1,
                    "learning_rate": float(optimizer.lr_at(state.step))}

                # per-epoch phase split under `meta/technical/profile: true`
                # -> profile/epoch_times.csv (host wall time per phase)
                seg: Dict[str, float] = {}
                seg_t = [time.perf_counter()]

                def _mark(phase: str) -> None:
                    if profile_cfg:
                        now = time.perf_counter()
                        seg[phase] = seg.get(phase, 0.0) + now - seg_t[0]
                        seg_t[0] = now

                try:
                    metrics_state = _init_metrics()
                    state, metrics_state = run_epoch(
                        train_step, state, metrics_state, train_data,
                        accumulation_scale, train=True, device=device,
                        log_path=destination + "batch_logs.csv"
                        if log_batches else None, calculator=calculator,
                        on_batch=timer, threaded_prefetch=threaded_prefetch,
                        log_flush=log_flush)
                finally:
                    with swallow("Exception writing step_times.csv."):
                        _dump_step_times()
                row.update(_finalize(metrics_state))
                _mark("train_s")

                if val_data:
                    metrics_state = _init_metrics()
                    _, metrics_state = run_epoch(
                        eval_step, state, metrics_state, val_data,
                        accumulation_scale, train=False, device=device,
                        threaded_prefetch=threaded_prefetch)
                    row.update({f"val_{k}": v for k, v in
                                _finalize(metrics_state).items()})
                    _mark("val_s")

                if log_to_device:
                    append_csv_row(destination + "epoch_logs.csv", row)
                    model_files = []
                    if log_last:
                        model_files.append("last_model_state_dict.pt")
                    if log_best and watched_metric in row:
                        current = row[watched_metric]
                        if pick(best_value, current) == current:
                            best_value = current
                            model_files.append("best_model_state_dict.pt")
                    if (epoch + 1) in checkpoints:
                        model_files.append(
                            f"model_state_dict_epoch_{epoch + 1}.pt")
                    save(model_files, module.state_dict())
                    save(["optimizer_state_dict.pt"], {
                        "optimizer": state.optimizer.state_dict(),
                        "step": int(state.step),
                        "micro_step": int(state.micro_step)})
                    # file-role parity with the reference's
                    # scheduler_state_dict.pt: the schedules are functions
                    # of the step counter, so the "state" is that counter
                    # and the schedule's identity
                    schedule = getattr(optimizer, "schedule", None)
                    if schedule is not None:
                        save(["scheduler_state_dict.pt"], {
                            "step": int(state.step), "unit": schedule.unit,
                            "base": float(schedule.base)})
                    # durable-epoch stamp, last through the same writer: in
                    # async mode the worker lags the CSV, so after a crash
                    # epoch_logs.csv can be ahead of the files on disk; the
                    # FIFO order lands the stamp after this epoch's files,
                    # and --continued resumes from min(csv rows, stamp)
                    save(["checkpoint_epoch.pt"], {"epoch": int(epoch + 1)})
                if async_writer is not None:
                    # a failed background write surfaces here, inside the
                    # epoch envelope, one epoch later
                    async_writer.poll()
                _mark("ckpt_s")
                if profile_cfg:
                    with swallow("Exception writing epoch_times.csv."):
                        append_csv_row(profile_dir + "epoch_times.csv", {
                            "epoch": epoch + 1,
                            **{k: round(v, 4) for k, v in seg.items()},
                            "total_s": round(sum(seg.values()), 4)})
                if on_epoch is not None:
                    on_epoch(epoch, row, state)
            except Exception as exc:  # noqa: BLE001 - reference envelope
                if is_sticky_cuda_error(exc):
                    raise
                handle_exception(exc, f"Exception occured in epoch {epoch}.")

        if test_data:
            try:
                metrics_state = _init_metrics()
                _, metrics_state = run_epoch(
                    eval_step, state, metrics_state, test_data,
                    accumulation_scale, train=False, device=device,
                    threaded_prefetch=threaded_prefetch)
                test_row = _finalize(metrics_state)
                if log_to_device:
                    append_csv_row(destination + "test_logs.csv", test_row)
            except Exception as exc:  # noqa: BLE001
                if is_sticky_cuda_error(exc):
                    raise
                handle_exception(
                    exc, "Exception occured while evaluating the test data.")

    finally:
        # always drain the checkpoint queue: an exception unwinding the
        # epoch region (an interrupt, a CUDA error) must not leave queued
        # last/best/optimizer writes unwritten.  On a clean exit close()
        # errors raise (a failure of the last epoch's writes is only
        # observable here); with an exception already unwinding they are
        # logged instead, so as not to mask it
        if async_writer is not None:
            if sys.exc_info()[0] is not None:
                with swallow("Exception draining queued async checkpoint "
                             "writes."):
                    async_writer.close()
            else:
                async_writer.close()
    return state
