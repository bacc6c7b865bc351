"""Epoch/step training loop with CSV logging and checkpoint policy: the
port of ``train/loop.py``.

Per epoch: the train pass, the validation pass, one ``epoch_logs.csv`` row
(``val_``-prefixed validation columns, the learning rate, an ``epoch``
column), ``batch_logs.csv`` rows per optimizer step, the last, best and
epoch-tagged model files, the optimizer and scheduler files and the
durable-epoch stamp; the confusion-matrix export at the configured epochs
and the host loggers (sample images, ROC and PR curves) at theirs; after the
epochs the metrics' last pass over train and val when a metric asks for
it, the metrics' end-of-training exports, then the test pass into
``test_logs.csv``.  Every batch
and every epoch runs inside the catch-log-continue error envelope of the
reference, except a CUDA error, which is sticky (every later launch would
fail the same way): it ends the run.  With ``meta/technical/profile: true``
the loop writes ``profile/epoch_times.csv`` (host wall time per phase) and
``profile/step_times.csv`` (per-step device time, from CUDA events) and a
``torch.profiler`` trace of the first epoch it runs under ``profile/trace/``,
which holds the port's spans (``utils/profiling.py``): ``medseg.loader_wait``
around each take from the prefetcher, ``medseg.h2d`` around each batch's
pinned copy, and the steps' own.

Under data parallelism (``parallel``) each batch is cut to this process's
slice before its copy to the card (``parallel.shard_batch``; a batch the
loader already assembled as the slice, under per-host input slicing,
passes as it is; under spatial sharding also to its band of rows, unless
the train step augments on the card, which takes the whole image first),
and only the main process writes: CSV rows, checkpoints, plots, the
confusion-matrix export, the host loggers' files and the profile.  Under
tensor parallelism the checkpoint files are gathered whole first
(``parallel.full_state_dict``), by every process.

Batches are regrouped on the host into ``(n_fragments, fragment_bs, ...)``
stacks (the step accumulates gradients over the fragments) and copied to
the card ahead of the step through pinned memory.  The loop reads the card
only at window boundaries: the step's scalars stay on the card and a whole
``batch_log_flush`` window of them comes back in one copy, the epoch's
metrics in one more, the step timings once per epoch.  With
``meta/technical/debug_nans`` the loop also reads, with each window, a flag
per step that says whether a scalar of the step (loss, gradient norm,
metrics) is not finite, and raises FloatingPointError naming the steps.
"""
from __future__ import annotations

import csv
import itertools
import math
import os
import sys
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..config import ConfigDict
from ..data.loader import BalancedDataLoader
from ..metrics.calculator import cm_log_epochs, to_host
from ..parallel import (full_optimizer_state_dict, full_state_dict, grid,
                        is_main_process, shard_batch)
from ..utils import handle_exception, swallow
from ..utils.device import resolve_device
from ..utils.profiling import span, start_trace, stop_trace
from . import checkpoint as ckpt
from .state import TrainState
from .step import (_dequantize_inputs, _select_prediction, make_eval_step,
                   make_train_step)

__all__ = ["train_model", "run_epoch", "append_csv_row"]


def _export_confusion_matrix(calculator, metrics_state, destination: str,
                             epoch: int, config_dict,
                             train: bool = False) -> None:
    """The K x K confusion matrix at an active epoch
    (``multiclass_metrics.py:124-153``): the train and the validation pass
    each export a row-normalised matrix as
    ``Confusion_matrices/{train_|val_}confusion_matrix_epoch_{i}``."""
    cm = calculator.epoch_confusion_matrix(metrics_state)
    if cm is None:
        return
    from ..plotting import ConfMtxPlotter, export_plot
    labels = config_dict.get_str_tuple("metrics/calculation/class_names") \
        or None
    kind, prefix = ("Train", "train_") if train else ("Validation", "val_")
    plotter = ConfMtxPlotter({
        "matrix": cm, "labels": list(labels) if labels else None,
        "title": f"{kind} confusion matrix at epoch {epoch}",
        "dirname": os.path.join(destination, "Confusion_matrices"),
        "fname": f"{prefix}confusion_matrix_epoch_{epoch}"})
    export_plot(plotter, config_dict.get_str_tuple(
        "meta/technical/export_plots_as") or ("png",))


def append_csv_row(path: str, row: Dict[str, Any]) -> None:
    if not is_main_process():  # every process holds the same row
        return
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
                threaded=None, cut_rows: bool = True):
    """Copy *depth* batches ahead to *device*, through pinned memory, so
    the copy overlaps the step; a batch whose transfer fails is logged and
    skipped (the per-batch error envelope).  Under data parallelism only
    this process's slice of a batch is copied, and under spatial sharding
    with *cut_rows* only its band of rows."""
    from ..data.loader import PinnedCopier, prefetch_to_device
    copy = PinnedCopier(device)
    spatial = "spatial" if cut_rows and grid().size("spatial") > 1 else None

    def put(batch):
        with span("medseg.h2d"):
            local = batch.pop(BalancedDataLoader.LOCAL_SLICE_KEY,
                              None) is not None
            return copy(shard_batch(batch, batch_dim=1,
                                    spatial_axis=spatial,
                                    already_local=local))

    def on_error(exc):
        if is_sticky_cuda_error(exc):
            raise exc
        handle_exception(exc, "Exception while transferring a batch.")

    return prefetch_to_device(iterator, size=depth, put=put,
                              on_error=on_error, threaded=threaded)


def _nonfinite(per_batch: Dict[str, Any]) -> Optional[torch.Tensor]:
    """A 0-d bool tensor: is any floating scalar of the step not finite?"""
    scalars = [v.float() for v in per_batch.values()
               if isinstance(v, torch.Tensor) and v.ndim == 0
               and v.is_floating_point()]
    if not scalars:
        return None
    return torch.isfinite(torch.stack(scalars)).all().logical_not()


def run_epoch(step_fn, state, metrics_state, loader,
              accumulation_scale: int = 1, train: bool = True,
              device=None, log_path: Optional[str] = None,
              calculator=None, on_batch: Optional[Callable] = None,
              threaded_prefetch=None, log_flush: int = 512,
              debug_nans: bool = False, cut_rows: bool = True):
    """One pass over *loader*.  Returns (state, metrics_state).

    The step's scalars are not read back per step: a read waits for the
    card.  They stay on the card, and a window of ``log_flush`` steps comes
    back in one copy; the same per-step CSV rows are then written in order.
    ``log_flush=1`` writes each row as its step ends.  With *debug_nans*
    each step also leaves a flag on the card that says whether one of its
    scalars is not finite; the flags come back with the window, and a set
    one raises FloatingPointError naming the steps.  ``cut_rows=False``
    leaves the rows of a spatially sharded batch to the step (which
    augments the whole image first)."""
    device = resolve_device(device)
    keep_rows = log_path is not None and calculator is not None
    rows: list = []  # per-step scalar dicts on the card, awaiting read-back
    flags: list = []  # per-step non-finite flags under debug_nans
    flushed = 0       # steps read back so far

    def _flush_rows():
        nonlocal flushed
        if not rows and not flags:
            return
        host = to_host({"rows": {str(i): r for i, r in enumerate(rows)},
                        "flags": {str(i): f for i, f in enumerate(flags)}})
        first, count = flushed, max(len(rows), len(flags))
        flushed += count
        rows.clear()
        flags.clear()
        for i in range(len(host["rows"])):
            append_csv_row(log_path,
                           calculator.batch_values_host(host["rows"][str(i)]))
        bad = [first + int(i) for i, f in host["flags"].items() if f]
        if bad:
            raise FloatingPointError(
                f"debug_nans: a non-finite loss, gradient norm or metric in "
                f"step(s) {bad} of this pass (the window of steps {first} "
                f"to {first + count - 1})")

    batches = _prefetched(_virtual_batches(loader, accumulation_scale),
                          device, threaded=threaded_prefetch,
                          cut_rows=cut_rows)
    for i in itertools.count():
        with span("medseg.loader_wait"):
            batch_stack = next(batches, None)
        if batch_stack is None:
            break
        try:
            if train:
                state, metrics_state, per_batch = step_fn(
                    state, metrics_state, batch_stack)
            else:
                metrics_state, per_batch = step_fn(
                    state, metrics_state, batch_stack)
            if keep_rows:
                rows.append(per_batch)
            if debug_nans:
                flag = _nonfinite(per_batch)
                if flag is not None:
                    flags.append(flag)
            if max(len(rows), len(flags)) >= max(1, int(log_flush)):
                _flush_rows()
            if on_batch is not None:
                on_batch(i, per_batch)
        except Exception as exc:  # noqa: BLE001 - reference error envelope
            if is_sticky_cuda_error(exc) \
                    or isinstance(exc, FloatingPointError):
                raise
            handle_exception(exc, f"Exception occured in batch {i}.")
    if flags:
        _flush_rows()  # a non-finite step raises past the envelope
    elif rows:
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
                host_loggers: Iterable = (),
                device_augment=None, prediction_index: int = 0,
                **kwargs) -> TrainState:
    """Train for the configured number of epochs.  Returns the final state.

    *model*'s module and the metric state live on *device* (the card
    unless named); batches are copied there by the loop.  *host_loggers*
    (``metrics.build_host_loggers``) run at their active epochs."""
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
    debug_nans = bool(tech.get("debug_nans", False))
    extensions = tech.get_str_tuple("export_plots_as") or ("png",)

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
    cm_active_epochs, cm_do_last = cm_log_epochs(
        config_dict.get("metrics/calculation", ConfigDict()))
    train_step = make_train_step(model, loss, calculator, optimizer,
                                 grad_clip_value=grad_clip_value,
                                 grad_clip_norm_type=grad_clip_norm_type,
                                 device_augment=device_augment,
                                 prediction_index=prediction_index)
    eval_step = make_eval_step(model, loss, calculator,
                               prediction_index=prediction_index)
    module = getattr(model, "module", model)

    main_process = is_main_process()
    profile_cfg = tech.get("profile", False) and main_process
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
        if not filenames or not main_process:
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

    def _evaluate(data):
        """An eval pass over *data*; returns the metric state."""
        _, metrics_state = run_epoch(
            eval_step, state, _init_metrics(), data, accumulation_scale,
            train=False, device=device, threaded_prefetch=threaded_prefetch,
            debug_nans=debug_nans)
        return metrics_state

    def _export_cm(metrics_state, epoch_1idx: int, train: bool) -> None:
        with swallow("Exception logging the confusion matrix."):
            _export_confusion_matrix(calculator, metrics_state, destination,
                                     epoch_1idx, config_dict, train=train)

    def _host_forward(x):
        """The metric-side prediction of the current weights for a host
        batch, back on the host (the loggers' forward)."""
        module.eval()
        with torch.inference_mode():
            batch = _dequantize_inputs(
                {"x": torch.as_tensor(np.asarray(x)).to(device)})
            pred = _select_prediction(module(batch["x"]), prediction_index)
            return pred.float().cpu().numpy()

    def _augmented_loader(loader):
        """*loader*'s batches through the device augmentation (its draws
        seeded by the batch index), back on the host."""
        if device_augment is None:
            return loader

        def gen():
            for i, batch in enumerate(loader):
                fragment = _dequantize_inputs(
                    {k: torch.as_tensor(np.asarray(v)).to(device)
                     for k, v in batch.items() if hasattr(v, "shape")})
                generator = torch.Generator(device=device).manual_seed(i)
                yield {k: v.cpu().numpy() for k, v in
                       device_augment(generator, fragment).items()}
        return gen()

    host_loggers = list(host_loggers or ())

    def run_host_loggers(epoch_1idx: int, last: bool = False) -> None:
        # on every process: the loggers draw batches from the loaders, and
        # the processes' streams must stay in step (they write on the main
        # process only)
        for logger in host_loggers:
            if not logger.active(epoch_1idx, last=last):
                continue
            with swallow("Exception in a host epoch logger."):
                logger.log(epoch_1idx, _augmented_loader(train_data),
                           _host_forward, train=True, last=last)
                if val_data:
                    logger.log(epoch_1idx, val_data, _host_forward,
                               train=False, last=last)

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

                # a torch.profiler trace of the first profiled epoch,
                # stopped however the train pass ends
                trace = None
                if profile_cfg and epoch == epoch_start:
                    with swallow("Could not start the profiler trace."):
                        trace = start_trace(device)
                try:
                    metrics_state = _init_metrics()
                    state, metrics_state = run_epoch(
                        train_step, state, metrics_state, train_data,
                        accumulation_scale, train=True, device=device,
                        log_path=destination + "batch_logs.csv"
                        if log_batches else None, calculator=calculator,
                        on_batch=timer, threaded_prefetch=threaded_prefetch,
                        log_flush=log_flush, debug_nans=debug_nans,
                        cut_rows=device_augment is None)
                finally:
                    if trace is not None:
                        with swallow("Could not stop the profiler trace."):
                            stop_trace(trace, profile_dir + "trace")
                    with swallow("Exception writing step_times.csv."):
                        _dump_step_times()
                row.update(_finalize(metrics_state))
                _mark("train_s")
                if log_to_device and calculator is not None \
                        and (epoch + 1) in cm_active_epochs:
                    _export_cm(metrics_state, epoch + 1, train=True)
                _mark("cm_export_s")

                if val_data:
                    metrics_state = _evaluate(val_data)
                    row.update({f"val_{k}": v for k, v in
                                _finalize(metrics_state).items()})
                    _mark("val_s")
                    if log_to_device and calculator is not None \
                            and (epoch + 1) in cm_active_epochs:
                        _export_cm(metrics_state, epoch + 1, train=False)
                    _mark("cm_export_s")

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
                    # whole files under tensor parallelism: a collective
                    # of every process, before the main process writes
                    save(model_files, full_state_dict(module))
                    save(["optimizer_state_dict.pt"], {
                        "optimizer": full_optimizer_state_dict(
                            state.optimizer),
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
                run_host_loggers(epoch + 1)
                _mark("loggers_s")
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

        if any(logger.do_last for logger in host_loggers):
            run_host_loggers(num_epochs, last=True)

        if calculator is not None and calculator.requires_last_pass:
            # the extra no-grad pass over train and val with the final
            # weights; its 'last' CM export
            with swallow("Exception in last pass."):
                metrics_state = _evaluate(_augmented_loader(train_data))
                if log_to_device and cm_do_last:
                    _export_cm(metrics_state, num_epochs, train=True)
                if val_data:
                    metrics_state = _evaluate(val_data)
                    if log_to_device and cm_do_last:
                        _export_cm(metrics_state, num_epochs, train=False)

        if calculator is not None:
            # end-of-training metric exports (train_model.py:294), e.g. the
            # classwise history plots read back from epoch_logs.csv
            with swallow("Exception in the end-of-training metric hooks."):
                calculator.evaluate_at_end(save_path=destination,
                                           extensions=extensions)

        if test_data:
            try:
                metrics_state = _evaluate(test_data)
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
