"""Tracing of the port: the ``torch.profiler`` session of
``meta/technical/profile`` and the spans its hot path opens.

``span(name)`` opens ``torch.profiler.record_function(name)`` while a
``torch.profiler`` session records on the calling thread, and otherwise
returns one shared null context.  The profiler being on is the switch:
there is no setting.  Off, a span costs one C-level check (0.1 µs against
a bare ``record_function``'s 15 µs, torch 2.13's CPU build).  A span reads
no tensor, syncs nothing and keeps no reference.  A thread the profiler
does not record (the threaded prefetcher's worker) opens none.

Every span name starts with ``medseg.``.  The spans, and the per-layer
metrics of the benchmark (``portbench/metrics/``) that read them as the
device ms a step of the kernels launched inside:

* ``medseg.train_step``: a whole call of the train step; the
  operator's trace.
* ``medseg.forward``: each fragment's forward, in the train and the eval
  step; ``forward_ms.train``, ``forward_ms.eval``.
* ``medseg.backward``: each fragment's ``loss.backward()``;
  ``backward_ms.train``.
* ``medseg.optimizer``: the zero gradients of parameters the loss did not
  reach, the gradient reduction, the fragment scaling, the norm and clip,
  the learning rate and the update; ``optimizer_ms.train``.
* ``medseg.eval_step``: a whole call of the eval step; the operator's
  trace.
* ``medseg.metrics``: ``MetricsCalculator.update``; the operator's trace.
* ``medseg.hd95.edt``: HD95's distance transform of the borders;
  ``hd95_edt_ms.eval``.
* ``medseg.hd95.percentile``: HD95's masked 95th percentile;
  ``hd95_percentile_ms.eval``.
* ``medseg.auroc``, ``medseg.average_precision``: ``AUCSpec.update`` (the
  per-batch sort and the histogram); ``auroc_ms.eval`` reads the first.
* ``medseg.loader_wait``: the epoch loop taking its next batch from the
  prefetcher; the operator's trace.
* ``medseg.h2d``: the prefetcher's pinned copy of a batch to the device;
  the operator's trace.

The backward's kernels are launched on the autograd engine's thread while
the calling thread waits inside ``medseg.backward``; a kernel belongs to a
span when the host call that launched it falls inside the span's time.
"""
from __future__ import annotations

import contextlib
import os

import torch

__all__ = ["span", "start_trace", "stop_trace"]

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A profiler range *name* while the profiler records, else a shared
    null context."""
    if _recording():
        return torch.profiler.record_function(name)
    return _OFF


def start_trace(device: torch.device):
    """A started ``torch.profiler`` trace of the host and, on the card, of
    its kernels."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    trace = profile(activities=activities)
    trace.start()
    return trace


def stop_trace(trace, directory: str) -> None:
    """Stop *trace* and write it as a Chrome trace into *directory*."""
    trace.stop()
    os.makedirs(directory, exist_ok=True)
    trace.export_chrome_trace(os.path.join(directory, "trace.json"))
