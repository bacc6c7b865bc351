"""One run of one cell: set-up, the measured window, the check, the line.

``run_cell`` hands the cell's entry a :class:`Context`, gets back an
:class:`Outcome` (the end-to-end readings, the numbers compared, the
traced window's :class:`Record`), reads the cell's per-layer metrics from
the record with their readers, and builds the result line.  Which metrics a
cell reports is what ``BENCHMARK.json`` lists for it.
"""
from __future__ import annotations

import math
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from . import spec
from .check import judge
from .trace import Trace

__all__ = ["Context", "Outcome", "Record", "run_cell", "FORBIDDEN",
           "forbidden_modules", "TRACE_SECONDS"]

#: top-level module names that may not be loaded in the printing process
FORBIDDEN = ("jax", "jaxlib", "flax", "medsegpretrainimagenet_tpu")
#: the traced window is at most this long: its trace is read in memory
TRACE_SECONDS = 3.0
#: steps traced with the host's calls and ranges after the traced window
SPAN_STEPS = 3


@dataclass
class Context:
    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    started: float            # perf_counter at the run's start
    faults: tuple = ()        # planted by tests and readings, never a run
    rank: Optional[Any] = None  # ranks.Rank of a cell on several cards


@dataclass
class Record:
    """What a per-layer reader reads: the traced window and its work.

    A traced run times ``steps`` steps untraced (``wall_step_s`` each),
    then traces as many with the device and CUDA calls recorded
    (``trace``; the tracing slows a Swin step by about 15 %),
    then ``span_steps`` more with the host's calls and the benchmark's
    ranges recorded too (``spans``), which slows the host more."""
    trace: Trace
    steps: int
    wall_step_s: float             # a step of the untraced window
    images_per_step: int
    chips: int
    flops_per_step: float          # model FLOPs of one step, all chips
    peak_flops: float              # one chip's peak in the compute dtype
    attention_bound_s: Dict[str, float] = field(default_factory=dict)
    kind: str = "train"            # train or eval
    spans: Optional[Trace] = None
    span_steps: int = 0


@dataclass
class Outcome:
    e2e: Dict[str, float]
    numbers: Dict[str, float]
    attempted: int
    device: Dict[str, Any]
    record: Optional[Record] = None
    failed: int = 0


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(ctx: Context, bench: dict) -> Optional[dict]:
    """Run *ctx*'s cell once and return the result line's object (None on
    a rank but the first of a cell on several cards)."""
    cell = ctx.cell
    entry = spec.load_module("entries", cell.workload["entry"])
    outcome = entry.run(ctx)
    if outcome is None:
        return None
    correct, rows = judge(outcome.numbers, cell.limits)
    metrics: Dict[str, Dict[str, Any]] = {}
    if ctx.trace:
        for m in spec.cell_metrics(bench, cell.name, "per_layer"):
            value = spec.load_module("metrics", m["name"]).read(
                outcome.record)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec.cell_metrics(bench, cell.name, "end_to_end"):
            if m["name"] in outcome.e2e:
                metrics[m["name"]] = {"value": outcome.e2e[m["name"]],
                                      "unit": m["unit"]}
    line = {"correct": bool(correct), "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics,
            "device": outcome.device}
    if ctx.trace and outcome.record is not None:
        record = outcome.record
        gaps = (record.spans or record.trace).gaps
        line["breakdown"] = {
            "device_ops": record.trace.device_ops(10),
            "idle_gaps": [[name[:200], s] for name, s in gaps[:10]]}
    line["compared"] = [[name, value, limit] for name, value, limit in rows]
    return line
