"""The traced run's record: ``torch.profiler`` over the window, read back
from its Chrome trace.

The window runs inside a host range ``window``; the benchmark's own spans
(``step``, ``h2d``, ``metrics``) are host ranges too.  A kernel belongs to
a span when the host call that launched it lies inside the span (the
trace's correlation ids tie the two).  Device busy time is the union of
the intervals of every kernel, copy and set on the device inside the
window, so overlapping kernels (NCCL beside compute) count once.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["Kernel", "Trace", "profile_window", "parse", "union_s"]

_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH = ("cuda_runtime", "cuda_driver")
_HOST = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclass
class Kernel:
    name: str
    start: float      # seconds, trace clock
    dur: float        # seconds
    launched: Optional[float]  # when the host launched it, seconds
    kind: str         # kernel, gpu_memcpy, gpu_memset


@dataclass
class Trace:
    window: Tuple[float, float]
    device: List[Kernel]
    spans: Dict[str, List[Tuple[float, float]]] = field(default_factory=dict)
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernels(self) -> List[Kernel]:
        return [k for k in self.device if k.kind == "kernel"]

    def busy_s(self) -> float:
        return union_s([(k.start, k.start + k.dur) for k in self.device],
                       self.window)

    def in_span(self, name: str) -> List[Kernel]:
        """Kernels launched from inside the host ranges *name*."""
        ranges = sorted(self.spans.get(name, []))
        starts = [r[0] for r in ranges]
        out = []
        for k in self.device:
            if k.launched is None:
                continue
            i = bisect.bisect_right(starts, k.launched) - 1
            if i >= 0 and ranges[i][0] <= k.launched <= ranges[i][1]:
                out.append(k)
        return out

    def device_ops(self, top: int = 10) -> List[list]:
        totals: Dict[str, float] = {}
        for k in self.device:
            totals[k.name] = totals.get(k.name, 0.0) + k.dur
        return [[name[:200], s] for name, s in
                sorted(totals.items(), key=lambda kv: -kv[1])[:top]]


def union_s(intervals, window) -> float:
    lo, hi = window
    total, end = 0.0, lo
    for start, stop in sorted(intervals):
        start, stop = max(start, end), min(stop, hi)
        if stop > start:
            total += stop - start
            end = stop
    return total


def profile_window(run, host: bool = True) -> Trace:
    """Run ``run()`` (the window, which ends with a synchronise) under the
    profiler inside a host range ``window``, and read its trace.

    ``host=False`` records the device and the CUDA calls only, which
    costs the host little: the window is then the span from the first
    CUDA call to the end of the last (the closing synchronise), and there
    are no host ranges."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU] if host or \
        not torch.cuda.is_available() else []
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function("window"):
            run()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    return parse(events.get("traceEvents", events)
                 if isinstance(events, dict) else events)


def parse(events: List[dict]) -> Trace:
    """A :class:`Trace` of the Chrome trace events of one profiled
    window (timestamps in microseconds)."""
    spans: Dict[str, List[Tuple[float, float]]] = {}
    launches: Dict[int, float] = {}
    host = []
    device = []
    window_tid = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]) * 1e-6, float(e.get("dur", 0)) * 1e-6
        corr = (e.get("args") or {}).get("correlation")
        if cat in _DEVICE:
            device.append((e, ts, dur, corr))
        elif cat in _HOST:
            if cat in _LAUNCH and corr is not None:
                launches[corr] = ts
            if cat == "user_annotation":
                spans.setdefault(e["name"], []).append((ts, ts + dur))
                if e["name"] == "window":
                    window_tid = e.get("tid")
            host.append((ts, ts + dur, e["name"], e.get("tid")))
    if "window" in spans:
        window = spans["window"][0]
    else:
        calls = [(ts, end) for ts, end, _, _ in host]
        if not calls:
            raise ValueError("the trace holds no 'window' range and no "
                             "CUDA call")
        window = (min(c[0] for c in calls), max(c[1] for c in calls))
    kernels = [Kernel(e["name"], ts, dur, launches.get(corr), e["cat"])
               for e, ts, dur, corr in device
               if ts < window[1] and ts + dur > window[0]]
    trace = Trace(window=window, device=kernels, spans=spans)
    trace.gaps = _idle_gaps(kernels, window,
                            [h for h in host if window_tid is None
                             or h[3] == window_tid])
    return trace


def _idle_gaps(kernels: List[Kernel], window, host) -> List[Tuple[str, float]]:
    """Idle seconds of the device in the window, summed by the innermost
    host call that was running when each idle stretch began."""
    gaps, end = [], window[0]
    for k in sorted(kernels, key=lambda k: k.start):
        if k.start > end:
            gaps.append((end, min(k.start, window[1])))
        end = max(end, k.start + k.dur)
    if end < window[1]:
        gaps.append((end, window[1]))
    host = sorted((h for h in host if h[2] != "window"),
                  key=lambda h: (h[0], -h[1]))
    totals: Dict[str, float] = {}
    stack: List[tuple] = []
    i = 0
    for g0, g1 in gaps:
        while i < len(host) and host[i][0] <= g0:
            while stack and stack[-1][1] <= host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] <= g0:
            stack.pop()
        name = stack[-1][2] if stack else "host, outside any traced call"
        totals[name] = totals.get(name, 0.0) + (g1 - g0)
    return sorted(totals.items(), key=lambda kv: -kv[1])
