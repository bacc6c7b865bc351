"""The two sessions the entries run: training steps and evaluation steps.

Set-up builds the port's step once and drives it through its first steps
on distinct batches of the pool (the steps the check reads), warms up,
and estimates a step's time.  The window then dispatches a fixed number of
steps, sized to the cell's seconds, with no host sync among them, and
ends with a synchronise; its rate is all images over all its time.  After
the window the program is freed, and the reference recomputes what the
check compares.

Training also runs as one rank of several (``ctx.rank``, one card each,
``portbench/ranks.py``): each rank joins the process group and builds the
step as the port's command line does under a launcher, feeds its slice of
every global batch (``shard_batch``), and the step takes BatchNorm's
statistics over the global batch and sums the gradients once a step.  The
ranks agree on the window's steps, the largest peak is the run's, and
rank 0 alone checks: the global step against the one-card reference of
the whole global batch, and every rank's model against rank 0's.
"""
from __future__ import annotations

import contextlib
import gc
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from . import bounds, faults, flops, port, ranks, spec, traffic, weights
from .check import eval_numbers, train_numbers, worst_leaves
from .harness import SPAN_STEPS, TRACE_SECONDS, Context, Outcome, Record
from .peaks import PEAK_FLOPS, power_limit
from .reference.train import eval_reference, metric_values, train_reference
from .trace import profile_window

__all__ = ["train", "evaluate", "CHECK_STEPS", "SAMPLED"]

#: training steps the check follows, run in set-up through the window's
#: own step object and feed
CHECK_STEPS = 3
#: steps timed in set-up to size the window
CALIBRATION_STEPS = 3
#: evaluated batches of the pool that the check samples
SAMPLED = 2
_GIB = 2 ** 30


def _note(ctx, what: str) -> None:
    """A line of the run's own record on standard error."""
    print(f"portbench: {what} at {time.perf_counter() - ctx.started:.3f} s",
          file=sys.stderr, flush=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _lr_momentum(tree: dict):
    sgd = tree["training"]["optimizer"]["sgd"]
    lr = sgd["learning_rate"]["constant"]["base"]
    return float(lr), float(sgd["momentum"])


def _image(cell) -> tuple:
    return int(cell.config["image_size"]), int(cell.config["in_channels"])


def _weights_fn(cell, seed, device):
    scheme = cell.config["weights"]
    return lambda leaves: weights.make_weights(leaves, scheme, seed, device)


def _pool(cell, seed, device, shard=None):
    """Every pool batch, pinned on the host; with *shard*, this rank's
    slice of each (``port.shard``)."""
    size, channels = _image(cell)
    pool = traffic.pin(traffic.make_pool(cell.traffic, size, channels, seed,
                                         device))
    return pool if shard is None else [shard(batch) for batch in pool]


def _feeder(host, device):
    def feed(i: int) -> dict:
        with torch.profiler.record_function("h2d"):
            return {k: v.to(device, non_blocking=True)[None]
                    if isinstance(v, torch.Tensor) else v
                    for k, v in host[i % len(host)].items()}
    return feed


def _device_info(device, chips, peak, busy=None, window=None) -> dict:
    """The line's ``device``, with the card's power limit beside it (a
    card below 700 W runs slower, and every share reads against the
    700 W peaks)."""
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device)
            if device.type == "cuda" else "cpu",
            "count": chips, "memory_peak_bytes": int(peak),
            "power_limit": power_limit() if device.type == "cuda"
            else "none"}
    if busy is not None:
        info["busy_s"] = busy
        info["window_s"] = window
    return info


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def _reset_peak(device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _steps_for(seconds: float, step_s: float) -> int:
    return max(3, int(round(seconds / max(step_s, 1e-6))))


def _window(run, n: int, device, trace: bool, align=None):
    """Run *n* steps (``run(k)``) between two synchronises: (seconds,
    (trace, spans) or None).  Traced, *n* more steps run under the
    profiler recording the device and the CUDA calls, then SPAN_STEPS
    more with the host's calls and ranges too; the seconds are those of
    the untraced steps.  ``align()`` runs before each profiled window
    (the ranks of a cell on several cards meet there: each reads its
    trace for seconds, and a rank that starts late would stall the
    others' first steps in the window)."""
    def steps(first, count):
        for k in range(first, first + count):
            run(k)
        _sync(device)

    _sync(device)
    t0 = time.perf_counter()
    steps(0, n)
    seconds = time.perf_counter() - t0
    if not trace:
        return seconds, None
    align = align or (lambda: None)
    align()
    traced = profile_window(lambda: steps(n, n), host=False)
    align()
    spans = profile_window(lambda: steps(2 * n, SPAN_STEPS), host=True)
    return seconds, (traced, spans)


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _reference_mode():
    """Float32 products without TF32, cuDNN's default algorithms (no
    autotuning of the reference's shapes)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False


def _attention_bounds(cell, arch, batch: int, kind: str) -> Dict[str,
                                                                float]:
    if cell.workload.get("attention", "k1") != "k1":
        return {}
    calls = arch.attention_calls(arch.shape_of(cell.config["tree"]), batch)
    if not calls:
        return {}
    dtype = cell.workload["compute_dtype"]
    out = {"forward": bounds.forward_bound_s(calls, dtype)}
    if kind == "train":
        out["backward"] = bounds.backward_bound_s(calls, dtype)
    return out


def _record(ctx, traces, steps, window_s, batch, chips, port_,
            kind, arch) -> Record:
    cell = ctx.cell
    size, channels = _image(cell)
    macs = flops.forward_macs(arch, cell.config["tree"], size, channels,
                              {n: s for n, s, d in port_.leaves
                               if d.is_floating_point})
    per_image = flops.train_flops(macs) if kind == "train" \
        else flops.eval_flops(macs)
    return Record(trace=traces[0], steps=steps, wall_step_s=window_s / steps,
                  images_per_step=batch,
                  chips=chips, flops_per_step=float(per_image * batch),
                  peak_flops=PEAK_FLOPS[cell.workload["compute_dtype"]],
                  attention_bound_s=_attention_bounds(cell, arch, batch,
                                                      kind),
                  kind=kind, spans=traces[1],
                  span_steps=SPAN_STEPS)


def _norms(named: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(named)
    if not names:
        return {}
    values = torch.stack([named[n].detach().float().norm()
                          for n in names]).cpu().tolist()
    return dict(zip(names, values))


def train(ctx: Context) -> Optional[Outcome]:
    """The training session, on one card or as one rank of several (then
    None on every rank but 0)."""
    cell, device, seed, rank = ctx.cell, ctx.device, ctx.seed, ctx.rank
    world = rank.world if rank is not None else 1
    batch = int(cell.traffic["batch"])          # the global batch
    tree = cell.config["tree"]
    arch = spec.load_arch(cell.config)
    port.apply_switches(tree, device)
    with port.route(cell.workload), contextlib.ExitStack() as stack:
        if rank is not None:
            stack.enter_context(port.one_build_at_a_time())
            port.join(device)
        _note(ctx, "imports done")
        prt, init = port.build(tree, cell.workload["metrics"], device, seed,
                               _weights_fn(cell, seed, device))
        if rank is not None:
            port.replicate(prt.module)
        stack.enter_context(faults.patched(ctx.faults, prt.module))
        step = faults.wrap_step(ctx.faults, port.train_step(
            prt, port.MetricsRange(prt.calculator)))
        _note(ctx, "model built")
        feed = _feeder(_pool(cell, seed, device,
                             port.shard if rank is not None else None),
                       device)
        _note(ctx, "pool made")
        state, metrics_state = prt.state, prt.calculator.init_state(device)
        loss_name = prt.calculator.loss_name
        names = {p: n for n, p in prt.module.named_parameters()}

        def run(i):
            nonlocal state, metrics_state
            with torch.profiler.record_function("step"):
                state, metrics_state, per_batch = step(state, metrics_state,
                                                       feed(i))
            return per_batch

        losses = []
        for i in range(CHECK_STEPS):
            losses.append(run(i)[loss_name])
            if i == 0:
                first = _norms({names[p]: s["momentum_buffer"] for p, s in
                                state.optimizer.state.items()})
        prog = {"loss": torch.stack(losses).float().cpu().tolist(),
                "grad": first,
                "change": _norms({n: p - init[n] for n, p in
                                  prt.module.named_parameters()}),
                "stats": _norms({n: b - init[n] for n, b in
                                 prt.module.named_buffers()
                                 if n.endswith(("running_mean",
                                                "running_var"))})}
        if rank is not None:
            replicas = ranks.replica_gap(prt.module)
        del init
        _note(ctx, "checked steps done")
        _sync(device)
        t0 = time.perf_counter()
        for k in range(CALIBRATION_STEPS):
            run(CHECK_STEPS + k)
        _sync(device)
        _note(ctx, "calibrated")
        step_s = (time.perf_counter() - t0) / CALIBRATION_STEPS
        seconds = min(ctx.seconds, TRACE_SECONDS) if ctx.trace \
            else ctx.seconds
        n = _steps_for(seconds, step_s)
        if rank is not None:
            n = ranks.agree(n, device)
            ranks.barrier(device)
        offset = CHECK_STEPS + CALIBRATION_STEPS
        setup_s = time.perf_counter() - ctx.started
        _reset_peak(device)
        window_s, traces = _window(
            lambda k: run(offset + k), n, device, ctx.trace,
            align=(lambda: ranks.barrier(device)) if rank is not None
            else None)
        trace = traces[0] if traces else None
        peak = _peak(device)
        busy = trace.busy_s() if trace is not None else None
        if rank is not None:
            peak = int(ranks.largest(peak, device))
            if busy is not None:
                busy = ranks.total(busy, device) / world
        if rank is not None and rank.index != 0:
            del prt, state, metrics_state, step, feed, run, names
            _free()
            return None
        record = _record(ctx, traces, n, window_s, batch, world, prt,
                         "train", arch) if traces else None
        leaves = prt.leaves
        del prt, state, metrics_state, step, feed, run, names
        _free()
    # the reference, on the same weights and the same three (global)
    # batches
    _reference_mode()
    size, channels = _image(cell)
    ref_pool = traffic.make_pool(cell.traffic, size, channels, seed, device)
    ref_weights = weights.make_weights(leaves, cell.config["weights"], seed,
                                       device)
    lr, momentum = _lr_momentum(tree)
    ref = train_reference(arch, tree, ref_weights, ref_pool[:CHECK_STEPS],
                          seed, lr, momentum, ckpt=device.type == "cuda")
    del ref_pool, ref_weights
    numbers = train_numbers(prog, ref)
    if rank is not None:
        numbers["replicas"] = replicas
    for key in ("grad", "change", "stats"):
        for row in worst_leaves(prog[key], ref[key]) if ref[key] else []:
            print(f"portbench: worst {key} leaves: {row}", file=sys.stderr)
    _note(ctx, "reference done")
    return Outcome(
        e2e={"setup_s": setup_s,
             "train_images_per_s": n * batch / window_s,
             "peak_mem_gib": peak / _GIB},
        numbers=numbers, attempted=n,
        device=_device_info(device, world, peak, busy,
                            trace.window_s if trace else None),
        record=record)


def evaluate(ctx: Context) -> Outcome:
    """The evaluation session: the eval step over the pool, its metric
    set, a sample of its batches checked."""
    cell, device, seed = ctx.cell, ctx.device, ctx.seed
    batch = int(cell.traffic["batch"])
    pool_size = int(cell.traffic["pool"])
    tree = cell.config["tree"]
    arch = spec.load_arch(cell.config)
    rng = np.random.default_rng(traffic.stream_seed(seed, 2))
    sample = sorted(int(i) for i in rng.choice(pool_size, SAMPLED,
                                                replace=False))
    port.apply_switches(tree, device)
    with port.route(cell.workload), contextlib.ExitStack() as stack:
        _note(ctx, "imports done")
        prt, init = port.build(tree, cell.workload["metrics"], device, seed,
                               _weights_fn(cell, seed, device))
        del init
        stack.enter_context(faults.patched(ctx.faults, prt.module))
        _note(ctx, "model built")
        prt.module.eval()
        calculator = port.MetricsRange(prt.calculator)
        step = port.eval_step(prt, calculator)
        feed = _feeder(_pool(cell, seed, device), device)
        metrics_state = prt.calculator.init_state(device)

        def run(i):
            nonlocal metrics_state
            calculator.current = i % pool_size
            with torch.profiler.record_function("step"):
                metrics_state, _ = step(None, metrics_state, feed(i))

        for i in range(2):
            run(i)
        _sync(device)
        _note(ctx, "warmed up")
        t0 = time.perf_counter()
        for k in range(CALIBRATION_STEPS):
            run(k)
        _sync(device)
        step_s = (time.perf_counter() - t0) / CALIBRATION_STEPS
        seconds = min(ctx.seconds, TRACE_SECONDS) if ctx.trace \
            else ctx.seconds
        n = max(pool_size, _steps_for(seconds, step_s))
        calculator.keep = {i: None for i in sample}
        setup_s = time.perf_counter() - ctx.started
        _reset_peak(device)
        window_s, traces = _window(run, n, device, ctx.trace)
        trace = traces[0] if traces else None
        peak = _peak(device)
        kept = []
        for i in sample:
            prediction, per_batch = calculator.keep[i]
            values = prt.calculator.batch_values(per_batch)
            kept.append({"prediction": prediction[..., 0].float().cpu(),
                         "values": _eval_values(values,
                                                prt.calculator.loss_name)})
        record = _record(ctx, traces, n, window_s, batch, 1, prt, "eval",
                         arch) if traces else None
        leaves = prt.leaves
        del prt, calculator, step, feed, run, metrics_state
        _free()
    _reference_mode()
    size, channels = _image(cell)
    ref_pool = traffic.make_pool(cell.traffic, size, channels, seed, device)
    ref_weights = weights.make_weights(leaves, cell.config["weights"], seed,
                                       device)
    refs, own = [], []
    for i, prog in zip(sample, kept):
        out = eval_reference(arch, tree, ref_weights, ref_pool[i])
        refs.append({"prediction": out["prediction"].cpu(),
                     "values": out["values"]})
        own.append(metric_values(prog["prediction"].numpy(),
                                 ref_pool[i]["mask"].cpu().numpy()
                                 .astype(bool)))
    del ref_pool, ref_weights
    numbers = eval_numbers(kept, refs, own)
    _note(ctx, "reference done")
    busy = trace.busy_s() if trace is not None else None
    return Outcome(
        e2e={"setup_s": setup_s, "eval_images_per_s": n * batch / window_s,
             "peak_mem_gib": peak / _GIB},
        numbers=numbers, attempted=n,
        device=_device_info(device, 1, peak, busy,
                            trace.window_s if trace else None),
        record=record)


_EVAL_KEYS = (("dice_index", "dice"), ("jaccard_index", "jaccard"),
              ("mcc", "mcc"), ("hausdorff", "hd95"),
              ("area_under_roc", "auroc"))


def _eval_values(values: Dict[str, float], loss_name: str) -> Dict[str,
                                                                    float]:
    out = {"loss": values[loss_name]}
    for key, value in values.items():
        for fragment, name in _EVAL_KEYS:
            if fragment in key and "pooled" not in key:
                out[name] = value
    return out
