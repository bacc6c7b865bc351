"""The port's profiler spans (``utils/profiling.py``), on the CPU: where
the train step, the eval step, the metric set and the epoch loop open
them, read back through the benchmark's own trace parser; that with no
profiler a span enters nothing and leaves the step's arithmetic alone; and
the benchmark's readers of the spans, on a synthetic trace."""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
from medsegpretrainimagenet_tpu_torch.losses import DiceLoss, Loss
from medsegpretrainimagenet_tpu_torch.metrics import (AUCSpec,
                                                      MetricsCalculator)
from medsegpretrainimagenet_tpu_torch.metrics.hd95 import hd95_batch
from medsegpretrainimagenet_tpu_torch.models import Model
from medsegpretrainimagenet_tpu_torch.optim import Optimizer
from medsegpretrainimagenet_tpu_torch.train import (TrainState,
                                                    make_eval_step,
                                                    make_train_step)
from medsegpretrainimagenet_tpu_torch.train import loop
from medsegpretrainimagenet_tpu_torch.utils import profiling
from portbench import harness, spec, trace

from torch_port_helpers import build_model, unet_config

SIZE = 16
OPTIMIZER = {"sgd": {"momentum": 0.9, "learning_rate": 0.01}}
METRICS = {"metrics": {"metrics": ("metrics.DiceIndex",)}}


def _traced(run, tmp_path):
    """Run ``run()`` under a CPU profiler; its Chrome trace, parsed by the
    benchmark's parser, and what ``run`` returned."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    return trace.parse(events.get("traceEvents", events)), out


def _batch(n_frag=2, images=2, seed=0):
    """A (n_frag, images, SIZE, SIZE, ...) uint8 stack with square masks."""
    rng = np.random.default_rng(seed)
    x = (rng.random((n_frag, images, SIZE, SIZE, 3)) * 90).astype(np.uint8)
    mask = np.zeros((n_frag, images, SIZE, SIZE), np.uint8)
    mask[..., 4:10, 5:11] = 1
    x[mask.astype(bool)] += 150
    return {"x": torch.from_numpy(x), "mask": torch.from_numpy(mask)}


def _port(weights=None):
    """A tiny U-Net with its SGD state, Dice loss and Dice metric."""
    model = build_model(ConfigDict, registry, Model, unet_config())
    model.init(0)
    if weights is not None:
        model.module.load_state_dict(weights)
    optimizer = Optimizer(ConfigDict(OPTIMIZER), num_epochs=1,
                          batches_per_epoch=1)
    state = TrainState.create(model.module, optimizer.init(model.module),
                              seed=1)
    loss = Loss(DiceLoss, ConfigDict({"label type": "mask"}))
    calculator = MetricsCalculator(ConfigDict(METRICS), loss=loss)
    return model, optimizer, state, loss, calculator


def _ranges(t, name):
    return sorted(t.spans.get(name, []))


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_train_step_spans(tmp_path):
    """One train step over two fragments opens one ``medseg.train_step``,
    a forward and a backward per fragment inside it, then the optimizer
    and the metric set, in that order."""
    model, optimizer, state, loss, calculator = _port()
    step = make_train_step(model, loss, calculator, optimizer)
    t, _ = _traced(lambda: step(state, calculator.init_state("cpu"),
                                _batch()), tmp_path)
    (whole,) = _ranges(t, "medseg.train_step")
    forwards = _ranges(t, "medseg.forward")
    backwards = _ranges(t, "medseg.backward")
    (update,) = _ranges(t, "medseg.optimizer")
    (metrics,) = _ranges(t, "medseg.metrics")
    assert len(forwards) == len(backwards) == 2
    for f, b in zip(forwards, backwards):
        assert _inside(f, whole) and _inside(b, whole)
        assert f[1] <= b[0]
    assert forwards[1][0] >= backwards[0][1]
    assert backwards[-1][1] <= update[0] and update[1] <= metrics[0]
    assert _inside(update, whole) and _inside(metrics, whole)
    assert "medseg.eval_step" not in t.spans


def test_eval_step_spans(tmp_path):
    """One eval step over two fragments opens one ``medseg.eval_step``
    with a forward per fragment and then the metric set inside it, and no
    backward or optimizer."""
    model, _, _, loss, calculator = _port()
    step = make_eval_step(model, loss, calculator)
    t, _ = _traced(lambda: step(None, calculator.init_state("cpu"),
                                _batch()), tmp_path)
    (whole,) = _ranges(t, "medseg.eval_step")
    forwards = _ranges(t, "medseg.forward")
    (metrics,) = _ranges(t, "medseg.metrics")
    assert len(forwards) == 2
    assert all(_inside(f, whole) for f in forwards)
    assert forwards[-1][1] <= metrics[0] and _inside(metrics, whole)
    for name in ("medseg.train_step", "medseg.backward",
                 "medseg.optimizer"):
        assert name not in t.spans


def _masks(seed=0, b=3, n=24):
    rng = np.random.default_rng(seed)
    pred = torch.from_numpy(rng.random((b, n, n)) > 0.6)
    true = torch.zeros((b, n, n), dtype=torch.bool)
    true[:, 6:16, 4:14] = True
    return pred, true


def test_hd95_spans(tmp_path):
    """``hd95_batch`` opens its transform's span and then its
    percentile's, once each."""
    pred, true = _masks()
    t, _ = _traced(lambda: hd95_batch(pred, true), tmp_path)
    (edt,) = _ranges(t, "medseg.hd95.edt")
    (percentile,) = _ranges(t, "medseg.hd95.percentile")
    assert edt[1] <= percentile[0]


@pytest.mark.parametrize("kind,name", [
    ("area_under_roc", "medseg.auroc"),
    ("average_precision_score", "medseg.average_precision")])
def test_auc_span(tmp_path, kind, name):
    """``AUCSpec.update`` opens its kind's span once, and not the other
    kind's."""
    pred, true = _masks()
    auc = AUCSpec(kind)
    prediction = torch.rand(pred.shape, generator=torch.Generator()
                            .manual_seed(3))
    t, _ = _traced(lambda: auc.update(auc.init_state("cpu"), prediction,
                                      {"mask": true.int()}), tmp_path)
    assert len(_ranges(t, name)) == 1
    assert sorted(n for n in t.spans if n.startswith("medseg.")) == [name]


def test_no_profiler_no_range_and_same_step(tmp_path, monkeypatch):
    """With no profiler a span enters no ``record_function`` (patched
    here to raise), and the untraced step equals the traced one bit for
    bit: the loss, the gradient norm, the parameters and the buffers."""
    weights = {k: v.clone() for k, v in _port()[0].module.state_dict()
               .items()}

    def one_step():
        model, optimizer, state, loss, calculator = _port(weights)
        step = make_train_step(model, loss, calculator, optimizer,
                               grad_clip_value=0.05)
        _, _, per_batch = step(state, calculator.init_state("cpu"),
                               _batch(seed=4))
        return per_batch, model.module.state_dict()

    traced_t, (traced_values, traced_weights) = _traced(one_step, tmp_path)
    assert "medseg.train_step" in traced_t.spans

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no "
                             f"profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("medseg.train_step") \
        is profiling.span("medseg.forward")
    values, weights_after = one_step()
    assert set(values) == set(traced_values)
    for key, value in values.items():
        assert torch.equal(torch.as_tensor(value),
                           torch.as_tensor(traced_values[key])), key
    for key, value in weights_after.items():
        assert torch.equal(value, traced_weights[key]), key


def test_epoch_data_path_spans(tmp_path):
    """A two-batch CPU ``run_epoch`` opens ``medseg.h2d`` once a batch,
    and ``medseg.loader_wait`` once a batch and once more for the wait
    that finds the pass's end; each batch's wait ends before its step."""
    model, optimizer, state, loss, calculator = _port()
    step = make_train_step(model, loss, calculator, optimizer)
    batches = [{k: v[0].numpy() for k, v in _batch(seed=s).items()}
               for s in (1, 2)]
    t, _ = _traced(lambda: loop.run_epoch(
        step, state, calculator.init_state("cpu"), batches, device="cpu"),
        tmp_path)
    waits = _ranges(t, "medseg.loader_wait")
    steps = _ranges(t, "medseg.train_step")
    assert len(_ranges(t, "medseg.h2d")) == 2
    assert len(steps) == 2 and len(waits) == 3
    for wait, taken in zip(waits, steps):
        assert wait[1] <= taken[0]
    assert waits[-1][0] >= steps[-1][1]


# the benchmark's readers of the spans: (metric, kind, span)
READERS = [("forward_ms.train", "train", "medseg.forward"),
           ("backward_ms.train", "train", "medseg.backward"),
           ("optimizer_ms.train", "train", "medseg.optimizer"),
           ("forward_ms.eval", "eval", "medseg.forward"),
           ("hd95_edt_ms.eval", "eval", "medseg.hd95.edt"),
           ("hd95_percentile_ms.eval", "eval", "medseg.hd95.percentile"),
           ("auroc_ms.eval", "eval", "medseg.auroc")]


def _span_trace(span):
    """A 10 ms window of two steps: in each a kernel of 1.5 ms launched
    inside *span* (when given), one of 2 ms launched outside it, and a
    copy with no launch."""
    events = [{"ph": "X", "cat": "user_annotation", "name": "window",
               "ts": 0, "dur": 10000, "tid": 1}]
    for i, at in enumerate((1000, 6000)):
        if span is not None:
            events.append({"ph": "X", "cat": "user_annotation",
                           "name": span, "ts": at, "dur": 500, "tid": 1})
        events += [
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "ts": at + 100, "dur": 5, "tid": 1,
             "args": {"correlation": 2 * i + 1}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "ts": at + 700, "dur": 5, "tid": 1,
             "args": {"correlation": 2 * i + 2}},
            {"ph": "X", "cat": "kernel", "name": "inside", "ts": at + 200,
             "dur": 1500, "args": {"correlation": 2 * i + 1}},
            {"ph": "X", "cat": "kernel", "name": "outside", "ts": at + 1800,
             "dur": 2000, "args": {"correlation": 2 * i + 2}},
            {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
             "ts": at + 3900, "dur": 100, "args": {}}]
    return trace.parse(events)


def _record(kind, spans):
    return harness.Record(trace=_span_trace(None), steps=2,
                          wall_step_s=0.005, images_per_step=8, chips=1,
                          flops_per_step=1e9, peak_flops=989e12, kind=kind,
                          spans=spans, span_steps=2)


@pytest.mark.parametrize("metric,kind,name", READERS,
                         ids=[r[0] for r in READERS])
def test_span_readers(metric, kind, name):
    """Each reader gives the device ms a step launched inside its span,
    and None for the other kind, for a trace without its span and for no
    record."""
    reader = spec.load_module("metrics", metric)
    assert reader.SPAN == name
    assert reader.read(_record(kind, _span_trace(name))) \
        == pytest.approx(1.5)
    other = "eval" if kind == "train" else "train"
    assert reader.read(_record(other, _span_trace(name))) is None
    assert reader.read(_record(kind, _span_trace(None))) is None
    assert reader.read(_record(kind, _span_trace("medseg.elsewhere"))) \
        is None
    assert reader.read(_record(kind, None)) is None
    assert reader.read(None) is None
    listed = {m["name"]: m for m in spec.load_benchmark()["per_layer"]}
    assert listed[metric]["source"] == "device_trace"
