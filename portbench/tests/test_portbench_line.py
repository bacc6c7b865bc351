"""The result line: its keys, the compared numbers last, the per-layer
readers over a trace, and the refusals of ``python3 -m portbench.run``."""
import json
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness, ranks, run, spec, trace
from portbench.tests.cells import small_cell

BENCH = spec.load_benchmark()


def cpu_line(name, traced):
    ctx = harness.Context(cell=small_cell(name), seed=1234567890123,
                          seconds=0.2, trace=traced,
                          device=torch.device("cpu"),
                          started=time.perf_counter())
    return harness.run_cell(ctx, BENCH)


@pytest.mark.parametrize("traced", [False, True])
def test_line_keys(traced):
    out = cpu_line("unet_256.train_b32", traced)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "compared"
    assert {"platform", "kind", "count", "memory_peak_bytes"} \
        <= set(out["device"])
    if traced:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert {"setup_s", "train_images_per_s", "peak_mem_gib"} \
            == set(out["metrics"])
    json.dumps(out)


def synthetic_trace():
    """A window of 10 ms: two kernels overlapping (a collective beside a
    conv), a copy, and a kernel launched inside a ``metrics`` range."""
    us = 1.0
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "window", "ts": 0,
         "dur": 10000, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "metrics",
         "ts": 5000, "dur": 1000, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv", "ts": 100,
         "dur": 50, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 110, "dur": 5, "tid": 1, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 5100, "dur": 5, "tid": 1, "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_conv", "ts": 1000,
         "dur": 3000 * us, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "ncclDevKernel_AllReduce",
         "ts": 2000, "dur": 3000, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "radixSortKernel",
         "ts": 6000, "dur": 1000, "args": {"correlation": 3}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 8000,
         "dur": 500, "args": {}}]
    return trace.parse(events)


def test_trace_union_and_spans():
    t = synthetic_trace()
    assert t.window_s == pytest.approx(0.01)
    assert t.busy_s() == pytest.approx(0.0055)   # 1.0-5.0, 6.0-7.0, 8-8.5
    assert [k.name for k in t.in_span("metrics")] == ["radixSortKernel"]
    assert len(t.kernels()) == 3
    assert sum(s for _, s in t.gaps) == pytest.approx(0.0045)


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_readers_on_a_trace(metric):
    kind = "eval" if metric["name"].endswith(".eval") else "train"
    record = harness.Record(trace=synthetic_trace(), steps=2,
                            wall_step_s=0.005,
                            images_per_step=8, chips=4, flops_per_step=1e9,
                            peak_flops=989e12,
                            attention_bound_s={"forward": 1e-4,
                                               "backward": 2e-4},
                            kind=kind, spans=synthetic_trace(),
                            span_steps=2)
    value = spec.load_module("metrics", metric["name"]).read(record)
    # a metric not named here reads nothing on this trace: it holds no
    # span of the port and no kernel of a group but the collective
    expected = {"idle_share.train": 45.0, "idle_share.eval": 45.0,
                "mfu.train": 100 * 2e9 / 0.01 / (4 * 989e12),
                "mfu.eval": 100 * 2e9 / 0.01 / (4 * 989e12),
                "launches.train": 1.5, "metrics_ms.eval": 0.5,
                "collective_ms.train": 1.5}.get(metric["name"])
    assert value == pytest.approx(expected) if expected is not None \
        else value is None


def test_collective_reader_on_a_trace():
    # the reader of a cell on several cards, which BENCHMARK.json does not
    # list yet: the all-reduce's 3 ms over 2 steps; nothing without NCCL
    reader = spec.load_module("metrics", "collective_ms.train")
    record = harness.Record(trace=synthetic_trace(), steps=2,
                            wall_step_s=0.005, images_per_step=8, chips=4,
                            flops_per_step=1e9, peak_flops=989e12)
    assert reader.read(record) == pytest.approx(1.5)
    record.trace.device = [k for k in record.trace.device
                           if "nccl" not in k.name.lower()]
    assert reader.read(record) is None


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "unet_256.train_b32", "--seed", "3", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=spec.ROOT, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_run_refuses_in_a_bare_checkout(tmp_path):
    import shutil
    shutil.copytree(spec.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "unet_256.train_b32", "--seed", "3", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_forbidden_modules_named_whole(monkeypatch):
    import types
    monkeypatch.setitem(sys.modules, "medsegpretrainimagenet_tpu_torch_x",
                        types.ModuleType("x"))
    assert "medsegpretrainimagenet_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax.core", types.ModuleType("y"))
    assert "flax" in harness.forbidden_modules()
    assert run.STARTED > 0


@pytest.mark.gpu
def test_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "unet_256.train_b32", "--seed", "2147483659", "--seconds", "2",
         "--trace", "0"], capture_output=True, text=True, cwd=spec.ROOT,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"


def test_launch_relays_rank_0(monkeypatch):
    # only rank 0 writes to standard output, and its line comes back
    monkeypatch.chdir(spec.ROOT)
    code, out = ranks.launch("portbench.tests.echo_rank", [], 3,
                             time.time())
    assert code == 0
    assert out.splitlines() == ["rank 0 of 3 on standard output",
                                json.dumps({"rank": 0, "world": 3,
                                            "compared": []})]


def test_launch_prints_nothing_when_a_rank_fails(monkeypatch):
    monkeypatch.chdir(spec.ROOT)
    assert ranks.launch("portbench.tests.echo_rank", ["--fail", "2"], 3,
                        time.time()) == (1, "")


def test_launch_refuses_jax_on_any_rank(monkeypatch):
    # a rank but the first holds a module named flax once its run ends:
    # its check fails it, and the launch gives no line
    monkeypatch.chdir(spec.ROOT)
    assert ranks.launch("portbench.tests.echo_rank", ["--load", "1"], 3,
                        time.time()) == (1, "")
