"""The port's epoch loop and checkpoint writers against the JAX package's,
on the CPU: ``train_model`` over the two packages' loaders (bit-equal
batches) for three epochs in float32 from transplanted weights, with
gradient accumulation over two fragments, a validation and a test pass;
the per-epoch loss and Dice, train and val, and the test row agree within
1e-4.  Also ``_virtual_batches``' ragged tails, ``AsyncCheckpointer``'s
error surfacing and snapshots, and ``_resume_best_value``.  A 3-class U-Net
through both loops exports the same confusion matrices (at an epoch and
after the last pass) and writes a ``torch.profiler`` trace, stopped even
when the pass raises; ``debug_nans`` names the non-finite steps."""
import csv

import jax
import numpy as np
import pytest
import torch

from medsegpretrainimagenet_tpu.config import ConfigDict as JaxConfigDict
from medsegpretrainimagenet_tpu.data import BalancedDataLoader as JaxLoader
from medsegpretrainimagenet_tpu.data.transforms import \
    Compose as JaxCompose
from medsegpretrainimagenet_tpu.data.transforms import \
    ConvertToType as JaxConvert
from medsegpretrainimagenet_tpu.data.transforms import \
    RepeatChannels as JaxRepeat
from medsegpretrainimagenet_tpu.losses import DiceLoss as JaxDiceLoss
from medsegpretrainimagenet_tpu.losses import Loss as JaxLoss
from medsegpretrainimagenet_tpu.metrics import \
    MetricsCalculator as JaxCalculator
from medsegpretrainimagenet_tpu.models import Model as JaxModel
from medsegpretrainimagenet_tpu.optim import Optimizer as JaxOptimizer
from medsegpretrainimagenet_tpu.train import TrainState as JaxTrainState
from medsegpretrainimagenet_tpu.train import loop as jax_loop
from medsegpretrainimagenet_tpu.config import registry as jax_registry
from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
from medsegpretrainimagenet_tpu_torch.data import BalancedDataLoader
from medsegpretrainimagenet_tpu_torch.data.transforms import (
    Compose, ConvertToType, RepeatChannels)
from medsegpretrainimagenet_tpu_torch.losses import DiceLoss, Loss
from medsegpretrainimagenet_tpu_torch.metrics import MetricsCalculator
from medsegpretrainimagenet_tpu_torch.models import Model
from medsegpretrainimagenet_tpu_torch.optim import Optimizer
from medsegpretrainimagenet_tpu_torch.train import TrainState
from medsegpretrainimagenet_tpu_torch.train import checkpoint as ckpt
from medsegpretrainimagenet_tpu_torch.train import loop

from torch_port_helpers import build_model, transplant, unet_config

TOL = 1e-4
EPOCHS, SIZE = 3, 16
OPTIMIZER = {"sgd": {"momentum": 0.9, "weight decay": 1e-4,
                     "learning_rate": {
                         "optim.scheduler.PolyLearningRateDecay": {
                             "base": 0.05, "exponent": 0.9,
                             "iteration_unit": "batch",
                             "number_of_iterations": "auto"}}}}
METRICS = {"metrics": ("metrics.DiceIndex",),
           "calculation": {"thresholds": 0.5}}


def _columns(n, seed):
    """COVID-QU-like columns: grayscale uint8 images with a bright square
    and its mask."""
    rng = np.random.default_rng(seed)
    x = (rng.random((n, SIZE, SIZE, 1)) * 90).astype(np.uint8)
    mask = np.zeros((n, SIZE, SIZE), np.uint8)
    for i in range(n):
        r, c = rng.integers(1, SIZE - 7, 2)
        x[i, r:r + 6, c:c + 6] += 150
        mask[i, r:r + 6, c:c + 6] = 1
    return {"x": x, "mask": mask}


def _loaders(cd_cls, loader_cls, compose, convert, repeat):
    pipeline = compose(repeat(), convert({"mask": "torch.LongTensor",
                                          "x": "uint8"}))
    sampling = cd_cls({"sampling": {"batch size": 4}})
    loader_cls.fill_kwargs(sampling["sampling"])
    # 10 training images: batches of 4, 4 and a ragged 2 per epoch, each
    # in fragments of 2
    return [loader_cls(_columns(n, seed), sampling[f"sampling/{split}"],
                       bs=4, actual_bs=2, transforms=pipeline, seed=seed)
            for n, seed, split in ((10, 1, "train"), (6, 2, "val"),
                                   (4, 3, "val"))]


def _config(cd_cls, destination):
    return cd_cls({"experiment": {"number of epochs": EPOCHS},
                   "meta": {"technical": {"absolute path": destination,
                                          "log_best_model": True,
                                          "model_evaluation": {
                                              "metric": "val_dice_loss",
                                              "mode": "min"},
                                          "batch_log_flush": 2}},
                   "metrics": METRICS})


def _epoch_rows(path):
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' train_model over the same batches from the same
    weights; their run directories."""
    root = tmp_path_factory.mktemp("loops")
    jmodel = build_model(JaxConfigDict, jax_registry, JaxModel,
                         unet_config())
    variables = jmodel.init(jax.random.key(0),
                            {"x": np.zeros((1, SIZE, SIZE, 3), np.float32)})
    train, val, test = _loaders(JaxConfigDict, JaxLoader, JaxCompose,
                                JaxConvert, JaxRepeat)
    optimizer = JaxOptimizer(JaxConfigDict(OPTIMIZER), num_epochs=EPOCHS,
                             batches_per_epoch=3)
    state = JaxTrainState.create(
        variables, optimizer.tx.init(variables["params"]), jax.random.key(1))
    loss = JaxLoss(JaxDiceLoss, JaxConfigDict({"label type": "mask"}))
    cfg = _config(JaxConfigDict, str(root / "jax") + "/")
    jax_loop.train_model(jmodel, train, val, test, cfg, optimizer, state,
                         loss=loss, metrics_and_loss=JaxCalculator(
                             JaxConfigDict({"metrics": METRICS}), loss=loss),
                         name="run_1", virtual_batch_size=4,
                         true_batch_size=2, verbose=False)

    model = build_model(ConfigDict, registry, Model, unet_config())
    transplant(variables, model.module)
    train, val, test = _loaders(ConfigDict, BalancedDataLoader, Compose,
                                ConvertToType, RepeatChannels)
    optimizer = Optimizer(ConfigDict(OPTIMIZER), num_epochs=EPOCHS,
                          batches_per_epoch=3)
    state = TrainState.create(model.module, optimizer.init(model.module), 1)
    loss = Loss(DiceLoss, ConfigDict({"label type": "mask"}))
    cfg = _config(ConfigDict, str(root / "port") + "/")
    final = loop.train_model(model, train, val, test, cfg, optimizer, state,
                             loss=loss, metrics_and_loss=MetricsCalculator(
                                 ConfigDict({"metrics": METRICS}),
                                 loss=loss),
                             name="run_1", virtual_batch_size=4,
                             true_batch_size=2, verbose=False, device="cpu")
    return root / "jax" / "run_1", root / "port" / "run_1", final


def test_three_epochs_match_jax(runs):
    jax_dir, port_dir, state = runs
    assert state.step == 3 * EPOCHS and state.micro_step == 3 * EPOCHS
    for name in ("epoch_logs.csv", "test_logs.csv", "batch_logs.csv"):
        got, want = _epoch_rows(port_dir / name), _epoch_rows(jax_dir / name)
        assert len(got) == len(want) > 0, name
        assert list(got[0]) == list(want[0]), name
        for k, (a, b) in enumerate(zip(got, want)):
            for key in b:
                np.testing.assert_allclose(float(a[key]), float(b[key]),
                                           rtol=TOL, atol=TOL,
                                           err_msg=f"{name} row {k} {key}")
    assert len(_epoch_rows(port_dir / "batch_logs.csv")) == 3 * EPOCHS
    rows = _epoch_rows(port_dir / "epoch_logs.csv")
    assert {"dice_loss", "val_dice_loss", "metrics/dice_index_threshold_0.5",
            "val_metrics/dice_index_threshold_0.5"} <= set(rows[0])
    assert float(rows[-1]["dice_loss"]) < float(rows[0]["dice_loss"])


def test_run_files_match_jax(runs):
    jax_dir, port_dir, _ = runs
    jax_files = {p.name.replace(".msgpack", ".pt")
                 for p in jax_dir.iterdir()}
    assert {p.name for p in port_dir.iterdir()} == jax_files
    assert ckpt.load_params_file(port_dir / "checkpoint_epoch.pt") \
        == {"epoch": EPOCHS}
    saved = ckpt.load_state_file(port_dir / "optimizer_state_dict.pt")
    assert saved["step"] == saved["micro_step"] == 3 * EPOCHS
    assert len(saved["optimizer"]["state"]) > 10  # momentum buffers
    model = build_model(ConfigDict, registry, Model, unet_config())
    model.module.load_state_dict(
        ckpt.load_params_file(port_dir / "best_model_state_dict.pt"))


def _fragments(shapes):
    return [{"x": np.full(shape, i, np.float32)}
            for i, shape in enumerate(shapes)]


@pytest.mark.parametrize("shapes, acc", [
    ([(2, 3)] * 5, 2),                      # ragged tail of one
    ([(2, 3)] * 4, 2),                      # no tail
    ([(2, 3), (2, 3), (1, 3), (2, 3)], 3),  # a shape change flushes
    ([(2, 3)] * 3, 4),                      # one short group
])
def test_virtual_batches_match_jax(shapes, acc):
    got = list(loop._virtual_batches(_fragments(shapes), acc))
    want = list(jax_loop._virtual_batches(_fragments(shapes), acc))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["x"], b["x"])


def test_async_checkpointer_surfaces_errors(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    writer = ckpt.AsyncCheckpointer()
    good = tmp_path / "a.pt"
    writer.save(str(good), {"w": torch.ones(3)})
    writer.save(str(blocker / "b.pt"), {"w": torch.ones(3)})
    with pytest.raises(RuntimeError, match="1 async checkpoint write"):
        writer.wait()
    writer.poll()  # reported once
    writer.save(str(blocker / "c.pt"), {"w": torch.ones(3)})
    with pytest.raises(RuntimeError, match="c.pt"):
        writer.close()
    assert torch.equal(ckpt.load_params_file(good)["w"], torch.ones(3))
    with pytest.raises(ValueError, match=".pt"):
        ckpt.AsyncCheckpointer().save(str(tmp_path / "x.msgpack"), {})


def test_async_checkpointer_writes_a_snapshot(tmp_path):
    """The state changes in place after ``save``; the file holds the state
    as it was at the call."""
    weight = torch.zeros(4)
    writer = ckpt.AsyncCheckpointer()
    paths = [str(tmp_path / "last.pt"), str(tmp_path / "best.pt")]
    writer.save_many(paths, {"w": weight, "step": 3})
    weight.add_(1)
    writer.close()
    for path in paths:
        saved = ckpt.load_params_file(path)
        assert torch.equal(saved["w"], torch.zeros(4)) and saved["step"] == 3


def test_resume_best_value_matches_jax(tmp_path):
    path = tmp_path / "epoch_logs.csv"
    rows = [(1, 0.5), (2, 0.3), (3, float("nan")), (2, 0.4), (3, 0.35),
            (4, 0.1)]
    with open(path, "w", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow(["epoch", "val_loss"])
        writer.writerows(rows)
    for pick in (min, max):
        for epoch_start in (0, 1, 2, 3, 4):
            assert loop._resume_best_value(str(path), "val_loss", pick,
                                           epoch_start) \
                == jax_loop._resume_best_value(str(path), "val_loss", pick,
                                               epoch_start)
    assert loop._resume_best_value(str(tmp_path / "none.csv"), "val_loss",
                                   min, 2) is None


# ---------------------------------------------------------------------------
# the multiclass loop: confusion-matrix export, last pass, end hooks, trace
# ---------------------------------------------------------------------------

MC = "metrics.multiclass_metrics."
MC_METRICS = {"metrics": (MC + "DiceIndex", MC + "ModifiedHausdorffDistance"),
              "calculation": {"number_of_classes": 3,
                              "class_names": ("left", "right"),
                              "log_confusion_matrix": True,
                              "log_confusion_matrix_at": (1, "last")}}


def _mc_loaders(cd_cls, loader_cls, compose, convert, repeat):
    """The binary loaders' images with 3-class masks: the square is class
    1 on its left half and class 2 on its right."""
    pipeline = compose(repeat(), convert({"mask": "torch.LongTensor",
                                          "x": "uint8"}))
    sampling = cd_cls({"sampling": {"batch size": 4}})
    loader_cls.fill_kwargs(sampling["sampling"])
    out = []
    for n, seed, split in ((8, 1, "train"), (4, 2, "val")):
        columns = _columns(n, seed)
        half = np.arange(SIZE) >= SIZE // 2
        columns["mask"] = (columns["mask"] * (1 + half[None, None, :])
                           ).astype(np.uint8)
        out.append(loader_cls(columns, sampling[f"sampling/{split}"], bs=4,
                              actual_bs=4, transforms=pipeline, seed=seed))
    return out


@pytest.fixture(scope="module")
def mc_runs(tmp_path_factory):
    """Both packages' train_model, two epochs of a 3-class U-Net with the
    confusion-matrix export at epoch 1 and 'last', classwise Dice (so a
    last pass) and profiling."""
    root = tmp_path_factory.mktemp("mc_loops")
    cfg = unet_config(out_channel_size=3,
                      **{"activation function": {"final": "softmax"}})
    jmodel = build_model(JaxConfigDict, jax_registry, JaxModel, cfg)
    variables = jmodel.init(jax.random.key(0),
                            {"x": np.zeros((1, SIZE, SIZE, 3), np.float32)})
    model = build_model(ConfigDict, registry, Model, cfg)
    transplant(variables, model.module)
    dirs = []
    for pkg in ("jax", "port"):
        cd_cls = JaxConfigDict if pkg == "jax" else ConfigDict
        train, val = _mc_loaders(
            cd_cls, *((JaxLoader, JaxCompose, JaxConvert, JaxRepeat)
                      if pkg == "jax" else (BalancedDataLoader, Compose,
                                            ConvertToType, RepeatChannels)))
        config = cd_cls({"experiment": {"number of epochs": 2},
                         "meta": {"technical": {
                             "absolute path": str(root / pkg) + "/",
                             "log_best_model": False, "profile": True,
                             "export_plots_as": ("json",)}},
                         "metrics": MC_METRICS})
        loss_cfg = cd_cls({"label type": "mask"})
        if pkg == "jax":
            optimizer = JaxOptimizer(JaxConfigDict(OPTIMIZER), num_epochs=2,
                                     batches_per_epoch=2)
            state = JaxTrainState.create(variables, optimizer.tx.init(
                variables["params"]), jax.random.key(1))
            loss = JaxLoss(JaxDiceLoss, loss_cfg)
            jax_loop.train_model(
                jmodel, train, val, None, config, optimizer, state,
                loss=loss, metrics_and_loss=JaxCalculator(
                    JaxConfigDict({"metrics": MC_METRICS}), loss=loss),
                name="run_1", virtual_batch_size=4, true_batch_size=4,
                verbose=False)
        else:
            optimizer = Optimizer(ConfigDict(OPTIMIZER), num_epochs=2,
                                  batches_per_epoch=2)
            state = TrainState.create(model.module,
                                      optimizer.init(model.module), 1)
            loss = Loss(DiceLoss, loss_cfg)
            loop.train_model(
                model, train, val, None, config, optimizer, state,
                loss=loss, metrics_and_loss=MetricsCalculator(
                    ConfigDict({"metrics": MC_METRICS}), loss=loss),
                name="run_1", virtual_batch_size=4, true_batch_size=4,
                verbose=False, device="cpu")
        dirs.append(root / pkg / "run_1")
    return dirs


def test_confusion_matrix_export_and_last_pass_match_jax(mc_runs):
    """The epoch-1 and 'last' confusion matrices (the last pass's), train
    and val, equal; the epoch rows within 1e-4; the classwise plot; the
    torch.profiler trace of the first epoch."""
    import json
    jax_dir, port_dir = mc_runs
    names = sorted(p.name for p in (port_dir / "Confusion_matrices")
                   .iterdir())
    assert names == sorted(p.name for p in (jax_dir / "Confusion_matrices")
                           .iterdir()) == [
        f"{s}_confusion_matrix_epoch_{e}.json"
        for s in ("train", "val") for e in (1, 2)]
    for name in names:
        got, want = (json.loads((d / "Confusion_matrices" / name)
                                .read_text()) for d in (port_dir, jax_dir))
        assert got["title"] == want["title"]
        np.testing.assert_array_equal(got["matrix"], want["matrix"])
    got, want = (_epoch_rows(d / "epoch_logs.csv")
                 for d in (port_dir, jax_dir))
    assert list(got[0]) == list(want[0])
    for a, b in zip(got, want):
        for key in b:
            np.testing.assert_allclose(float(a[key]), float(b[key]),
                                       rtol=TOL, atol=TOL, err_msg=key)
    # the CLI passes the class names to the calculator; unnamed, the
    # classwise columns go by index
    assert "val_metrics/dice_index_class_1" in got[0]
    assert (port_dir / "plots" / "dice_indices_plot.json").is_file()
    trace = json.loads((port_dir / "profile" / "trace" / "trace.json")
                       .read_text())
    assert trace["traceEvents"]
    assert list(_epoch_rows(port_dir / "profile" / "epoch_times.csv")[0]) \
        == list(_epoch_rows(jax_dir / "profile" / "epoch_times.csv")[0])


def test_trace_stops_when_the_train_pass_raises(tmp_path, monkeypatch):
    """A train pass that raises inside the first profiled epoch still
    stops the profiler and writes the trace; the envelope goes on."""
    def failing_epoch(*args, **kwargs):
        raise RuntimeError("train pass failed")
    monkeypatch.setattr(loop, "run_epoch", failing_epoch)
    model = build_model(ConfigDict, registry, Model, unet_config())
    optimizer = Optimizer(ConfigDict(OPTIMIZER), num_epochs=1,
                          batches_per_epoch=1)
    state = TrainState.create(model.module, optimizer.init(model.module), 1)
    config = ConfigDict({"experiment": {"number of epochs": 1},
                         "meta": {"technical": {
                             "absolute path": str(tmp_path) + "/",
                             "profile": True}}})
    loop.train_model(model, [], None, None, config, optimizer, state,
                     name="run", verbose=False, device="cpu")
    assert not torch.autograd.profiler._is_profiler_enabled
    assert (tmp_path / "run" / "profile" / "trace" / "trace.json").is_file()


def _fake_step(losses):
    """A train step that returns the next of *losses* as its loss."""
    values = iter(losses)

    def step(state, metrics_state, batch):
        loss = torch.tensor(next(values))
        return state, metrics_state, {"dice_loss": loss,
                                      "gradient_magnitude": loss * 2}
    return step


@pytest.mark.parametrize("log_path", [False, True], ids=["no_log", "log"])
def test_debug_nans_names_the_steps(tmp_path, log_path):
    """Under debug_nans a non-finite scalar raises FloatingPointError at
    the read-back of its window, naming the step; without it the pass goes
    on.  The window's batch-log rows are written first."""
    losses = [0.5, 0.4, float("nan"), 0.3, 0.2]
    batches = [{"x": np.zeros((1, 2), np.float32)}] * len(losses)
    path = str(tmp_path / "batch_logs.csv") if log_path else None
    calculator = MetricsCalculator(ConfigDict({"metrics": {"metrics": ()}}),
                                   loss=DiceLoss())
    kwargs = dict(device="cpu", log_path=path, calculator=calculator,
                  log_flush=2)
    with pytest.raises(FloatingPointError, match=r"step\(s\) \[2\].*2 to 3"):
        loop.run_epoch(_fake_step(losses), None, None, batches,
                       debug_nans=True, **kwargs)
    if log_path:
        assert len(_epoch_rows(path)) == 4
    loop.run_epoch(_fake_step(losses), None, None, batches, **kwargs)
