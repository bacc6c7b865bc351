"""Data parallelism over processes (``medsegpretrainimagenet_tpu_torch.
parallel``) on the CPU: two gloo ranks, each a process of its own
(``tests/torch_dp_worker.py``, one thread, a 120 s limit), meeting through
a ``file://`` rendezvous under the test's tmp_path.

* The U-Net train step with BatchNorm and the Dice loss on a global batch
  of 4, split 2 + 2 (one fragment) or 1 + 1 (two fragments): both ranks end
  with the single-process port's loss, gradient norm, parameters and
  running statistics within 1e-5, and with the JAX step's on the same 4
  images.  An eval batch of 3 does not split over 2 ranks: it replicates,
  and its loss is the single process's.
* A U-Net with dropout through a ragged tail of 3: both ranks draw the
  same masks on it and end with equal parameters.
* The experiment CLI, 2 epochs of a tiny COVID-QU U-Net with 13 training
  images (a ragged tail of 1 that replicates), under 2 ranks with and
  without ``per_host_input_slicing``: its ``epoch_logs.csv`` is the
  single-process run's within 1e-4, and the second rank writes no file.
* The helpers are the identity in a process without a group.
* The fragment of a virtual batch is sized per device of the data axis, as
  the JAX CLI sizes it: two ranks at ``batch_size: 4`` within
  ``maximum_actual_batch_size: 2`` write the JAX CLI's logs.  The refusals
  of layouts the processes cannot take."""
import csv
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from medsegpretrainimagenet_tpu.config import ConfigDict as JaxConfigDict
from medsegpretrainimagenet_tpu.config import registry as jax_registry
from medsegpretrainimagenet_tpu.losses import DiceLoss as JaxDiceLoss
from medsegpretrainimagenet_tpu.losses import Loss as JaxLoss
from medsegpretrainimagenet_tpu.metrics import \
    MetricsCalculator as JaxCalculator
from medsegpretrainimagenet_tpu.models import Model as JaxModel
from medsegpretrainimagenet_tpu.optim import Optimizer as JaxOptimizer
from medsegpretrainimagenet_tpu.train import TrainState as JaxTrainState
from medsegpretrainimagenet_tpu.train import \
    make_train_step as jax_train_step
from medsegpretrainimagenet_tpu_torch import parallel
from medsegpretrainimagenet_tpu_torch.cli.experiment import main
from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
from medsegpretrainimagenet_tpu_torch.losses import DiceLoss, Loss
from medsegpretrainimagenet_tpu_torch.metrics import MetricsCalculator
from medsegpretrainimagenet_tpu_torch.models import Model
from medsegpretrainimagenet_tpu_torch.models.blocks import draws
from medsegpretrainimagenet_tpu_torch.optim import Optimizer
from medsegpretrainimagenet_tpu_torch.train import (TrainState,
                                                    make_eval_step,
                                                    make_train_step)
from medsegpretrainimagenet_tpu_torch.train import checkpoint as ckpt

from torch_port_helpers import (assert_same_logs, build_model, cli_run_dir,
                                model_config, parallel_cli_config,
                                run_jax_cli, spawn_cli, spawn_ranks,
                                torch_switches_kept, transplant, unet_config,
                                write_cli_tree)

TOL = 1e-5
CLI_TOL = 1e-4
SIZE, STEPS, CLIP = 16, 2, 0.05
OPTIMIZER = {"sgd": {"momentum": 0.9, "weight decay": 1e-4,
                     "learning_rate": {
                         "optim.scheduler.PolyLearningRateDecay": {
                             "base": 0.05, "exponent": 0.9,
                             "iteration_unit": "batch",
                             "number_of_iterations": "auto"}}}}
METRICS = {"metrics": {"metrics": ("metrics.DiceIndex", "metrics.Accuracy"),
                       "calculation": {"thresholds": 0.5}}}
CLI_ARCH = {"in_channel_size": 3, "out_channel_size": 1, "channels": (4, 8),
            "depth": 1}


def _images(n, seed):
    """uint8 images with a bright square and its mask."""
    rng = np.random.default_rng(seed)
    x = (rng.random((n, SIZE, SIZE, 3)) * 90).astype(np.uint8)
    mask = np.zeros((n, SIZE, SIZE), np.uint8)
    for i in range(n):
        r, c = rng.integers(2, SIZE - 8, 2)
        x[i, r:r + 6, c:c + 6] += 150
        mask[i, r:r + 6, c:c + 6] = 1
    return {"x": x, "mask": mask}


def _stack(batch, n_frag):
    return {k: v.reshape((n_frag, -1) + v.shape[1:])
            for k, v in batch.items()}


def _spawn(mode, world, tmp_path, out_names, *args):
    """Run *world* worker processes to their end; each writes its result
    to ``tmp_path / out_names[rank]``."""
    return spawn_ranks(mode, world, tmp_path, out_names, *args)


@pytest.fixture(scope="module")
def jax_unet():
    model = build_model(JaxConfigDict, jax_registry, JaxModel, unet_config())
    variables = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.key(0), {"x": np.zeros((1, SIZE, SIZE, 3), np.float32)}))
    return model, variables


def _jax_steps(model, variables, batches, n_frag):
    optimizer = JaxOptimizer(JaxConfigDict(OPTIMIZER), num_epochs=1,
                             batches_per_epoch=STEPS)
    state = JaxTrainState.create(
        variables, optimizer.tx.init(variables["params"]), jax.random.key(1))
    loss = JaxLoss(JaxDiceLoss, JaxConfigDict({"label type": "mask"}))
    calculator = JaxCalculator(JaxConfigDict(METRICS), loss=loss)
    step = jax_train_step(model, loss, calculator, optimizer,
                          grad_clip_value=CLIP, donate=False)
    metrics_state, logs = calculator.init_state(), []
    for batch in batches:
        state, metrics_state, per_batch = step(state, metrics_state,
                                               _stack(batch, n_frag))
        logs.append({k: float(v) for k, v in
                     jax.device_get(per_batch).items()})
    return state, logs


def _port_steps(state_dict, batches, held, n_frag):
    model = build_model(ConfigDict, registry, Model, unet_config())
    model.module.load_state_dict(state_dict)
    optimizer = Optimizer(ConfigDict(OPTIMIZER), num_epochs=1,
                          batches_per_epoch=STEPS)
    state = TrainState.create(model.module, optimizer.init(model.module),
                              seed=1)
    loss = Loss(DiceLoss, ConfigDict({"label type": "mask"}))
    calculator = MetricsCalculator(ConfigDict(METRICS), loss=loss)
    step = make_train_step(model, loss, calculator, optimizer,
                           grad_clip_value=CLIP)
    metrics_state, logs = calculator.init_state("cpu"), []
    for batch in batches:
        state, metrics_state, per_batch = step(
            state, metrics_state,
            {k: torch.from_numpy(v) for k, v in _stack(batch,
                                                       n_frag).items()})
        logs.append({k: v.item() if isinstance(v, torch.Tensor) else v
                     for k, v in per_batch.items()})
    eval_state, eval_batch = make_eval_step(model, loss, calculator)(
        state, calculator.init_state("cpu"),
        {k: torch.from_numpy(v) for k, v in held.items()})
    return {"logs": logs, "epoch": calculator.finalize_epoch(metrics_state),
            "state_dict": model.module.state_dict(),
            "eval_loss": eval_batch["dice_loss"].item(),
            "eval_epoch": calculator.finalize_epoch(eval_state)}


def _pre_bn_bias(name: str) -> bool:
    """The biases of convolutions in front of a BatchNorm: their gradient
    is zero up to rounding, so they are held through the outputs only (as
    in ``tests/test_torch_train_step.py``)."""
    return ".Conv_" in name and name.endswith(".bias") \
        and "upsamples" not in name and "final" not in name


@pytest.mark.parametrize("n_frag", [1, 2], ids=["one_fragment",
                                                "two_fragments"])
def test_two_ranks_take_the_global_step(jax_unet, tmp_path, n_frag):
    jmodel, variables = jax_unet
    batches = [_images(4, seed) for seed in range(STEPS)]
    held = _stack(_images(3, 9), 1)
    state_dict = transplant(variables, build_model(
        ConfigDict, registry, Model, unet_config()).module).state_dict()
    payload = tmp_path / "payload.pt"
    torch.save({"model_config": unet_config(), "state_dict": state_dict,
                "optimizer": OPTIMIZER, "metrics": METRICS, "clip": CLIP,
                "batches": [_stack(b, n_frag) for b in batches],
                "held": held}, payload)
    _spawn("step", 2, tmp_path, ["rank0.pt", "rank1.pt"], payload)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    single = _port_steps(state_dict, batches, held, n_frag)
    jstate, jlogs = _jax_steps(jmodel, variables, batches, n_frag)
    want_jax = transplant({"params": jstate.params,
                           "batch_stats": jstate.batch_stats},
                          build_model(ConfigDict, registry, Model,
                                      unet_config()).module).state_dict()

    for r, got in enumerate(ranks):
        for k, (row, want, jrow) in enumerate(zip(got["logs"],
                                                  single["logs"], jlogs)):
            for key in ("dice_loss", "gradient_magnitude",
                        "true_positives_threshold_0.5"):
                np.testing.assert_allclose(row[key], want[key], rtol=TOL,
                                           atol=TOL,
                                           err_msg=f"rank {r} step {k} {key}")
                np.testing.assert_allclose(row[key], jrow[key], rtol=TOL,
                                           atol=TOL, err_msg=f"jax {key}")
            # the clip applied to the global norm, not to a rank's share
            assert row["gradient_magnitude"] > CLIP
        for key, value in single["epoch"].items():
            np.testing.assert_allclose(got["epoch"][key], value, rtol=TOL,
                                       atol=TOL, err_msg=key)
        compared = 0
        for name, value in got["state_dict"].items():
            if name.endswith("num_batches_tracked"):
                assert value == single["state_dict"][name]
                continue
            np.testing.assert_allclose(value.numpy(),
                                       single["state_dict"][name].numpy(),
                                       rtol=TOL, atol=TOL, err_msg=name)
            if not _pre_bn_bias(name):
                np.testing.assert_allclose(value.numpy(),
                                           want_jax[name].numpy(), rtol=TOL,
                                           atol=TOL, err_msg=f"jax {name}")
                compared += 1
        assert compared > 40
        # the eval batch of 3 replicated over the 2 ranks
        np.testing.assert_allclose(got["eval_loss"], single["eval_loss"],
                                   rtol=TOL, atol=TOL)
        for key, value in single["eval_epoch"].items():
            np.testing.assert_allclose(got["eval_epoch"][key], value,
                                       rtol=TOL, atol=TOL, err_msg=key)


def test_a_replicated_tail_that_draws_keeps_the_ranks_equal(jax_unet,
                                                            tmp_path):
    """A U-Net with dropout: a batch of 4 sharded 2 + 2, then a ragged
    tail of 3 that both ranks compute whole.  The tail draws the same
    dropout masks on both ranks and their gradients are averaged, so the
    ranks end with the same parameters, running statistics and losses."""
    _, variables = jax_unet
    config = unet_config(basic_block={
        "segmentation.models.blocks.ConvBlock": {"dropout": {"rate": 0.5}}})
    module = build_model(ConfigDict, registry, Model, config).module
    assert draws(module)
    state_dict = transplant(variables, module).state_dict()
    payload = tmp_path / "payload.pt"
    torch.save({"model_config": config, "state_dict": state_dict,
                "optimizer": OPTIMIZER, "metrics": METRICS, "clip": CLIP,
                "batches": [_stack(_images(4, 0), 1),
                            _stack(_images(3, 1), 1)],
                "held": _stack(_images(3, 9), 1)}, payload)
    outputs = _spawn("step", 2, tmp_path, ["rank0.pt", "rank1.pt"], payload)
    assert "replicating this (tail) batch" in outputs[0]
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    for row0, row1 in zip(ranks[0]["logs"], ranks[1]["logs"]):
        assert row0["dice_loss"] == row1["dice_loss"]
    moved = 0
    for name, value in ranks[0]["state_dict"].items():
        np.testing.assert_array_equal(
            value.numpy(), ranks[1]["state_dict"][name].numpy(),
            err_msg=name)
        moved += not torch.equal(value, state_dict[name])
    assert moved > 40
    assert ranks[0]["eval_loss"] == ranks[1]["eval_loss"]


def _cli_config(logs, weights, slicing):
    return {
        "experiment": {"number_of_epochs": 2, "number_of_trials": 1},
        "meta": {"technical": {"seed": 777, "save_destination": str(logs),
                               "export_plots_as": ["json"],
                               "maximum_actual_batch_size": 4,
                               "number_of_cpu_threads": 1,
                               "log_metric_and_loss_plots": True,
                               "per_host_input_slicing": slicing}},
        "data": {"data": {"segmentation.datasets.COVIDQUDataset": {
            "lung_or_infection": "inf", "image_sizes": 16,
            "validate_on_test": True, "seed": 20231027}},
            "sampling": {"batch_size": 4},
            "transforms": {"train": "transform.RepeatChannels",
                           "val": "transform.RepeatChannels",
                           "casting": {"mask": "torch.LongTensor"}}},
        "model": {"segmentation.models.UNet": {
            "architecture": dict(CLI_ARCH), "final_activation": "sigmoid",
            "weight_init": {"weights": str(weights)}}},
        "training": {
            "loss": {"segmentation.losses.DiceLoss": {}},
            "optimizer": {"sgd": {"momentum": 0.9, "learning_rate": {
                "optim.scheduler.PolyLearningRateDecay": {
                    "base": 0.05, "exponent": 0.9,
                    "iteration_unit": "batch",
                    "number_of_iterations": "auto"}}}}},
        "metrics": {"metrics": ("metrics.DiceIndex", "metrics.AUROC")},
    }


@pytest.fixture(scope="module")
def cli_tree(tmp_path_factory):
    """A COVID-QU tree of 13 training and 4 test images (validated on),
    its weights, and the single-process run's epoch_logs.csv."""
    root = tmp_path_factory.mktemp("dp_cli")
    rng = np.random.default_rng(0)
    base = root / "data" / "COVID_QU" / "Inf_segm" / "data arrays" \
        / "COVID-19"
    for part, n in (("train and val", 13), ("test", 4)):
        d = base / part
        d.mkdir(parents=True)
        images = (rng.random((n, 1, 20, 20)) * 120).astype(np.uint8)
        masks = np.zeros((n, 1, 20, 20), np.uint8)
        for i in range(n):
            r, c = rng.integers(2, 10, 2)
            images[i, :, r:r + 8, c:c + 8] += 120
            masks[i, :, r:r + 8, c:c + 8] = 2
        np.save(d / "imgs.npy", images)
        np.save(d / "inf_masks.npy", masks)
    cfg = {"model": {"segmentation.models.UNet": {"architecture": CLI_ARCH}}}
    model = build_model(ConfigDict, registry, Model, cfg)
    model.init(3)
    weights = root / "weights.pt"
    ckpt.save_params_file(str(weights), model.module.state_dict())
    mp = pytest.MonkeyPatch()
    mp.setenv("MST_DATA_DIR", str(root / "data"))
    try:
        with torch_switches_kept():
            path = root / "single.yaml"
            path.write_text(yaml.dump(_cli_config(root / "single", weights,
                                                  False)))
            main([str(path), "--device", "cpu"])
    finally:
        mp.undo()
    return root, weights, _run_dir(root / "single")


def _run_dir(logs):
    (day,) = [d for d in logs.iterdir() if d.is_dir()]
    return day / "Experiment" / "run_1"


def _rows(path):
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


def _files(directory):
    return sorted(str(p.relative_to(directory))
                  for p in directory.rglob("*") if p.is_file())


@pytest.mark.parametrize("slicing", [False, True],
                         ids=["whole_batches", "per_host_slices"])
def test_cli_under_two_ranks_writes_the_single_process_logs(cli_tree,
                                                            tmp_path,
                                                            slicing):
    root, weights, single_dir = cli_tree
    logs = tmp_path / "logs"
    path = tmp_path / "dp.yaml"
    path.write_text(yaml.dump(_cli_config(logs, weights, slicing)))
    env_data = os.environ.get("MST_DATA_DIR")
    os.environ["MST_DATA_DIR"] = str(root / "data")
    try:
        outputs = _spawn("cli", 2, tmp_path, ["rank0.txt", "rank1.txt"],
                         path, logs)
    finally:
        if env_data is None:
            os.environ.pop("MST_DATA_DIR")
        else:
            os.environ["MST_DATA_DIR"] = env_data
    # the ragged tail of 1 replicated rather than sharded
    assert "replicating this (tail) batch" in outputs[0]
    assert (tmp_path / "rank1.txt").read_text() == "no writes\n", \
        (tmp_path / "rank1.txt").read_text()
    dp_dir = _run_dir(logs)
    assert _files(dp_dir) == _files(single_dir)
    want = _rows(single_dir / "epoch_logs.csv")
    got = _rows(dp_dir / "epoch_logs.csv")
    assert len(got) == len(want) == 2
    assert list(got[0]) == list(want[0])
    for g, w in zip(got, want):
        for key in w:
            np.testing.assert_allclose(float(g[key]), float(w[key]),
                                       rtol=CLI_TOL, atol=CLI_TOL,
                                       err_msg=key)
    # 13 images in batches of 4: 4 steps an epoch, the last of one image
    assert len(_rows(dp_dir / "batch_logs.csv")) == 2 * 4


def test_helpers_are_the_identity_without_a_group():
    assert not parallel.data_parallel()
    assert parallel.device_count() == 1 and parallel.rank() == 0
    assert parallel.is_main_process()
    assert parallel.broadcast_from_main((3, 4)) == [3, 4]
    batch = {"x": torch.zeros(1, 3, 2)}
    assert parallel.shard_batch(batch) is batch
    tree = {"a": torch.ones(2, requires_grad=True), "b": [torch.zeros(1)]}
    host = parallel.gather_tree_to_host(tree)
    assert not host["a"].requires_grad and host["b"][0].device.type == "cpu"
    with parallel.sync_batch_stats():
        assert not parallel.batch_stats_synced()


def test_cli_refuses_a_process_count_that_does_not_divide_the_batch(
        monkeypatch):
    """The layouts the CLI refuses: a data axis that does not divide the
    fragment batch (the count to run named), both model knobs at once (the
    reference CLI does not offer both), a factor beyond the processes or
    one that does not divide them, and a Swin U-Net height that spatial
    sharding's bands cannot split into rows of patches."""
    from medsegpretrainimagenet_tpu_torch.cli import run_experiment
    from medsegpretrainimagenet_tpu_torch.parallel.spatial import \
        check_supported
    monkeypatch.setattr(run_experiment, "device_count", lambda: 4)
    with pytest.raises(ValueError, match="run 3 processes"):
        run_experiment._refuse_parallelism(ConfigDict({}), 6)
    # tensor_parallel 2 of 4 processes leaves 2 data processes
    with pytest.raises(ValueError, match="run 2 processes"):
        run_experiment._refuse_parallelism(
            ConfigDict({"tensor_parallel": 2}), 3)
    run_experiment._refuse_parallelism(ConfigDict({"spatial_sharding": 2}),
                                       2)
    with pytest.raises(ValueError, match="does not offer both at once"):
        run_experiment._refuse_parallelism(ConfigDict(
            {"spatial_sharding": 2, "tensor_parallel": 2}), 4)
    for knob in ("spatial_sharding", "tensor_parallel"):
        with pytest.raises(ValueError, match="exceeds the 4 available"):
            run_experiment._refuse_parallelism(ConfigDict({knob: 8}), 4)
        with pytest.raises(ValueError, match="must divide the 4 processes"):
            run_experiment._refuse_parallelism(ConfigDict({knob: 3}), 4)
    swin = build_model(ConfigDict, registry, Model, model_config()).module
    check_supported(swin, 64, 2)
    with pytest.raises(ValueError, match="H must divide by 2 x the patch"):
        check_supported(swin, 36, 2)


@pytest.mark.parametrize("case", [
    (64, 8, 8, 1), (64, 8, 8, 4), (64, 8, 1, 1), (4, 2, 2, 1), (4, 2, 1, 1),
    (16, 4, 4, 2), (12, 4, 3, 1), (24, 5, 8, 2), (32, 2, 4, 4), (6, 6, 4, 1)])
def test_effective_batch_size_equals_jax(case):
    """The fragment of a virtual batch: its per-device share within
    ``maximum_actual_batch_size`` on the data axis that the model factor
    leaves (``tests/test_cli_review_fixes.py``'s cases first)."""
    from medsegpretrainimagenet_tpu.cli.run_experiment import \
        effective_batch_size as jax_effective
    from medsegpretrainimagenet_tpu_torch.cli.run_experiment import \
        effective_batch_size
    assert effective_batch_size(*case) == jax_effective(*case)


def test_cli_under_two_ranks_sizes_its_fragment_as_the_jax_cli(
        tmp_path_factory, tmp_path):
    """``batch_size: 4`` within ``maximum_actual_batch_size: 2`` on two
    processes: one fragment of 4 a step, 2 a process, as the JAX CLI steps
    one fragment of 4 on its mesh (four of the eight test devices), with
    BatchNorm statistics over the 4; both write the same
    ``epoch_logs.csv``.  (Sizing the fragment for one device would step two
    fragments of 2.)"""
    data, jax_weights, port_weights = write_cli_tree(
        tmp_path_factory.mktemp("fragment_tree"), CLI_ARCH, n_train=12)
    runs = {}
    for kind, weights in (("jax", jax_weights), ("port", port_weights)):
        logs = tmp_path / f"{kind}_logs"
        path = tmp_path / f"{kind}.yaml"
        path.write_text(yaml.dump(parallel_cli_config(
            logs, weights, CLI_ARCH, epochs=1, batch_size=4, max_bs=2)))
        if kind == "jax":
            run_jax_cli(path, data)
        else:
            spawn_cli(2, tmp_path, path, logs, data)
        runs[kind] = cli_run_dir(logs)
    assert_same_logs(runs["port"], runs["jax"], CLI_TOL)
    # 12 images in whole batches of 4: three steps, each one fragment
    assert len(_rows(runs["port"] / "batch_logs.csv")) == 3
