"""The port's IDRiD reader against the JAX package's, on the CPU.

* The reader: on a tree of PIL-written fundus ``.jpg`` files and per-task
  ``.tif`` masks (``tests/test_readers.py``'s tree: 64 x 224 images with a
  96-px border on each side and a black rim), both packages give equal
  ``x``, ``mask`` and split, bit for bit, for one task with and without
  its negatives, several tasks as argmax labels and as multilabel masks,
  every ``validation_set`` (test, train, random), RGB, RGBA and palette
  masks, and sliding-window crops under a darkness threshold that drops
  some (the same crops kept, and the count the rule gives).
* The experiment CLI: the port's CLI and the JAX package's train the tiny
  IDRiD U-Net of ``tests/test_model_families_e2e.py`` (RandomPick and
  RandomFlip crops, Partition for validation) from the same weights, and
  the five tasks as multilabel masks (five sigmoid outputs under the
  binary cross entropy, the per-class confusion matrix, a rotation that
  warps the 5-channel mask in groups of four); their epoch and batch logs
  agree within 1e-4 (the one-task run with the COVID-QU metric set:
  Dice, Jaccard, MCC, HD95, AUROC, the JAX CLI's columns)."""
import csv

import jax
import numpy as np
import pytest
import torch
import yaml

from medsegpretrainimagenet_tpu.cli.experiment import main as jax_main
from medsegpretrainimagenet_tpu.config import ConfigDict as JaxConfigDict
from medsegpretrainimagenet_tpu.config import registry as jax_registry
from medsegpretrainimagenet_tpu.data.readers import IDRiD as JaxIDRiD
from medsegpretrainimagenet_tpu.models import Model as JaxModel
from medsegpretrainimagenet_tpu.train import checkpoint as jax_ckpt
from medsegpretrainimagenet_tpu_torch.cli.experiment import main
from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
from medsegpretrainimagenet_tpu_torch.data import Dataset
from medsegpretrainimagenet_tpu_torch.data.readers import IDRiD
from medsegpretrainimagenet_tpu_torch.models import Model
from medsegpretrainimagenet_tpu_torch.train import checkpoint as ckpt
from medsegpretrainimagenet_tpu_torch.transfer import state_dict_from_jax

from torch_port_helpers import (IDRID_TASK_DIRS as TASK_DIRS, build_model,
                                torch_switches_kept, write_idrid_tree)

#: the bar on the two CLIs' logs (the repo's bar on the CLIs)
TOL = 1e-4
#: the COVID-QU reference metric set, which the paper's IDRiD runs log too
COVIDQU_METRICS = ("metrics.DiceIndex", "metrics.JaccardIndex", "metrics.MCC",
                   "metrics.ModifiedHausdorffDistance", "metrics.AUROC")
#: the epoch log's columns of a one-task IDRiD run with that set and the
#: Dice loss, in both CLIs (``chip_smoke.py``'s ``[cli idrid]`` checks them)
EPOCH_COLUMNS = {
    "epoch", "learning_rate", "dice_loss", "val_dice_loss",
    *(f"{split}metrics/{name}" for split in ("", "val_") for name in (
        "dice_index_threshold_0.5", "jaccard_index_threshold_0.5",
        "mcc_threshold_0.5",
        "modified_hausdorff_distance_threshold_0.5", "area_under_roc",
        "area_under_roc_pooled"))}


@pytest.fixture(scope="module", autouse=True)
def keep_torch_switches():
    with torch_switches_kept():
        yield


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("idrid")
    write_idrid_tree(root / "data", tasks=tuple(TASK_DIRS))
    mp = pytest.MonkeyPatch()
    mp.setenv("MST_DATA_DIR", str(root / "data"))
    yield root
    mp.undo()


FULL = {"base_image_sizes": (32, 48), "cropped_image_sizes": None}
READER_CASES = {
    "single_task": dict(task="MA", validation_set="test", train_set_size=5),
    "negatives_excluded": dict(task="HE", validation_set="test",
                               train_set_size=3),
    "negatives_included": dict(task="HE", include_negatives=True,
                               validation_set="test", train_set_size=4),
    "multitask_single_label": dict(task=("MA", "HE", "EX"),
                                   validation_set="test", train_set_size=6),
    "multitask_multilabel": dict(task=tuple(TASK_DIRS), multilabel=True,
                                 validation_set="test", train_set_size=5),
    "validation_train": dict(task="SE", validation_set="train",
                             train_set_size=2),
    "validation_random": dict(task="OD", validation_set="random",
                              validation_set_size=4, train_set_size=4,
                              seed=11),
    "crops_darkness": dict(task="MA", validation_set="test", train_set_size=5,
                           cropped_image_sizes=(16, 16),
                           train_crop_stride=(8, 16), darkness_threshold=0.6),
    "crops_square_sizes": dict(task=("MA", "OD"), validation_set="test",
                               train_set_size=6, base_image_sizes=32,
                               cropped_image_sizes=16, train_crop_stride=8,
                               darkness_threshold=0.99),
}


def _readers(case):
    params = {**FULL, **READER_CASES[case]}
    cfgs = JaxConfigDict(dict(params)), ConfigDict(dict(params))
    JaxIDRiD.fill_kwargs(cfgs[0])
    IDRiD.fill_kwargs(cfgs[1])
    assert cfgs[1].to_dict() == cfgs[0].to_dict()
    return JaxIDRiD(cfgs[0], seed=0), IDRiD(cfgs[1], seed=0)


@pytest.mark.parametrize("case", list(READER_CASES))
def test_reader_equals_jax(tree, case):
    want, got = _readers(case)
    for split in ("train", "val"):
        for key in ("x", "mask"):
            a, b = getattr(got, split)[key], getattr(want, split)[key]
            assert a.dtype == b.dtype and a.shape == b.shape, (split, key)
            np.testing.assert_array_equal(a, b, err_msg=f"{split} {key}")
        assert len(getattr(got, split)["x"]) > 0
    assert got.CLASSES == want.CLASSES


def test_darkness_filter_keeps_the_crops_its_rule_gives(tree):
    """Under a threshold that drops some crops, the kept count is the
    number of grid crops with mean >= 1 - threshold, the dropped ones the
    rest; the JAX reader keeps as many."""
    want, got = _readers("crops_darkness")
    full = IDRiD(ConfigDict({**FULL, "task": "MA", "validation_set": "test",
                             "train_set_size": 5}), seed=0)
    for split, stride in (("train", (8, 16)), ("val", (16, 16))):
        means = []
        for img in getattr(full, split)["x"]:
            for i in range(0, 32 - 16 + 1, stride[0]):
                for j in range(0, 48 - 16 + 1, stride[1]):
                    means.append(np.mean(img[i:i + 16, j:j + 16]))
        means = np.asarray(means)
        kept = int((means >= 1 - 0.6).sum())
        assert got.kept[split] == kept == len(getattr(want, split)["x"])
        assert got.dropped[split] == len(means) - kept > 0


def test_reader_builds_from_its_registry_names(tree):
    for name in ("segmentation.datasets.IDRiD", "idrid"):
        cd = ConfigDict({"data": {name: {**FULL, "train_set_size": 5}}})
        cd.expand()
        registry.fill_spec(cd, "data")
        ds = registry.build(cd["data"].trim(), wrapper=Dataset, seed=0)
        assert isinstance(ds, IDRiD) and ds.train["x"].shape == (5, 32, 48, 3)


def test_oversized_train_set_and_unknown_split_raise(tree):
    with pytest.raises(ValueError, match="larger than"):
        IDRiD(ConfigDict({**FULL, "train_set_size": 7}), seed=0)
    with pytest.raises(ValueError, match="validation_set"):
        IDRiD(ConfigDict({**FULL, "validation_set": "other"}), seed=0)


# ---------------------------------------------------------------------------
# the experiment CLI
# ---------------------------------------------------------------------------

def _model(tasks):
    """tests/test_model_families_e2e.py's IDRiD U-Net, one sigmoid output
    per task."""
    return {"segmentation.models.UNet": {"architecture": {
        "in_channel_size": 3, "out_channel_size": len(tasks),
        "channels": (4, 8), "depth": 1,
        "activation_function": {"final": "sigmoid"}}}}


def _cli_config(logs, tasks, weights, name):
    multilabel = len(tasks) > 1
    train = [{"segmentation.transforms.wrapped_transforms.RandomPick": {
        "crop_size": 16}},
        {"segmentation.transforms.wrapped_transforms.RandomFlip": {}}]
    if multilabel:
        train.append({"segmentation.transforms.wrapped_transforms."
                      "RandomRotation": {"limit": 30}})
    model = _model(tasks)
    model["segmentation.models.UNet"]["weight_init"] = {
        "weights": str(weights)}
    return {
        "data": {
            "data": {"segmentation.datasets.IDRiD": {
                "task": tasks[0] if len(tasks) == 1 else tuple(tasks),
                "multilabel": multilabel, "base_image_sizes": (32, 48),
                "cropped_image_sizes": (32, 32), "train_crop_stride": (16, 16),
                "darkness_threshold": 1.1, "validation_set": "test",
                "train_set_size": 4}},
            "sampling": {"batch_size": 4},
            "transforms": {
                "train": tuple(train),
                "val": {"segmentation.transforms.wrapped_transforms."
                        "Partition": {"number_of_partitions": (2, 2),
                                      "size": 16}},
                "casting": {"mask": "torch.LongTensor"}}},
        "model": model,
        "training": {
            "loss": "torch.nn.BCELoss" if multilabel
            else "segmentation.losses.DiceLoss",
            "optimizer": {"sgd": {"momentum": 0.9, "learning_rate": {
                "constant": {"base": 0.05}}}}},
        "metrics": {"calculation": {"thresholds": 0.5, "label_type": "mask",
                                    "multilabel": multilabel,
                                    "number_of_classes": len(tasks)},
                    "metrics": ("metrics.DiceIndex", "metrics.JaccardIndex")
                    if multilabel else COVIDQU_METRICS},
        "experiment": {"number_of_epochs": 2},
        "meta": {"technical": {
            "experiment_name": name, "maximum_actual_batch_size": 4,
            "seed": 3, "verbose": False, "export_plots_as": ("json",),
            "log_best_model": False, "log_last_model": True,
            "name_fields": (), "save_destination": str(logs)}},
    }


def _rows(run_dir, name):
    with open(run_dir / "run_1" / name, newline="") as fh:
        return list(csv.DictReader(fh))


@pytest.mark.parametrize("tasks", [("MA",), tuple(TASK_DIRS)],
                         ids=["single_task", "five_tasks_multilabel"])
def test_idrid_clis_write_the_same_logs(tree, tasks):
    cfg = {"model": _model(tasks)}
    jmodel = build_model(JaxConfigDict, jax_registry, JaxModel, cfg)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.key(4), {"x": np.zeros((1, 16, 16, 3), np.float32)}))
    port = build_model(ConfigDict, registry, Model, cfg)
    name = f"idrid_{len(tasks)}"
    jax_weights, port_weights = tree / f"{name}.msgpack", tree / f"{name}.pt"
    jax_ckpt.save_params_file(str(jax_weights), variables)
    ckpt.save_params_file(str(port_weights),
                          state_dict_from_jax(variables, port.module))
    for runner, logs, weights, flags in (
            (jax_main, "jax_logs", jax_weights, ()),
            (main, "port_logs", port_weights, ("--device", "cpu"))):
        path = tree / f"{logs}_{name}.yaml"
        path.write_text(yaml.dump(_cli_config(tree / logs, tasks, weights,
                                              name)))
        runner([str(path), *flags])
    jax_dir, port_dir = ((next(d for d in (tree / logs).iterdir()
                               if d.is_dir()) / name)
                         for logs in ("jax_logs", "port_logs"))
    for log in ("epoch_logs.csv", "batch_logs.csv"):
        got, want = _rows(port_dir, log), _rows(jax_dir, log)
        assert len(got) == len(want) > 0 and set(got[0]) == set(want[0])
        for k, (a, b) in enumerate(zip(got, want)):
            for key in b:
                np.testing.assert_allclose(
                    float(a[key]), float(b[key]), rtol=TOL, atol=TOL,
                    err_msg=f"{name} {log} row {k} {key}")
    if len(tasks) == 1:
        assert set(_rows(port_dir, "epoch_logs.csv")[0]) == EPOCH_COLUMNS
    last = _rows(port_dir, "epoch_logs.csv")[-1]
    assert 0 < float(last["bce_loss" if len(tasks) > 1 else "dice_loss"]) < 1
    assert (port_dir / "run_1" / "last_model_state_dict.pt").is_file()
