"""The port's ``MixedDataset`` against the JAX package's, on the CPU.

* The rows: two toy sub-datasets (6 + 4 and 10 + 2 records, a column that
  only the first has) through both packages' ``MixedDataset`` from the
  same seed give the same rows, in the same order, row by row through the
  load functions (counter columns first): the cases of
  ``tests/test_readers.py`` (lengths and columns, ordered switching,
  ``under`` and ``over`` balancing, the epoch's wrap-around, the loader,
  the lazy reload) and shuffled switching.
* The loader keeps the stateful loads serial: a source whose load
  functions are a ``StatefulLoadFunctions`` refuses the worker pool.
* The experiment CLI: a ``MixedDataset`` of two COVID-QU readers, one
  validating on its test split and one on a random split, lazily
  reloaded and over-balanced, trains through both CLIs from the same
  weights; their epoch and batch logs agree within 1e-4."""
import csv

import jax
import numpy as np
import pytest
import torch
import yaml

from medsegpretrainimagenet_tpu.cli.experiment import main as jax_main
from medsegpretrainimagenet_tpu.config import ConfigDict as JaxConfigDict
from medsegpretrainimagenet_tpu.config import registry as jax_registry
from medsegpretrainimagenet_tpu.data import \
    BalancedDataLoader as JaxDataLoader
from medsegpretrainimagenet_tpu.data import MixedDataset as JaxMixedDataset
from medsegpretrainimagenet_tpu.models import Model as JaxModel
from medsegpretrainimagenet_tpu.train import checkpoint as jax_ckpt
from medsegpretrainimagenet_tpu_torch.cli.experiment import main
from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
from medsegpretrainimagenet_tpu_torch.data import (BalancedDataLoader,
                                                   BalancedSource,
                                                   MixedDataset)
from medsegpretrainimagenet_tpu_torch.data.sampling import \
    StatefulLoadFunctions
from medsegpretrainimagenet_tpu_torch.models import Model
from medsegpretrainimagenet_tpu_torch.train import checkpoint as ckpt
from medsegpretrainimagenet_tpu_torch.transfer import state_dict_from_jax

from torch_port_helpers import build_model, torch_switches_kept, unet_config

TOL = 1e-4
SIZES = ((6, 4), (10, 2))


@pytest.fixture(scope="module", autouse=True)
def keep_torch_switches():
    with torch_switches_kept():
        yield


def _toy(n_train, n_val, value, extra):
    train = {"x": [value] * n_train}
    val = {"x": [value] * n_val}
    if extra:
        train["y"] = [value * 10] * n_train
        val["y"] = [value * 10] * n_val
    return train, val


def _register_toys():
    """``tests.MixedToy{i}`` in both registries: record values i + 1 (and
    a ``y`` column of 10 (i + 1) when ``extra``)."""
    for module in (jax_registry, registry):
        for i, (n_train, n_val) in enumerate(SIZES):
            try:
                module.register(f"tests.MixedToy{i}")(
                    lambda seed=None, extra=False, _i=i, _n=(n_train, n_val):
                    _toy(*_n, _i + 1, extra))
            except module.RegistryError:
                pass  # already registered in this process


def _mixed(package, overrides=None):
    _register_toys()
    cd, cls = (JaxConfigDict, JaxMixedDataset) if package == "jax" \
        else (ConfigDict, MixedDataset)
    cfg = cd({
        "datasets": tuple(cd({f"tests.MixedToy{i}": {"extra": i == 0}})
                          for i in range(len(SIZES))),
        "switch_frequency": 2,
        "preserve_order": True,
        "balancing_strategy": {"train": "none", "val": "under"},
        "preload_data": True,
        **(overrides or {}),
    })
    return cls(cfg, seed=0)


def _drain(ds, split="train"):
    """Every row of *split* through the load functions, counter columns
    first, as the loader's ``_load`` calls them."""
    data, lf = getattr(ds, split), ds.load_function
    rows = []
    for i in range(len(data["train_counter"])):
        rows.append({kw: lf[kw](data[kw][i]) if kw in lf else data[kw][i]
                     for kw in data})
    return rows


def _same_rows(got, want):
    assert len(got) == len(want) > 0
    for k, (a, b) in enumerate(zip(got, want)):
        assert list(a) == list(b), k
        for key in b:
            np.testing.assert_array_equal(np.asarray(a[key], float),
                                          np.asarray(b[key], float),
                                          err_msg=f"row {k} {key}")


CASES = {
    "ordered_none_under": {},
    "shuffled": {"preserve_order": False},
    "over": {"balancing_strategy": {"train": "over", "val": "under"}},
    "under_both": {"balancing_strategy": {"train": "under", "val": "under"},
                   "preserve_order": False},
    "lazy_reload": {"preload_data": False},
    "lazy_shuffled_over": {"preload_data": False, "preserve_order": False,
                           "balancing_strategy": {"train": "over",
                                                  "val": "over"}},
}


@pytest.mark.parametrize("case", list(CASES))
def test_rows_equal_jax_over_three_epochs(case):
    """Both splits, three epochs in a row (the pointers wrap around and the
    lazy datasets reload)."""
    got, want = _mixed("port", CASES[case]), _mixed("jax", CASES[case])
    assert len(got.train["x"]) == len(want.train["x"])
    assert len(got.val["x"]) == len(want.val["x"])
    assert list(got.train)[:2] == ["train_counter", "val_counter"]
    for _ in range(3):
        for split in ("train", "val"):
            _same_rows(_drain(got, split), _drain(want, split))


def test_lengths_columns_and_values():
    """none: 6 + 10 train rows in bundles of 2; under: 2 x 2 val rows; the
    ``y`` column that only the first dataset has is NaN in the second's
    rows; ``x`` names the active dataset."""
    ds = _mixed("port")
    assert len(ds.train["x"]) == 16 and len(ds.val["x"]) == 4
    assert set(ds.train) == {"train_counter", "val_counter", "ds_idx", "x",
                             "y"}
    rows = _drain(ds)
    idcs = [r["ds_idx"] for r in rows]
    assert idcs[:4] == [0, 0, 1, 1] and np.bincount(idcs).tolist() == [6, 10]
    for r in rows:
        assert r["x"] == r["ds_idx"] + 1
        assert r["y"] == 10 if r["ds_idx"] == 0 else np.isnan(r["y"])
    assert sorted(r["ds_idx"] for r in _drain(ds, "val")) == [0, 0, 1, 1]
    over = _mixed("port", CASES["over"])
    assert np.bincount([r["ds_idx"] for r in _drain(over)]).tolist() \
        == [10, 10]


def _loader_batches(package, overrides):
    ds = _mixed(package, overrides)
    cd, loader_cls = (JaxConfigDict, JaxDataLoader) if package == "jax" \
        else (ConfigDict, BalancedDataLoader)
    cfg = cd({"epoch": {"uniform": {}}, "batch": {"uniform": {}},
              "relative_size": 1.0, "sort_by": None, "pad_with": None})
    loader = loader_cls(ds.train, cfg, bs=4, actual_bs=4, seed=0,
                        load_function=ds.load_function, drop_last=True,
                        num_workers=2)
    return [batch for _ in range(2) for batch in loader]


@pytest.mark.parametrize("case", ["ordered_none_under", "lazy_reload"])
def test_loader_batches_equal_jax(case):
    """Two epochs through both loaders (with two workers asked for: the
    stateful loads stay serial): the same batches, bit for bit, each
    ``x`` the active dataset's value."""
    got = _loader_batches("port", CASES[case])
    want = _loader_batches("jax", CASES[case])
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for key in b:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        np.testing.assert_array_equal(a["x"], a["ds_idx"] + 1)


def test_stateful_loads_stay_serial():
    """A source with ``StatefulLoadFunctions`` refuses parallel loads, and
    the loader starts no worker pool for it; MixedDataset's load functions
    are such."""
    columns = {"x": np.arange(4, dtype=np.float32),
               "label": np.ones(4, np.int32)}
    stateful = StatefulLoadFunctions({"x": lambda v: v})
    assert not BalancedSource(dict(columns), balanced=1, seed=0,
                              load_function=stateful).parallel_load_ok()
    assert BalancedSource(dict(columns), balanced=1, seed=0,
                          load_function={"x": lambda v: v}).parallel_load_ok()
    cfg = ConfigDict({"epoch": {"uniform": {}}, "batch": {"uniform": {}},
                      "relative_size": 1.0, "sort_by": None,
                      "pad_with": None})
    loader = BalancedDataLoader(dict(columns), cfg, bs=2, actual_bs=2,
                                seed=0, num_workers=2,
                                load_function=stateful)
    assert loader._load_executor() is None
    assert isinstance(_mixed("port").load_function, StatefulLoadFunctions)


def test_registry_names_build_it():
    _register_toys()
    for name in ("data.MixedDataset", "mixed_dataset"):
        cd = ConfigDict({"data": {name: {"datasets": (
            ConfigDict({"tests.MixedToy0": {}}),
            ConfigDict({"tests.MixedToy1": {}}))}}})
        cd.expand()
        registry.fill_spec(cd, "data")
        ds = registry.build(cd["data"].trim(), seed=0)
        assert isinstance(ds, MixedDataset)
        assert ds.train_balancing_strategy == "none"
        assert ds.val_balancing_strategy == "under"


# ---------------------------------------------------------------------------
# the experiment CLI
# ---------------------------------------------------------------------------

SIZE = 16


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A COVID-QU tree of 10 + 4 noise images with square masks."""
    root = tmp_path_factory.mktemp("mixed")
    rng = np.random.default_rng(0)
    base = root / "data" / "COVID_QU" / "Inf_segm" / "data arrays" \
        / "COVID-19"
    for part, n in (("train and val", 10), ("test", 4)):
        d = base / part
        d.mkdir(parents=True)
        np.save(d / "imgs.npy",
                (rng.random((n, 1, SIZE, SIZE)) * 255).astype(np.uint8))
        masks = np.zeros((n, 1, SIZE, SIZE), np.uint8)
        masks[:, :, 4:11, 5:12] = 2
        np.save(d / "inf_masks.npy", masks)
    mp = pytest.MonkeyPatch()
    mp.setenv("MST_DATA_DIR", str(root / "data"))
    yield root
    mp.undo()


def _cli_config(logs, weights):
    reader = "segmentation.datasets.COVIDQUDataset"
    common = {"lung_or_infection": "inf", "image_sizes": SIZE, "seed": 1}
    return {
        "data": {
            "data": {"data.MixedDataset": {
                "datasets": (
                    {reader: {**common, "validate_on_test": True}},
                    {reader: {**common, "validate_on_test": False,
                              "val split percentage": 0.3}}),
                "switch_frequency": 2,
                "preserve_order": False,
                "balancing_strategy": {"train": "over", "val": "under"},
                "preload_data": False}},
            "sampling": {"batch_size": 4},
            "transforms": {"train": "transform.RepeatChannels",
                           "val": "transform.RepeatChannels",
                           "casting": {"mask": "torch.LongTensor"}}},
        "model": {"segmentation.models.UNet": {
            **unet_config((4, 8))["model"]["segmentation.models.UNet"],
            "weight_init": {"weights": str(weights)}}},
        "training": {
            "loss": "segmentation.losses.DiceLoss",
            "optimizer": {"sgd": {"momentum": 0.9, "learning_rate": {
                "constant": {"base": 0.05}}}}},
        "metrics": {"calculation": {"thresholds": 0.5, "label_type": "mask"},
                    "metrics": ("metrics.DiceIndex",)},
        "experiment": {"number_of_epochs": 2},
        "meta": {"technical": {
            "experiment_name": "mixed", "maximum_actual_batch_size": 4,
            "seed": 3, "verbose": False, "export_plots_as": ("json",),
            "log_best_model": False, "log_last_model": True,
            "name_fields": (), "save_destination": str(logs),
            "number_of_data_loader_workers": 2}},
    }


def _rows(run_dir, name):
    with open(run_dir / "run_1" / name, newline="") as fh:
        return list(csv.DictReader(fh))


def test_mixed_clis_write_the_same_logs(tree):
    cfg = unet_config((4, 8))
    jmodel = build_model(JaxConfigDict, jax_registry, JaxModel, cfg)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.key(5), {"x": np.zeros((1, SIZE, SIZE, 3), np.float32)}))
    port = build_model(ConfigDict, registry, Model, cfg)
    jax_weights, port_weights = tree / "w.msgpack", tree / "w.pt"
    jax_ckpt.save_params_file(str(jax_weights), variables)
    ckpt.save_params_file(str(port_weights),
                          state_dict_from_jax(variables, port.module))
    for runner, logs, weights, flags in (
            (jax_main, "jax_logs", jax_weights, ()),
            (main, "port_logs", port_weights, ("--device", "cpu"))):
        path = tree / f"{logs}.yaml"
        path.write_text(yaml.dump(_cli_config(tree / logs, weights)))
        runner([str(path), *flags])
    jax_dir, port_dir = ((next(d for d in (tree / logs).iterdir()
                               if d.is_dir()) / "mixed")
                         for logs in ("jax_logs", "port_logs"))
    for log in ("epoch_logs.csv", "batch_logs.csv"):
        got, want = _rows(port_dir, log), _rows(jax_dir, log)
        assert len(got) == len(want) > 0 and set(got[0]) == set(want[0])
        for k, (a, b) in enumerate(zip(got, want)):
            for key in b:
                if "loss" in key or "dice" in key or key == "learning_rate":
                    np.testing.assert_allclose(
                        float(a[key]), float(b[key]), rtol=TOL, atol=TOL,
                        err_msg=f"{log} row {k} {key}")
    last = _rows(port_dir, "epoch_logs.csv")[-1]
    assert 0 < float(last["metrics/dice_index_threshold_0.5"]) < 1
    assert np.isfinite(float(last["val_dice_loss"]))
