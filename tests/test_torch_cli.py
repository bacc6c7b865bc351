"""Both CLIs, the JAX package's and the port's, on a tiny COVID-QU config
(a depth-1 U-Net at 16 x 16 on a synthetic tree, Dice loss and
``metrics.DiceIndex``), on the CPU, from the same weights: a JAX msgpack
checkpoint for the JAX CLI and its ``.pt`` translation for the port.  The
two write the same CSV columns and the same run files (``.pt`` for
``.msgpack``), and their loss and Dice columns agree within 1e-4.  The
port's ``--continued`` grows epoch_logs.csv and writes the backups; a YAML
list gives a grid with dedup-suffixed directories and comparisons; a bad
component name does not stop the grid.  The same holds for a tiny ACDC
config of the multiclass U-Net (softmax head, the multiclass metrics, the
confusion-matrix export, profiling), and the ``meta/technical`` switches
(deterministic algorithms, CPU threads, the NaN check) reach torch."""
import csv
import json
import pathlib

import jax
import numpy as np
import pytest
import yaml

from medsegpretrainimagenet_tpu.cli.experiment import main as jax_main
from medsegpretrainimagenet_tpu.config import ConfigDict as JaxConfigDict
from medsegpretrainimagenet_tpu.config import registry as jax_registry
from medsegpretrainimagenet_tpu.models import Model as JaxModel
from medsegpretrainimagenet_tpu.train import checkpoint as jax_ckpt
from medsegpretrainimagenet_tpu_torch.cli.experiment import main
from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
from medsegpretrainimagenet_tpu_torch.models import Model
from medsegpretrainimagenet_tpu_torch.train import checkpoint as ckpt
from medsegpretrainimagenet_tpu_torch.transfer import state_dict_from_jax

from torch_port_helpers import build_model

TOL = 1e-4
ARCH = {"in_channel_size": 3, "out_channel_size": 1, "channels": (4, 8),
        "depth": 1}


def _config(logs, weights, epochs=3, **technical):
    """The verify skill's tiny COVID-QU config, DiceIndex only, in whole
    batches: under the tests the JAX CLI sees eight virtual CPU devices and
    would size its fragments for them."""
    return {
        "experiment": {"number_of_epochs": epochs, "number_of_trials": 1},
        "meta": {"technical": {"seed": 777, "save_destination": str(logs),
                               "export_plots_as": ["json"],
                               "maximum_actual_batch_size": 4,
                               **technical}},
        "data": {"data": {"segmentation.datasets.COVIDQUDataset": {
            "lung_or_infection": "inf", "image_sizes": 16,
            "validate_on_test": True, "seed": 20231027}},
            "sampling": {"batch_size": 4},
            "transforms": {"train": "transform.RepeatChannels",
                           "val": "transform.RepeatChannels",
                           "casting": {"mask": "torch.LongTensor"}}},
        "model": {"segmentation.models.UNet": {
            "architecture": dict(ARCH),
            "final_activation": "sigmoid",
            "weight_init": {"weights": str(weights)}}},
        "training": {
            "loss": {"segmentation.losses.DiceLoss": {}},
            "optimizer": {"sgd": {"learning_rate": {
                "optim.scheduler.PolyLearningRateDecay": {
                    "base": 0.01, "exponent": 0.9, "iteration_unit": "batch",
                    "number_of_iterations": "auto"}}}}},
        "metrics": {"metrics": ("metrics.DiceIndex",)},
    }


def _write(path, cfg):
    path.write_text(yaml.dump(cfg))
    return str(path)


def _rows(path):
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


def _run_dir(logs: pathlib.Path, name="Experiment"):
    (day,) = [d for d in logs.iterdir() if d.is_dir()]
    return day / name


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The synthetic data tree and the two weight files."""
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    base = root / "data" / "COVID_QU" / "Inf_segm" / "data arrays" \
        / "COVID-19"
    for part, n in (("train and val", 12), ("test", 4)):
        d = base / part
        d.mkdir(parents=True)
        np.save(d / "imgs.npy",
                (rng.random((n, 1, 20, 20)) * 255).astype(np.uint8))
        masks = np.zeros((n, 1, 20, 20), np.uint8)
        masks[:, :, 6:14, 6:14] = 2
        np.save(d / "inf_masks.npy", masks)
    cfg = {"model": {"segmentation.models.UNet": {"architecture": ARCH}}}
    jmodel = build_model(JaxConfigDict, jax_registry, JaxModel, cfg)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.key(0), {"x": np.zeros((1, 16, 16, 3), np.float32)}))
    jax_weights = root / "weights.msgpack"
    jax_ckpt.save_params_file(str(jax_weights), variables)
    port_weights = root / "weights.pt"
    module = build_model(ConfigDict, registry, Model, cfg).module
    ckpt.save_params_file(str(port_weights),
                          state_dict_from_jax(variables, module))
    return root, jax_weights, port_weights


@pytest.fixture(scope="module")
def both_runs(tree):
    root, jax_weights, port_weights = tree
    mp = pytest.MonkeyPatch()
    mp.setenv("MST_DATA_DIR", str(root / "data"))
    try:
        jax_main([_write(root / "jax.yaml",
                         _config(root / "jax_logs", jax_weights))])
        main([_write(root / "port.yaml",
                     _config(root / "port_logs", port_weights)),
              "--device", "cpu"])
    finally:
        mp.undo()
    return (_run_dir(root / "jax_logs"), _run_dir(root / "port_logs"))


def test_clis_write_the_same_columns_and_values(both_runs):
    jax_dir, port_dir = both_runs
    for name in ("epoch_logs.csv", "batch_logs.csv"):
        got, want = _rows(port_dir / "run_1" / name), \
            _rows(jax_dir / "run_1" / name)
        assert len(got) == len(want) > 0, name
        assert set(got[0]) == set(want[0]), name
        for k, (a, b) in enumerate(zip(got, want)):
            for key in b:
                if "loss" in key or "dice" in key or key == "learning_rate":
                    np.testing.assert_allclose(
                        float(a[key]), float(b[key]), rtol=TOL, atol=TOL,
                        err_msg=f"{name} row {k} {key}")
    assert len(_rows(port_dir / "run_1" / "epoch_logs.csv")) == 3
    # chip_smoke.py's [cli] holds the card's run to this column set
    import chip_smoke
    assert set(_rows(jax_dir / "run_1" / "epoch_logs.csv")[0]) \
        == chip_smoke.CLI_EPOCH_COLUMNS
    # COVID-QU has no test split (validate_on_test folds it into val), so
    # neither CLI writes test_logs.csv
    assert not (jax_dir / "run_1" / "test_logs.csv").exists()


def test_clis_write_the_same_files(both_runs):
    jax_dir, port_dir = both_runs

    def files(d):
        return sorted(str(p.relative_to(d)).replace(".msgpack", ".pt")
                      for p in d.rglob("*") if p.is_file())
    assert files(port_dir) == files(jax_dir)
    written = yaml.full_load((port_dir / "config.yaml").read_text())
    assert written["model"]["segmentation.models.UNet"]["architecture"][
        "channels"] == (4, 8)
    assert written["meta"]["technical"]["absolute_path"] == \
        str(port_dir) + "/"
    assert yaml.full_load((port_dir / "source_config.yaml").read_text()) \
        == yaml.full_load((port_dir.parent.parent.parent
                           / "port.yaml").read_text())


def test_continued_resumes_and_backs_up(tree, both_runs, monkeypatch):
    root, _, port_weights = tree
    _, port_dir = both_runs
    monkeypatch.setenv("MST_DATA_DIR", str(root / "data"))
    cfg = _config(root / "port_logs", port_weights, epochs=4,
                  absolute_path=str(port_dir) + "/")
    main([_write(root / "resume.yaml", cfg), "--continued",
          "--device", "cpu"])
    run = port_dir / "run_1"
    rows = _rows(run / "epoch_logs.csv")
    assert [int(r["epoch"]) for r in rows] == [1, 2, 3, 4]
    assert len(_rows(run / "batch_logs.csv")) == 4 * 3
    for name in ("last_model_state_dict_checkpoint.pt",
                 "optimizer_state_dict_checkpoint.pt"):
        assert (run / name).is_file(), name
    assert ckpt.load_params_file(run / "checkpoint_epoch.pt") == {"epoch": 4}
    assert ckpt.load_state_file(run / "optimizer_state_dict.pt")["step"] \
        == 4 * 3


def test_grid_dirs_comparisons_and_a_bad_name(tree, monkeypatch, capsys):
    """A YAML list over the model name: the misspelt one fails with a
    RegistryError and suggestions, and the grid runs the two good ones
    into ``Experiment`` and ``Experiment_2`` with cross-experiment
    comparisons."""
    root, _, port_weights = tree
    monkeypatch.setenv("MST_DATA_DIR", str(root / "data"))
    logs = root / "grid_logs"
    cfg = _config(logs, port_weights, epochs=1)
    model = cfg["model"]["segmentation.models.UNet"]
    cfg["model"] = [{"segmentation.models.UNett": model},
                    {"segmentation.models.UNet": model},
                    {"segmentation.models.UNet": model}]
    main([_write(root / "grid.yaml", cfg), "--device", "cpu"])
    err = capsys.readouterr().err
    assert "Unknown component 'segmentation.models.UNett'" in err
    assert "Did you mean" in err
    (day,) = list(logs.iterdir())
    assert sorted(p.name for p in day.iterdir()) == ["Experiment",
                                                      "Experiment_2"]
    for name in ("Experiment", "Experiment_2"):
        run = day / name / "run_1"
        assert len(_rows(run / "epoch_logs.csv")) == 1
        assert (run / "comparisons" / "best_values_comparison.csv").is_file()
        assert (run / "comparisons" / "last_values_comparison.csv").is_file()


def test_device_augmentation_lifts_the_chain_like_jax(tree, monkeypatch):
    """``device_augmentation: true`` lifts the leading rotation, flip and
    channel repeat into the train step and leaves the rest on the host, as
    the JAX CLI splits it; one epoch trains with the chain on the CPU."""
    import torch

    from medsegpretrainimagenet_tpu.cli import run_experiment as jax_run
    from medsegpretrainimagenet_tpu_torch.cli import run_experiment

    train = [{"segmentation.transforms.wrapped_transforms.RandomRotation":
              {"limit": 30}},
             {"segmentation.transforms.wrapped_transforms.RandomFlip": {}},
             "transform.RepeatChannels",
             {"segmentation.transforms.wrapped_transforms.CenterCrop":
              {"size": 12}}]
    splits = []
    for cd_cls, module in ((JaxConfigDict, jax_run),
                           (ConfigDict, run_experiment)):
        cd = cd_cls({"data": {"transforms": {"train": train,
                                             "val": []}}})
        pipelines = module.build_transform_pipelines(
            cd, 3, device_augmentation=True)
        splits.append(([type(t).__name__
                        for t in pipelines[0].transforms],
                       pipelines[4] is not None))
        augment = pipelines[4]
    assert splits[0] == splits[1] == (["CenterCrop", "ConvertToType"], True)
    out = augment(torch.Generator().manual_seed(0),
                  {"x": torch.rand(2, 16, 16, 1),
                   "mask": torch.zeros(2, 16, 16, dtype=torch.int32)})
    assert out["x"].shape == (2, 16, 16, 3)

    root, _, port_weights = tree
    monkeypatch.setenv("MST_DATA_DIR", str(root / "data"))
    cfg = _config(root / "augment_logs", port_weights, epochs=1,
                  device_augmentation=True)
    cfg["data"]["transforms"]["train"] = tuple(train[:3])  # not a grid
    main([_write(root / "augment.yaml", cfg), "--device", "cpu"])
    rows = _rows(_run_dir(root / "augment_logs") / "run_1"
                 / "epoch_logs.csv")
    assert len(rows) == 1 and 0 < float(rows[0]["dice_loss"]) < 1


# ---------------------------------------------------------------------------
# the ACDC multiclass U-Net through both CLIs
# ---------------------------------------------------------------------------

ACDC_CLASSES = ("RV cavity", "myocardium", "LV cavity")
ACDC_ARCH = dict(ARCH, out_channel_size=4)
ACDC_METRICS = ("metrics.multiclass_metrics.DiceIndex",
                "metrics.multiclass_metrics.JaccardIndex",
                "metrics.multiclass_metrics.ModifiedHausdorffDistance",
                "metrics.multiclass_metrics.AUROC")


def acdc_config(logs, weights, epochs=3, **technical):
    """A tiny ACDC config of the ``config/downstream/acdc/unet.yaml`` shape:
    a 4-channel softmax head, batchwise multiclass Dice loss with the
    background, the multiclass metrics with classwise columns, the
    confusion-matrix export, profiling and a watched mean Dice."""
    cfg = _config(logs, weights, epochs, profile=True,
                  model_evaluation={"metric": "val_metrics/mean_dice_index",
                                    "mode": "max"}, **technical)
    cfg["data"]["data"] = {"segmentation.datasets.ACDC": {
        "image_sizes": 16, "validate_on_test": True}}
    model = cfg["model"]["segmentation.models.UNet"]
    model["architecture"] = dict(ACDC_ARCH)
    model["final_activation"] = "softmax"
    cfg["training"]["loss"] = {"segmentation.losses.DiceLoss": {
        "batchwise": True, "include_background": True,
        "apply_softmax": False, "smoothing_term": 1e-5}}
    cfg["metrics"] = {"metrics": ACDC_METRICS, "calculation": {
        "number_of_classes": 4, "class_names": ACDC_CLASSES,
        "log_confusion_matrix": True}}
    return cfg


def write_acdc_tree(root, n_train=3, n_test=2, shape=(18, 20, 2), seed=0):
    """ACDC patient directories of two frames each: noisy images with an
    LV disc inside a myocardium ring and an RV crescent beside it."""
    from medsegpretrainimagenet_tpu_torch.data.readers import save_nii

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    for part, n in (("training", n_train), ("testing", n_test)):
        for p in range(n):
            d = root / "ACDC" / part / f"patient{p:03d}"
            d.mkdir(parents=True)
            for frame in (1, 12):
                labels = np.zeros(shape, np.uint8)
                for z in range(shape[2]):
                    cy, cx = rng.integers(6, shape[0] - 6), \
                        rng.integers(6, shape[1] - 6)
                    r = rng.uniform(2, 4)
                    d2 = (yy - cy) ** 2 + (xx - cx) ** 2
                    lab = labels[..., z]
                    lab[d2 < (r + 3) ** 2] = 2
                    lab[d2 < r * r] = 3
                    rv = ((yy - cy) ** 2 + (xx - cx + r + 3) ** 2
                          < (r + 2) ** 2) & (lab == 0)
                    lab[rv] = 1
                img = 40 * labels + rng.normal(0, 10, shape)
                stem = str(d / f"patient{p:03d}_frame{frame:02d}")
                save_nii(stem + ".nii.gz", img.astype(np.float32))
                save_nii(stem + "_gt.nii.gz", labels)


@pytest.fixture(scope="module")
def acdc_runs(tmp_path_factory):
    """Both CLIs on the tiny ACDC config from the same weights."""
    root = tmp_path_factory.mktemp("acdc")
    write_acdc_tree(root / "data")
    cfg = {"model": {"segmentation.models.UNet": {
        "architecture": ACDC_ARCH}}}
    jmodel = build_model(JaxConfigDict, jax_registry, JaxModel, cfg)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.key(0), {"x": np.zeros((1, 16, 16, 3), np.float32)}))
    jax_ckpt.save_params_file(str(root / "w.msgpack"), variables)
    module = build_model(ConfigDict, registry, Model, cfg).module
    ckpt.save_params_file(str(root / "w.pt"),
                          state_dict_from_jax(variables, module))
    mp = pytest.MonkeyPatch()
    mp.setenv("MST_DATA_DIR", str(root / "data"))
    try:
        jax_main([_write(root / "jax.yaml", acdc_config(
            root / "jax_logs", root / "w.msgpack"))])
        main([_write(root / "port.yaml", acdc_config(
            root / "port_logs", root / "w.pt")), "--device", "cpu"])
    finally:
        mp.undo()
    return (_run_dir(root / "jax_logs") / "run_1",
            _run_dir(root / "port_logs") / "run_1")


def test_acdc_clis_write_the_same_columns_and_values(acdc_runs):
    jax_run, port_run = acdc_runs
    for name in ("epoch_logs.csv", "batch_logs.csv"):
        got, want = _rows(port_run / name), _rows(jax_run / name)
        assert len(got) == len(want) > 0, name
        assert set(got[0]) == set(want[0]), name
        for k, (a, b) in enumerate(zip(got, want)):
            for key in b:
                np.testing.assert_allclose(float(a[key]), float(b[key]),
                                           rtol=TOL, atol=TOL,
                                           err_msg=f"{name} row {k} {key}")
    rows = _rows(port_run / "epoch_logs.csv")
    assert len(rows) == 3
    for column in ("val_metrics/dice_index_RV_cavity",
                   "val_metrics/dice_index_myocardium",
                   "val_metrics/dice_index_LV_cavity",
                   "val_metrics/mean_dice_index",
                   "val_metrics/mean_jaccard_index",
                   "val_metrics/modified_hausdorff_distance",
                   "val_metrics/area_under_roc"):
        assert column in rows[0], column
    assert float(rows[-1]["val_metrics/modified_hausdorff_distance"]) > 0
    # chip_smoke.py's [cli acdc] holds the card's run to this column set
    import chip_smoke
    assert set(_rows(jax_run / "epoch_logs.csv")[0]) \
        == chip_smoke.ACDC_EPOCH_COLUMNS


def test_acdc_clis_write_the_same_files(acdc_runs):
    """The same run files (``.pt`` for ``.msgpack``): the confusion
    matrices of the last pass, the classwise Dice plot, the profile; the
    trace is a ``torch.profiler`` Chrome trace in the port and an XLA
    profile in JAX, so only its presence is compared."""
    jax_run, port_run = acdc_runs

    def files(d):
        out = sorted(str(p.relative_to(d)).replace(".msgpack", ".pt")
                     for p in d.rglob("*") if p.is_file())
        traces = [f for f in out if f.startswith("profile/trace/")]
        return [f for f in out if f not in traces], traces
    (got, got_trace), (want, want_trace) = files(port_run), files(jax_run)
    assert got == want
    assert got_trace == ["profile/trace/trace.json"] and want_trace
    assert json.loads((port_run / "profile" / "trace" / "trace.json")
                      .read_text())["traceEvents"]
    for name in ("Confusion_matrices/train_confusion_matrix_epoch_3.json",
                 "Confusion_matrices/val_confusion_matrix_epoch_3.json",
                 "plots/dice_indices_plot.json"):
        got_json, want_json = (json.loads((d / name).read_text())
                               for d in (port_run, jax_run))
        got_json.pop("dirname"), want_json.pop("dirname")
        if "matrix" in want_json:
            np.testing.assert_array_equal(got_json.pop("matrix"),
                                          want_json.pop("matrix"))
        else:
            np.testing.assert_allclose(got_json.pop("Ys"),
                                       want_json.pop("Ys"), atol=TOL)
        assert got_json == want_json, name
    assert not (port_run / "test_logs.csv").exists()


# ---------------------------------------------------------------------------
# meta/technical switches
# ---------------------------------------------------------------------------

@pytest.fixture
def restore_torch_switches():
    import torch
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.backends.cudnn.deterministic, torch.get_num_threads())
    yield
    torch.use_deterministic_algorithms(saved[0])
    torch.backends.cudnn.deterministic = saved[1]
    torch.set_num_threads(saved[2])


@pytest.mark.parametrize("deterministic", [True, False])
def test_host_switches_apply(restore_torch_switches, monkeypatch,
                             deterministic):
    """``use_deterministic_algorithms``, cuDNN's deterministic flag, the
    cuBLAS workspace setting and ``number_of_cpu_threads`` reach torch."""
    import os

    import torch

    from medsegpretrainimagenet_tpu_torch.cli.run_experiment import \
        apply_host_switches
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    apply_host_switches(ConfigDict({
        "use_deterministic_algorithms": deterministic,
        "number_of_cpu_threads": 2}), torch.device("cpu"))
    assert torch.are_deterministic_algorithms_enabled() == deterministic
    assert torch.backends.cudnn.deterministic == deterministic
    assert torch.get_num_threads() == 2
    assert (os.environ.get("CUBLAS_WORKSPACE_CONFIG") == ":4096:8") \
        == deterministic


def test_cli_under_determinism_and_debug_nans(tree, monkeypatch,
                                              restore_torch_switches):
    """One epoch with deterministic algorithms, three CPU threads and the
    NaN check on trains as before and sets the switches."""
    import torch
    root, _, port_weights = tree
    monkeypatch.setenv("MST_DATA_DIR", str(root / "data"))
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    cfg = _config(root / "det_logs", port_weights, epochs=1,
                  use_deterministic_algorithms=True,
                  number_of_cpu_threads=3, debug_nans=True)
    main([_write(root / "det.yaml", cfg), "--device", "cpu"])
    assert torch.are_deterministic_algorithms_enabled()
    assert torch.get_num_threads() == 3
    rows = _rows(_run_dir(root / "det_logs") / "run_1" / "epoch_logs.csv")
    assert len(rows) == 1 and 0 < float(rows[0]["dice_loss"]) < 1


# ---------------------------------------------------------------------------
# ImageNet pretraining of the U-Net encoder, and its transfer downstream
# ---------------------------------------------------------------------------

#: the train chain of the pretraining configs (``bench.py``'s), its crop
#: the whole 16² image: a resize's float rounding (held in
#: ``test_torch_classification.py``) ahead of RandAugment's steps
#: (Posterize's uint8 cast, Solarize's threshold) would move a value by a
#: gray level now and then, and a batch-of-4 AUROC by a rank
PRETRAIN_CHAIN = {
    "train": (
        {"torchvision.transforms.RandomResizedCrop": {
            "size": 16, "scale": (1.0, 1.0), "ratio": (1.0, 1.0)}},
        "torchvision.transforms.RandomHorizontalFlip",
        "classification.transforms.RandAugment",
        {"classification.transforms.OneHotEncoding": {"num_classes": 5}},
        {"classification.transforms.MixupOrCutMix": {
            "mixup_params": {"distribution": "uniform",
                             "probability": 0.8}}},
        {"torchvision.transforms.RandomErasing": {"p": 0.25}}),
    "val": ({"torchvision.transforms.CenterCrop": {"size": 12}},)}


#: AdamW's epsilon in the parity runs.  The gradient of a conv bias that
#: feeds a BatchNorm is zero up to rounding noise, which differs between
#: the packages; AdamW divides it by its own root mean square, so at the
#: default 1e-8 each package's noise moves those biases by up to the
#: learning rate per step, and the running means (and every val column)
#: with them.  1e-4 keeps the noise from moving them and leaves the real
#: updates as they are.
PARITY_ADAMW_EPS = 1e-4


def _pretrain_config(root, weights, name, chain=False):
    """``tests/test_pretrain_transfer_e2e.py``'s scaled pretraining config,
    from *weights*, AdamW's epsilon at PARITY_ADAMW_EPS; with *chain*, the
    pretraining train chain as well (soft labels, pairs of datapoints)."""
    from test_pretrain_transfer_e2e import pretraining_config
    cfg = pretraining_config(root)
    cfg["meta"]["technical"].update(experiment_name=name,
                                    save_destination=str(root / "logs"))
    cfg["model"]["model.FeedForwardModel"]["weight_init"] = {
        "weights": str(weights)}
    cfg["training"]["optimizer"]["torch.optim.AdamW"]["eps"] = \
        PARITY_ADAMW_EPS
    if chain:
        cfg["data"]["transforms"] = dict(PRETRAIN_CHAIN)
    return cfg


def _downstream_config(root, unet_weights, encoder_weights, name):
    """``tests/test_pretrain_transfer_e2e.py``'s downstream config, its
    random init replaced by *unet_weights* so that both CLIs start from the
    same decoder, and the encoder from *encoder_weights*."""
    from test_pretrain_transfer_e2e import downstream_config
    cfg = downstream_config(root, str(encoder_weights))
    cfg["meta"]["technical"].update(experiment_name=name,
                                    save_destination=str(root / "logs"))
    init = cfg["model"]["segmentation.models.UNet"]["weight_init"]
    init.pop("random")
    init["weights"] = str(unet_weights)
    return cfg


def _both_weights(root, name, cfg, shape):
    """One JAX init as a msgpack file and as its port translation."""
    jmodel = build_model(JaxConfigDict, jax_registry, JaxModel, cfg)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.key(0), {"x": np.zeros(shape, np.float32)}))
    jax_ckpt.save_params_file(str(root / f"{name}.msgpack"), variables)
    module = build_model(ConfigDict, registry, Model, cfg).module
    ckpt.save_params_file(str(root / f"{name}.pt"),
                          state_dict_from_jax(variables, module))
    return root / f"{name}.msgpack", root / f"{name}.pt"


@pytest.fixture(scope="module")
def pretrain_runs(tmp_path_factory):
    """Both CLIs pretrain (plain and with the chain), then each trains the
    downstream U-Net from its own epoch-1 checkpoint."""
    from test_pretrain_transfer_e2e import pretraining_config
    root = tmp_path_factory.mktemp("pretrain")
    rng = np.random.default_rng(0)
    store = root / "data" / "imagenet"
    store.mkdir(parents=True)
    labels = {}
    for i in range(20):
        name = f"{'val' if i >= 16 else 'train'}_{i:03d}.npy"
        np.save(store / name,
                (rng.random((3, 16, 16)) * 255).astype(np.uint8))
        labels[name] = int(rng.integers(1, 6))
    (store / "labels.json").write_text(json.dumps(labels))
    base = root / "data" / "COVID_QU" / "Inf_segm" / "data arrays" \
        / "COVID-19"
    for part, n in (("train and val", 8), ("test", 4)):
        d = base / part
        d.mkdir(parents=True)
        np.save(d / "imgs.npy",
                (rng.random((n, 1, 16, 16)) * 255).astype(np.uint8))
        masks = np.zeros((n, 1, 16, 16), np.uint8)
        masks[:, :, 5:11, 5:11] = 2
        np.save(d / "inf_masks.npy", masks)

    pre = {"model": pretraining_config(root)["model"]}
    pre_weights = _both_weights(root, "pretrain", pre, (1, 16, 16, 3))
    unet = {"model": {"segmentation.models.UNet": {"architecture": {
        "in_channel_size": 3, "out_channel_size": 1, "channels": (4, 8),
        "depth": 1}}}}
    unet_weights = _both_weights(root, "unet", unet, (1, 16, 16, 3))

    runs = {}
    mp = pytest.MonkeyPatch()
    mp.setenv("MST_DATA_DIR", str(root / "data"))
    mp.chdir(root)
    try:
        for pkg, run_cli, weights, unet_w, extra in (
                ("jax", jax_main, pre_weights[0], unet_weights[0], []),
                ("port", main, pre_weights[1], unet_weights[1],
                 ["--device", "cpu"])):
            for chain in (False, True):
                name = f"{pkg}_pretrain{'_chain' if chain else ''}"
                run_cli([_write(root / f"{name}.yaml", _pretrain_config(
                    root, weights, name, chain))] + extra)
                runs[name] = _run_dir(root / "logs", name) / "run_1"
            suffix = ".msgpack" if pkg == "jax" else ".pt"
            encoder = runs[f"{pkg}_pretrain"] \
                / f"model_state_dict_epoch_1{suffix}"
            name = f"{pkg}_downstream"
            run_cli([_write(root / f"{name}.yaml", _downstream_config(
                root, unet_w, encoder, name))] + extra)
            runs[name] = _run_dir(root / "logs", name) / "run_1"
    finally:
        mp.undo()
    return runs


def _assert_logs_match(port_run, jax_run, rows):
    for name in ("epoch_logs.csv", "batch_logs.csv"):
        got, want = _rows(port_run / name), _rows(jax_run / name)
        assert len(got) == len(want) > 0, name
        assert set(got[0]) == set(want[0]), name
        for k, (a, b) in enumerate(zip(got, want)):
            for key in b:
                np.testing.assert_allclose(float(a[key]), float(b[key]),
                                           rtol=TOL, atol=TOL,
                                           err_msg=f"{name} row {k} {key}")
    assert len(_rows(port_run / "epoch_logs.csv")) == rows


@pytest.mark.parametrize("chain", ["", "_chain"], ids=["plain", "chain"])
def test_pretraining_clis_write_the_same_logs_and_files(pretrain_runs,
                                                        chain):
    jax_run = pretrain_runs[f"jax_pretrain{chain}"]
    port_run = pretrain_runs[f"port_pretrain{chain}"]
    _assert_logs_match(port_run, jax_run, rows=2)
    row = _rows(port_run / "epoch_logs.csv")[-1]
    for column in ("cross_entropy_loss", "metrics/accuracy",
                   "metrics/area_under_roc", "val_cross_entropy_loss",
                   "val_metrics/accuracy", "val_metrics/area_under_roc"):
        assert column in row, column
    assert float(row["cross_entropy_loss"]) > 0
    # chip_smoke.py's [cli pretrain] holds the card's run to this column set
    import chip_smoke
    assert set(_rows(jax_run / "epoch_logs.csv")[0]) \
        == chip_smoke.PRETRAIN_EPOCH_COLUMNS

    def files(d):
        return sorted(str(p.relative_to(d)).replace(".msgpack", ".pt")
                      for p in d.rglob("*") if p.is_file())
    assert files(port_run) == files(jax_run)
    assert "model_state_dict_epoch_1.pt" in files(port_run)
    for prefix in ("train_", "val_"):
        for epoch in (1, 2):
            name = (f"Confusion_matrices/{prefix}confusion_matrix_epoch_"
                    f"{epoch}.json")
            got, want = (json.loads((d / name).read_text())
                         for d in (port_run, jax_run))
            got.pop("dirname"), want.pop("dirname")
            np.testing.assert_array_equal(got.pop("matrix"),
                                          want.pop("matrix"))
            assert got == want, name
    # the epoch checkpoint holds the encoder under the layers.0. prefix
    params, stats = ckpt.load_encoder_variables(
        port_run / "model_state_dict_epoch_1.pt")
    assert "stem_block.Conv_0.weight" in params and stats


def test_downstream_clis_train_from_their_own_checkpoints(pretrain_runs):
    jax_run = pretrain_runs["jax_downstream"]
    port_run = pretrain_runs["port_downstream"]
    _assert_logs_match(port_run, jax_run, rows=1)
    # the encoder started from the pretraining checkpoint
    params, _ = ckpt.load_encoder_variables(
        pretrain_runs["port_pretrain"] / "model_state_dict_epoch_1.pt")
    final = ckpt.load_params_file(port_run / "last_model_state_dict.pt")
    start = params["stem_block.Conv_0.weight"]
    assert (final["enc.stem_block.Conv_0.weight"] - start).abs().mean() \
        < 0.05
