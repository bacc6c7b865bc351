"""The paper's other two downstream families through the port, on the CPU:
the Swin U-Net and the ResNet attention U-Net of
``tests/test_model_families_e2e.py``.

* The encoder transfer: ``weight_init/encoder/weights`` naming a
  reference-named encoder state dict (torch module names, written here from
  a seed) or a pretraining checkpoint of the port (``layers.0.`` and the
  port's names, beside the JAX package's msgpack of the same weights)
  grafts into the U-Net's ``enc`` exactly what the JAX wrapper grafts from
  the same file, bit for bit, and leaves the decoder as it was.
* The experiment CLI: both CLIs, the JAX package's and the port's, train
  each family for two epochs from the same weights at stochastic depth 0,
  and their epoch and batch logs agree within 1e-4; at the configs' own
  rate (0.1 for the Swin U-Net) the port's run learns (a strict 0 < Dice
  < 1 and a loss above 0, as the JAX e2e tests require), repeats from its
  seed, and resumes under ``--continued``."""
import csv

import jax
import numpy as np
import pytest
import torch
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

from torch_port_helpers import (attention_unet_config, build_model,
                                model_config, reference_state,
                                torch_switches_kept, transplant)

#: the bar on every loss, Dice and learning-rate value of the two CLIs'
#: logs (the repo's bar on the CLIs, ``tests/test_torch_cli.py``)
TOL = 1e-4
SIZE, EPOCHS = 32, 2


@pytest.fixture(scope="module", autouse=True)
def keep_torch_switches():
    """The CLI runs of this file set torch's thread count (the config
    default, 16) in this process; the next file's tests get it back."""
    with torch_switches_kept():
        yield


def swin_config(rate=0.1):
    """tests/test_model_families_e2e.py's Swin U-Net model section."""
    cfg = model_config(img=SIZE, embed=8, channels=(8, 16), heads=(2, 4),
                       window=4)
    cfg["model"]["segmentation.models.UNet"]["architecture"][
        "stochastic depth rate"] = rate
    return cfg


FAMILIES = {"swin": swin_config, "resnet": lambda rate=0.0:
            attention_unet_config()}
#: the e2e tests' random initialisation of each family
RANDOM_INIT = {
    "swin": {"random": {"timm.models.layers.trunc_normal_": {"std": 0.02}}},
    "resnet": {"random": {"torch.nn.init.kaiming_normal_": {
        "nonlinearity": "relu"}}}}


def _models(family, rate=0.0):
    cfg = FAMILIES[family](rate)
    return (build_model(JaxConfigDict, jax_registry, JaxModel, cfg),
            build_model(ConfigDict, registry, Model, cfg))


def _variables(jmodel, seed):
    return jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.key(seed), {"x": np.zeros((1, SIZE, SIZE, 3),
                                             np.float32)}))


# ---------------------------------------------------------------------------
# the encoder transfer
# ---------------------------------------------------------------------------

def _encoder_weights(variables, seed):
    """The ``enc`` subtree of *variables* drawn anew from a seed: every
    parameter and running statistic differs from the U-Net's own."""
    rng = np.random.default_rng(seed)
    return {col: jax.tree_util.tree_map(
        lambda a: (rng.random(a.shape) + 0.5).astype(np.float32),
        tree["enc"]) for col, tree in variables.items() if "enc" in tree}


@pytest.mark.parametrize("source", ["reference", "port_pretraining"])
@pytest.mark.parametrize("family", ["swin", "resnet"])
def test_encoder_graft_equals_jax(tmp_path, family, source, capsys):
    jmodel, model = _models(family)
    variables = _variables(jmodel, 1)
    transplant(variables, model.module)
    before = {k: v.clone() for k, v in model.module.state_dict().items()}
    encoder = _encoder_weights(variables, 2)
    port_encoder = state_dict_from_jax(encoder, model.module.enc)
    if source == "reference":
        path = tmp_path / "reference.pt"
        torch.save(reference_state(port_encoder, family), path)
        jax_path = path
    else:
        head = {"Dense_0": {"kernel": np.ones((16, 5), np.float32),
                            "bias": np.zeros(5, np.float32)}}
        path, jax_path = tmp_path / "epoch_1.pt", tmp_path / "epoch_1.msgpack"
        ckpt.save_params_file(str(path), {
            **{f"layers.0.{k}": v for k, v in port_encoder.items()},
            "layers.3.Dense_0.weight": torch.ones(5, 16),
            "layers.3.Dense_0.bias": torch.zeros(5)})
        jax_ckpt.save_params_file(str(jax_path), {
            col: {"layers_0": tree, **({"layers_3": head}
                                      if col == "params" else {})}
            for col, tree in encoder.items()})
    enc_cfg = {"weights": str(path), "strict": True}
    model.init_weight(ConfigDict({"weight_init": {"encoder": enc_cfg}}),
                      torch.Generator().manual_seed(0))
    assert "Successfully initialised encoder" in capsys.readouterr().out
    got = model.module.state_dict()
    jvars = jmodel._encoder_transfer(JaxConfigDict({"weight_init": {
        "encoder": {**enc_cfg, "weights": str(jax_path)}}}), variables)
    assert "Successfully initialised encoder" in capsys.readouterr().out
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jvars),
                               model.module)
    for name, value in got.items():
        if name.endswith("num_batches_tracked"):
            continue
        assert torch.equal(value, want[name]), name
        if name.startswith("enc."):
            assert torch.equal(value, port_encoder[name[4:]]), name
        else:
            assert torch.equal(value, before[name]), name


# ---------------------------------------------------------------------------
# the experiment CLI
# ---------------------------------------------------------------------------

def _cli_config(logs, family, rate, weights=None, epochs=EPOCHS,
                name="run", **technical):
    """tests/test_model_families_e2e.py's config for *family* at stochastic
    depth *rate*, from *weights* when given (else the e2e tests' random
    init)."""
    model = dict(FAMILIES[family](rate)["model"]["segmentation.models.UNet"])
    model["weight_init"] = RANDOM_INIT[family] if weights is None \
        else {"weights": str(weights)}
    return {
        "data": {
            "data": {"segmentation.datasets.COVIDQUDataset": {
                "lung_or_infection": "inf", "image_sizes": SIZE,
                "validate_on_test": True, "seed": 1}},
            "sampling": {"batch_size": 4},
            "transforms": {"train": "transform.RepeatChannels",
                           "val": "transform.RepeatChannels",
                           "casting": {"mask": "torch.LongTensor"}}},
        "model": {"segmentation.models.UNet": model},
        "training": {
            "loss": "segmentation.losses.DiceLoss",
            "optimizer": {"sgd": {"learning_rate": {
                "constant": {"base": 0.01}}}}},
        "metrics": {"calculation": {"thresholds": 0.5, "label_type": "mask"},
                    "metrics": ("metrics.DiceIndex",)},
        "experiment": {"number_of_epochs": epochs},
        "meta": {"technical": {
            "experiment_name": name, "maximum_actual_batch_size": 4,
            "seed": 3, "verbose": False, "export_plots_as": ("json",),
            "log_best_model": False, "log_last_model": True,
            "name_fields": (), "save_destination": str(logs),
            **technical}},
    }


def _run(runner, root, cfg, name, *flags):
    path = root / f"{name}.yaml"
    path.write_text(yaml.dump(cfg))
    runner([str(path), *flags])


def _rows(run_dir, name="epoch_logs.csv"):
    with open(run_dir / "run_1" / name, newline="") as fh:
        return list(csv.DictReader(fh))


def _run_dir(logs, name):
    (day,) = [d for d in logs.iterdir() if d.is_dir()]
    return day / name


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """tests/test_model_families_e2e.py's COVID-QU tree: 8 + 4 noise images
    of 32 x 32 with a square mask."""
    root = tmp_path_factory.mktemp("families")
    rng = np.random.default_rng(0)
    base = root / "data" / "COVID_QU" / "Inf_segm" / "data arrays" \
        / "COVID-19"
    for part, n in (("train and val", 8), ("test", 4)):
        d = base / part
        d.mkdir(parents=True)
        np.save(d / "imgs.npy",
                (rng.random((n, 1, SIZE, SIZE)) * 255).astype(np.uint8))
        masks = np.zeros((n, 1, SIZE, SIZE), np.uint8)
        masks[:, :, 10:22, 10:22] = 2
        np.save(d / "inf_masks.npy", masks)
    mp = pytest.MonkeyPatch()
    mp.setenv("MST_DATA_DIR", str(root / "data"))
    yield root
    mp.undo()


@pytest.mark.parametrize("family", ["swin", "resnet"])
def test_family_clis_write_the_same_logs(tree, family):
    """Two epochs of each CLI from the same weights (a JAX msgpack and its
    ``.pt`` translation) at stochastic depth 0."""
    jmodel, model = _models(family, rate=0.0)
    variables = _variables(jmodel, 4)
    jax_weights = tree / f"{family}.msgpack"
    jax_ckpt.save_params_file(str(jax_weights), variables)
    port_weights = tree / f"{family}.pt"
    ckpt.save_params_file(str(port_weights),
                          state_dict_from_jax(variables, model.module))
    name = f"{family}_parity"
    _run(jax_main, tree, _cli_config(tree / "jax_logs", family, 0.0,
                                     jax_weights, name=name), f"jax_{name}")
    _run(main, tree, _cli_config(tree / "port_logs", family, 0.0,
                                 port_weights, name=name), name,
         "--device", "cpu")
    jax_dir, port_dir = (_run_dir(tree / logs, name)
                         for logs in ("jax_logs", "port_logs"))
    for log in ("epoch_logs.csv", "batch_logs.csv"):
        got, want = _rows(port_dir, log), _rows(jax_dir, log)
        assert len(got) == len(want) > 0 and set(got[0]) == set(want[0])
        for k, (a, b) in enumerate(zip(got, want)):
            for key in b:
                if "loss" in key or "dice" in key or key == "learning_rate":
                    np.testing.assert_allclose(
                        float(a[key]), float(b[key]), rtol=TOL, atol=TOL,
                        err_msg=f"{family} {log} row {k} {key}")
    assert len(_rows(port_dir)) == EPOCHS
    assert (port_dir / "run_1" / "last_model_state_dict.pt").is_file()


@pytest.mark.parametrize("family", ["swin", "resnet"])
def test_family_cli_learns_repeats_and_resumes(tree, family):
    """The configs' own rates and random init: the run learns (strict 0 <
    Dice < 1, loss > 0 in every epoch), a second run from the same seed
    writes the same logs, and ``--continued`` adds a third epoch."""
    runs = []
    for k in range(2):
        name = f"{family}_run{k}"
        _run(main, tree, _cli_config(tree / f"{name}_logs", family, 0.1,
                                     name=name), name, "--device", "cpu")
        runs.append(_run_dir(tree / f"{name}_logs", name))
    rows = _rows(runs[0])
    assert rows == _rows(runs[1])
    assert _rows(runs[0], "batch_logs.csv") == _rows(runs[1],
                                                     "batch_logs.csv")
    for row in rows:
        assert 0.0 < float(row["metrics/dice_index_threshold_0.5"]) < 1.0
        assert float(row["dice_loss"]) > 0.0
    name = f"{family}_run0"
    _run(main, tree, _cli_config(
        tree / f"{name}_logs", family, 0.1, name=name, epochs=EPOCHS + 1,
        absolute_path=str(runs[0]) + "/"), f"{name}_resume",
        "--continued", "--device", "cpu")
    assert [int(r["epoch"]) for r in _rows(runs[0])] == [1, 2, 3]
    assert ckpt.load_params_file(
        runs[0] / "run_1" / "checkpoint_epoch.pt") == {"epoch": 3}
