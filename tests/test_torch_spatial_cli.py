"""The experiment CLI under spatial sharding on the CPU, for the model
families that ``tests/test_torch_spatial.py``'s CLI test does not run: with
``spatial_sharding: 2`` under four gloo ranks (data x spatial 2 x 2), the
port writes the JAX CLI's ``epoch_logs.csv`` of the same run without
spatial sharding within CLI_TOL (the rule of that test: the JAX CLI's own
spatially sharded run writes other validation columns, ROADMAP queue F).

* The Swin U-Net at 32 x 32 (patch 4, window 2, channels 8-16-32): its
  levels of 8 and 4 token rows run on bands of 4 and 2 rows with the shift
  crossing them, its 2 x 2 bottleneck whole.
* The pretraining classifier (a U-Net encoder, global average pooling, a
  Linear head) on an ImageNet store of 16 x 16 images, cross-entropy with
  label smoothing, the multiclass accuracy and AUROC."""
import json

import jax
import numpy as np
import pytest
import yaml

from torch_port_helpers import (assert_same_logs, cli_run_dir,
                                parallel_cli_config, run_jax_cli, spawn_cli,
                                swin_unet_architecture, write_cli_tree,
                                write_weights)

pytestmark = pytest.mark.skipif(jax.device_count() < 8,
                                reason="needs the 8-device CPU mesh")

CLI_TOL = 1e-4
CLASSES = 5
SWIN_ARCH = {**swin_unet_architecture(img=32, window=2),
             "stochastic depth rate": 0.0}
PRETRAIN_MODEL = {"model.FeedForwardModel": {"layers": (
    {"segmentation.models.UNet_encoder": {
        "in_channel_size": 3, "channels": (4, 8), "depth": 1}},
    {"torch.nn.AdaptiveAvgPool2d": {"output_size": 1}},
    "torch.nn.Flatten",
    {"torch.nn.Linear": {"in_features": 8, "out_features": CLASSES}})}}


def _swin_config(logs, weights, factor):
    cfg = parallel_cli_config(logs, weights, SWIN_ARCH, epochs=1,
                              spatial_sharding=factor)
    cfg["data"]["data"]["segmentation.datasets.COVIDQUDataset"][
        "image_sizes"] = 32
    return cfg


def _write_store(root, n_train=16, n_val=4, side=16, seed=0):
    """An ImageNet store under ``root / "data" / "imagenet"``:
    channels-first uint8 ``.npy`` images, ``labels.json`` with classes
    1..CLASSES (names with ``val`` form the validation split)."""
    rng = np.random.default_rng(seed)
    store = root / "data" / "imagenet"
    store.mkdir(parents=True)
    labels = {}
    for i in range(n_train + n_val):
        name = f"{'val' if i >= n_train else 'train'}_{i:03d}.npy"
        np.save(store / name, (rng.random((3, side, side)) * 255).astype(
            np.uint8))
        labels[name] = int(rng.integers(1, CLASSES + 1))
    (store / "labels.json").write_text(json.dumps(labels))
    return root / "data"


def _pretrain_config(logs, weights, factor):
    cfg = parallel_cli_config(logs, weights, {}, epochs=1,
                              spatial_sharding=factor)
    cfg["data"] = {"data": "classification.datasets.ImageNet",
                   "sampling": {"batch_size": 4},
                   "transforms": {"casting": {"label": "torch.LongTensor"}}}
    cfg["model"] = {name: {**body, "weight_init": {"weights": str(weights)}}
                    for name, body in PRETRAIN_MODEL.items()}
    cfg["training"]["loss"] = {"classification.losses.CrossEntropyLoss": {
        "label_smoothing": 0.1, "label_type": "label"}}
    cfg["metrics"] = {
        "metrics": ("metrics.multiclass_metrics.Accuracy",
                    "metrics.multiclass_metrics.AUROC"),
        "calculation": {"apply_softmax": True,
                        "number_of_classes": CLASSES,
                        "label_type": "label"}}
    return cfg


@pytest.mark.parametrize("family", ["swin_unet", "pretraining"])
def test_cli_under_spatial_sharding_writes_the_jax_logs(tmp_path_factory,
                                                        tmp_path, family):
    root = tmp_path_factory.mktemp(f"sp_{family}")
    if family == "swin_unet":
        data, jax_weights, port_weights = write_cli_tree(
            root, SWIN_ARCH, size=40, init_size=32)
        config = _swin_config
    else:
        data = _write_store(root)
        jax_weights, port_weights = write_weights(
            root, {"model": PRETRAIN_MODEL}, 16, 3)
        config = _pretrain_config
    runs = {}
    for kind, weights, factor in (("jax", jax_weights, 1),
                                  ("port", port_weights, 2)):
        logs = tmp_path / f"{kind}_logs"
        path = tmp_path / f"{kind}.yaml"
        path.write_text(yaml.dump(config(logs, weights, factor)))
        if kind == "jax":
            run_jax_cli(path, data)
        else:
            spawn_cli(4, tmp_path, path, logs, data)
        runs[kind] = cli_run_dir(logs)
    assert_same_logs(runs["port"], runs["jax"], CLI_TOL)
