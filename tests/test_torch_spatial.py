"""Spatial sharding (``medsegpretrainimagenet_tpu_torch.parallel.spatial``,
``shard_batch``'s ``spatial_axis``) on the CPU against the JAX package's
(``tests/test_parallel.py``'s ``test_spatial_sharding_*``) on the 8-device
CPU mesh: gloo ranks, each a process of its own
(``tests/torch_dp_worker.py``), meeting through a ``file://`` rendezvous.

* The eval forward of ``test_spatial_sharding_forward_bitwise``'s U-Net on
  its 2 x 64 x 64 input, at data x spatial 2 x 2 (32 rows a rank, halo
  exchanges in every 3 x 3 conv), equals the JAX forward within 1e-6;
  ``shard_batch`` cuts the rows of image-like leaves and leaves scalar and
  one-hot labels whole (``test_spatial_sharding_skips_label_leaves``).
* The train step of ``test_spatial_sharding_train_step_matches`` at 2 x 2
  equals the JAX step that the JAX test holds its 2 x 4 data x spatial
  step against (loss 1e-5, parameters 5e-5: float32 sums in another order
  before a BatchNorm), and in float64 the port's one process within
  1e-12.
* On two ranks (1 x 2) against the port in one process (loss and gradient
  norm 1e-5, parameters 1e-4 / 1e-6): a ConvNeXt U-Net with 7 x 7
  depthwise convs (halos of 3 rows), layer scaling and stochastic depth; the
  ResNet attention U-Net (the 7 x 7 / 2 stem, the 3 x 3 / 2 max pool, the
  gates' 2 x 2 / 2 convs); a U-Net with dropout whose step rotates and flips
  the whole image on the card before the rows are cut.  The same seed gives
  the same draws: the masks of these models (per sample, per sample and
  channel) do not depend on the rows.
* A height the axis does not divide is refused; the Swin U-Net and a
  pretraining model are taken (``tests/test_torch_spatial_families.py``
  holds them), and a Swin height that the bands cannot split into rows of
  patches is refused.
* The experiment CLI with ``spatial_sharding: 2`` under four ranks (2 x 2)
  writes the JAX CLI's ``epoch_logs.csv`` of the same run without spatial
  sharding within 1e-4."""
import jax
import jax.numpy as jnp
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
from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
from medsegpretrainimagenet_tpu_torch.losses import DiceLoss, Loss
from medsegpretrainimagenet_tpu_torch.metrics import MetricsCalculator
from medsegpretrainimagenet_tpu_torch.models import Model
from medsegpretrainimagenet_tpu_torch.models.unet import UNetEncoder
from medsegpretrainimagenet_tpu_torch.ops.augment import make_device_augment
from medsegpretrainimagenet_tpu_torch.optim import Optimizer
from medsegpretrainimagenet_tpu_torch.parallel import spatial
from medsegpretrainimagenet_tpu_torch.train import (TrainState,
                                                    make_train_step)

from torch_port_helpers import (assert_same_logs, attention_unet_config,
                                build_model, cli_run_dir, model_config,
                                parallel_cli_config, run_jax_cli, spawn_cli,
                                spawn_ranks, transplant, unet_config,
                                write_cli_tree)

pytestmark = pytest.mark.skipif(jax.device_count() < 8,
                                reason="needs the 8-device CPU mesh")

FORWARD_TOL, LOSS_TOL, RTOL, ATOL, CLI_TOL = 1e-6, 1e-5, 1e-4, 1e-6, 1e-4
#: the bar of the ranks' float32 parameters against the JAX one-device
#: step: the bands' sums reach the convs in front of a BatchNorm in another
#: order, and their gradients cancel there.  The JAX package's own 2 x 4
#: data x spatial step reads 1.2e-5 from its one-device step, the port's
#: 2 x 2 as much; in float64 the port's bands read 1.1e-16 from its one
#: process (F64_TOL), so the arithmetic is exact
STEP_TOL, F64_TOL = 5e-5, 1e-12
OPTIMIZER = {"sgd": {"momentum": 0.9,
                     "learning_rate": {"constant": {"base": 0.05}}}}
METRICS = {"metrics": {"metrics": ("metrics.DiceIndex",),
                       "calculation": {"thresholds": 0.5,
                                       "label_type": "mask"}}}
MODEL = unet_config(channels=(4, 8), in_channels=1)
B = "segmentation.models.blocks."
#: the small models held on two ranks against one process: (config, side)
SMALL = {
    "convnext_7x7": (unet_config(
        (8, 16, 32), basic_block={B + "ConvNeXtBlock": {"kernel_size": 7}},
        width=2, residual_connections={
            "down": {"identity": {"expand_method": "repeat"}},
            "up": {"convolution": {"kernel_size": 3}}},
        layer_scaling=0.1, **{"stochastic depth rate": 0.1}), 32),
    "resnet_attention": (attention_unet_config(), 64),
    "dropout_augmented": (unet_config(
        (4, 8), basic_block={B + "ConvBlock": {"dropout": {"rate": 0.5}}}),
        32),
}
AUGMENT = {"rotation_limit": 45.0, "flip_vertical": True,
           "flip_probability": 0.5}
CLI_ARCH = {"in_channel_size": 3, "out_channel_size": 1, "channels": (4, 8),
            "depth": 1}


def _batch(seed, n=16, frag=2, side=16, channels=1):
    """``tests/test_parallel.py``'s ``_batch`` (float images and the mask
    of their bright pixels), at *side* x *side* with *channels*."""
    rng = np.random.default_rng(seed)
    x = rng.random((frag, n, side, side, channels)).astype(np.float32)
    return {"x": x, "mask": (x[..., 0] > 0.6).astype(np.int32)}


def _jax_model():
    model = build_model(JaxConfigDict, jax_registry, JaxModel, MODEL)
    variables = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.key(0), {"x": np.zeros((1, 16, 16, 1), np.float32)}))
    return model, variables


def _port_module(cfg=MODEL):
    return build_model(ConfigDict, registry, Model, cfg).module


def test_forward_at_2x2_equals_jax(tmp_path):
    model, variables = _jax_model()
    x = np.random.default_rng(0).random((2, 64, 64, 1)).astype(np.float32)
    ref = np.asarray(model.module.apply(variables, jnp.asarray(x),
                                        train=False))
    labels = {"x": np.zeros((1, 8, 64, 64, 1), np.float32),
              "mask": np.zeros((1, 8, 64, 64), np.int32),
              "label": np.zeros((1, 8), np.int32),
              "onehot": np.zeros((1, 8, 7), np.float32)}
    payload = tmp_path / "payload.pt"
    torch.save({"grid": (("data", "spatial"), (2, 2)), "model_config": MODEL,
                "state_dict": transplant(variables,
                                         _port_module()).state_dict(),
                "x": x, "labels": labels}, payload)
    spawn_ranks("forward", 4, tmp_path, [f"r{r}.pt" for r in range(4)],
                payload)
    for r in range(4):
        got = torch.load(tmp_path / f"r{r}.pt", weights_only=False)
        assert got["local_shape"] == (1, 32, 64, 1)
        np.testing.assert_allclose(got["out"].numpy(), ref, rtol=0,
                                   atol=FORWARD_TOL, err_msg=f"rank {r}")
        # rows of images and masks, whole labels (4 samples a data rank)
        assert got["batch_shapes"] == {"x": (1, 4, 32, 64, 1),
                                       "mask": (1, 4, 32, 64),
                                       "label": (1, 4), "onehot": (1, 4, 7)}


def _float64(tree):
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v
            for k, v in tree.items()}


def test_train_step_at_2x2_equals_jax(tmp_path):
    """In float32 against the JAX step; in float64 against the port in one
    process, which shows the bands' arithmetic exact."""
    model, variables = _jax_model()
    optimizer = JaxOptimizer(JaxConfigDict(OPTIMIZER), num_epochs=1,
                             batches_per_epoch=4)
    state = JaxTrainState.create(
        variables, optimizer.tx.init(variables["params"]),
        jax.random.key(1))
    loss = JaxLoss(JaxDiceLoss, JaxConfigDict({"label type": "mask"}))
    calculator = JaxCalculator(JaxConfigDict(METRICS), loss=loss)
    step = jax_train_step(model, loss, calculator, optimizer, donate=False)
    # the one-device step, which the JAX test holds its 2 x 4 data x
    # spatial step against
    state, _, per_batch = step(state, calculator.init_state(),
                               jax.device_put(_batch(0), jax.devices()[0]))
    want = transplant(jax.tree_util.tree_map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats}),
        _port_module()).state_dict()
    state_dict = transplant(variables, _port_module()).state_dict()
    run = {"grid": (("data", "spatial"), (2, 2)), "model_config": MODEL,
           "optimizer": OPTIMIZER, "metrics": METRICS, "clip": None}
    wide = {k: v.double() if v.is_floating_point() else v
            for k, v in state_dict.items()}
    payload = tmp_path / "payload.pt"
    torch.save({"runs": [
        {**run, "state_dict": state_dict, "batches": [_batch(0)],
         "held": _batch(9, n=4, frag=1)},
        {**run, "state_dict": wide, "dtype": torch.float64,
         "batches": [_float64(_batch(0))],
         "held": _float64(_batch(9, n=4, frag=1))}]}, payload)
    spawn_ranks("step", 4, tmp_path, [f"r{r}.pt" for r in range(4)],
                payload)
    _, want64 = _one_process(MODEL, wide, [_float64(_batch(0))],
                             dtype=torch.float64)
    for r in range(4):
        got, got64 = torch.load(tmp_path / f"r{r}.pt", weights_only=False)
        np.testing.assert_allclose(got["logs"][0]["dice_loss"],
                                   float(per_batch["dice_loss"]),
                                   rtol=LOSS_TOL, err_msg=f"rank {r}")
        for name, value in want.items():
            if name.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(
                got["state_dict"][name].numpy(), value.numpy(),
                rtol=STEP_TOL, atol=STEP_TOL, err_msg=f"rank {r} {name}")
            np.testing.assert_allclose(
                got64["state_dict"][name].numpy(), want64[name].numpy(),
                rtol=F64_TOL, atol=F64_TOL, err_msg=f"f64 rank {r} {name}")


def _one_process(cfg, state_dict, batches, augment=None,
                 dtype=torch.float32):
    """The port's steps in this process: (per-step logs, state dict)."""
    model = build_model(ConfigDict, registry, Model, cfg)
    model.module.to(dtype)
    model.module.load_state_dict(state_dict)
    optimizer = Optimizer(ConfigDict(OPTIMIZER), num_epochs=1,
                          batches_per_epoch=len(batches))
    state = TrainState.create(model.module, optimizer.init(model.module),
                              seed=1)
    loss = Loss(DiceLoss, ConfigDict({"label type": "mask"}))
    calculator = MetricsCalculator(ConfigDict(METRICS), loss=loss)
    step = make_train_step(model, loss, calculator, optimizer,
                           device_augment=make_device_augment(**augment)
                           if augment else None)
    metrics_state, logs = calculator.init_state("cpu"), []
    for batch in batches:
        state, metrics_state, per_batch = step(
            state, metrics_state,
            {k: torch.from_numpy(v) for k, v in batch.items()})
        logs.append({k: float(v) for k, v in per_batch.items()})
    return logs, model.module.state_dict()


@pytest.fixture(scope="module")
def small_runs(tmp_path_factory):
    """Each SMALL model's two steps on 1 x 2 data x spatial ranks (one
    spawn for all) and in one process, from the same weights (biases and
    norm parameters moved off their init) and batches."""
    tmp = tmp_path_factory.mktemp("spatial_small")
    runs, singles = [], {}
    for name, (cfg, side) in SMALL.items():
        model = build_model(ConfigDict, registry, Model, cfg)
        model.init(0)
        generator = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for key, p in model.module.named_parameters():
                if p.ndim == 1:
                    p.add_(0.1 * torch.randn(p.shape, generator=generator))
        state_dict = model.module.state_dict()
        batches = [_batch(seed, n=4, side=side, channels=3)
                   for seed in range(2)]
        augment = AUGMENT if name == "dropout_augmented" else None
        runs.append({"grid": (("data", "spatial"), (1, 2)),
                     "model_config": cfg, "state_dict": state_dict,
                     "optimizer": OPTIMIZER, "metrics": METRICS,
                     "clip": None, "batches": batches, "augment": augment,
                     "held": _batch(9, n=2, frag=1, side=side,
                                    channels=3)})
        singles[name] = _one_process(cfg, state_dict, batches, augment)
    torch.save({"runs": runs}, tmp / "payload.pt")
    spawn_ranks("step", 2, tmp, ["r0.pt", "r1.pt"], tmp / "payload.pt")
    ranks = [torch.load(tmp / f"r{r}.pt", weights_only=False)
             for r in range(2)]
    return {name: ([rank[i] for rank in ranks], singles[name])
            for i, name in enumerate(SMALL)}


@pytest.mark.parametrize("name", list(SMALL))
def test_two_bands_equal_one_process(small_runs, name):
    ranks, (logs, state_dict) = small_runs[name]
    for r, got in enumerate(ranks):
        for k, (row, want) in enumerate(zip(got["logs"], logs)):
            for key in ("dice_loss", "gradient_magnitude"):
                np.testing.assert_allclose(row[key], want[key],
                                           rtol=LOSS_TOL, atol=LOSS_TOL,
                                           err_msg=f"rank {r} step {k} {key}")
        for key, value in state_dict.items():
            np.testing.assert_allclose(got["state_dict"][key].numpy(),
                                       value.numpy(), rtol=RTOL, atol=ATOL,
                                       err_msg=f"rank {r} {key}")


class _Band:
    """An axis of two bands, as seen from the second, for the checks that
    run no collective."""
    name, size, index, group, ranks = "spatial", 2, 1, object(), [0, 1]


def test_a_height_the_axis_does_not_divide_is_refused():
    with pytest.raises(ValueError, match="H must divide"):
        parallel.split_rows({"x": torch.zeros(1, 2, 7, 8, 3)}, _Band(),
                            batch_dim=1)


@pytest.mark.parametrize("family", ["swin_unet", "pretraining", "resnet"])
def test_every_family_is_taken_and_a_height_the_bands_cannot_split_refused(
        family):
    """Every model family is taken at a height that S bands split; a
    height that S does not divide is refused, and for the Swin U-Net one
    that S x its patch size (4) does not divide: its bands would start
    inside a row of patches."""
    module = {
        "swin_unet": lambda: build_model(ConfigDict, registry, Model,
                                         model_config()).module,
        "pretraining": lambda: UNetEncoder(in_channel_size=3,
                                           channels=(4, 8), depth=1),
        "resnet": lambda: _port_module(SMALL["resnet_attention"][0])}[
            family]()
    spatial.check_supported(module, 64, 2)
    spatial.check_supported(module, 64, 4)
    with pytest.raises(ValueError, match="H must divide by 2"):
        spatial.check_supported(module, 63, 2)
    if family == "swin_unet":
        with pytest.raises(ValueError,
                           match="H must divide by 2 x the patch size 4"):
            spatial.check_supported(module, 36, 2)
    else:
        spatial.check_supported(module, 36, 2)


def test_cli_under_spatial_sharding_writes_the_jax_logs(tmp_path_factory,
                                                        tmp_path):
    """One epoch with ``spatial_sharding: 2`` under four ranks (data x
    spatial 2 x 2, 8 rows of 16 a rank) writes the JAX CLI's
    ``epoch_logs.csv`` of the same computation without spatial sharding.
    (The JAX CLI's own run with ``spatial_sharding: 2`` on its 4 x 2 mesh
    writes its unsharded run's training columns but other validation
    columns, val Dice 0.121 against 0.0085 on this tree: ROADMAP queue
    F.)"""
    data, jax_weights, port_weights = write_cli_tree(
        tmp_path_factory.mktemp("sp_tree"), CLI_ARCH)
    runs = {}
    for kind, weights, factor in (("jax", jax_weights, 1),
                                  ("port", port_weights, 2)):
        logs = tmp_path / f"{kind}_logs"
        path = tmp_path / f"{kind}.yaml"
        path.write_text(yaml.dump(parallel_cli_config(
            logs, weights, CLI_ARCH, epochs=1, spatial_sharding=factor)))
        if kind == "jax":
            run_jax_cli(path, data)
        else:
            spawn_cli(4, tmp_path, path, logs, data)
        runs[kind] = cli_run_dir(logs)
    assert_same_logs(runs["port"], runs["jax"], CLI_TOL)
