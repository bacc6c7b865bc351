"""Spatial sharding of the Swin U-Net and of the pretraining classifiers
(``medsegpretrainimagenet_tpu_torch.parallel.spatial``) on the CPU, against
the JAX package's ``shard_batch(..., spatial_axis="spatial")`` on its
8-device CPU mesh and against the port in one process: gloo ranks, each a
process of its own (``tests/torch_dp_worker.py``).

* The small Swin U-Net (``tests/torch_port_helpers.py``'s: 64 x 64, patch
  4, window 4, channels 8-16-32) runs its levels 0 and 1 on bands with the
  cyclic shift crossing them, and level 2 (4 x 4 tokens, one window) whole.
  Its eval forward at data x spatial 2 x 2 equals the JAX forward on the
  2 x 2 mesh within FORWARD_TOL, on the windows path and under the fused
  image mode (K2's plain version on bands of 8 x 16 and 4 x 8 tokens).
* Its train step at 1 x 2 and 1 x 4 equals the JAX one-device step in
  float32 (loss LOSS_TOL, parameters STEP_TOL, as ``test_torch_spatial``
  holds the U-Net: float32 sums in another order) and, in float64, the
  port's one process within F64_TOL, on both attention paths.  At 1 x 4
  the shift's wrap from the last band to the first is a group of its own.
* With dropout, attention dropout and stochastic depth it draws on two
  bands what one process draws at the same seed (RTOL / ATOL: float32).
* ``pretrain_model_config`` (a U-Net encoder, global average pooling and a
  Linear head) at 32 x 32: the forward at 2 x 2 equals the JAX forward on
  the 2 x 2 mesh; its cross-entropy step at 1 x 2 and 1 x 4, a
  ``DeepResNet`` classifier's (its own head's mean) and a Swin-encoder
  classifier's (token pooling ``output_size (1, C)`` after a whole
  bottom level) equal one process in float64 within F64_TOL: the head's
  and the encoder's gradients are not counted once per band.  The
  classification device augmentation (random resized crop, flip, Mixup or
  CutMix, erasing) takes the whole image before the rows are cut.
* ``spatial.roll_rows`` on 2 and 4 bands equals ``torch.roll`` of the
  whole image, forward and backward, exactly."""
import jax
import numpy as np
import pytest
import torch

from medsegpretrainimagenet_tpu import ops as jax_ops
from medsegpretrainimagenet_tpu.config import ConfigDict as JaxConfigDict
from medsegpretrainimagenet_tpu.config import registry as jax_registry
from medsegpretrainimagenet_tpu.losses import DiceLoss as JaxDiceLoss
from medsegpretrainimagenet_tpu.losses import Loss as JaxLoss
from medsegpretrainimagenet_tpu.metrics import \
    MetricsCalculator as JaxCalculator
from medsegpretrainimagenet_tpu.models import Model as JaxModel
from medsegpretrainimagenet_tpu.optim import Optimizer as JaxOptimizer
from medsegpretrainimagenet_tpu.parallel import create_mesh, replicated
from medsegpretrainimagenet_tpu.parallel import shard_batch as jax_shard
from medsegpretrainimagenet_tpu.train import TrainState as JaxTrainState
from medsegpretrainimagenet_tpu.train import \
    make_train_step as jax_train_step
from medsegpretrainimagenet_tpu_torch import losses
from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
from medsegpretrainimagenet_tpu_torch.metrics import MetricsCalculator
from medsegpretrainimagenet_tpu_torch.models import Model
from medsegpretrainimagenet_tpu_torch.ops import augment as augments
from medsegpretrainimagenet_tpu_torch.ops import set_fused_image_mode
from medsegpretrainimagenet_tpu_torch.optim import Optimizer
from medsegpretrainimagenet_tpu_torch.train import (TrainState,
                                                    make_train_step)

from test_torch_feedforward import pretrain_model_config
from torch_port_helpers import (build_model, model_config, spawn_ranks,
                                transplant)

pytestmark = pytest.mark.skipif(jax.device_count() < 8,
                                reason="needs the 8-device CPU mesh")

FORWARD_TOL, LOSS_TOL, STEP_TOL, F64_TOL = 1e-5, 1e-5, 5e-5, 1e-12
RTOL, ATOL = 1e-4, 1e-6
SIDE, CLASSES = 64, 5
OPTIMIZER = {"sgd": {"momentum": 0.9,
                     "learning_rate": {"constant": {"base": 0.05}}}}
SEGMENTATION = {"metrics": {"metrics": ("metrics.DiceIndex",),
                            "calculation": {"thresholds": 0.5,
                                            "label_type": "mask"}}}
CLASSIFICATION = {"metrics": {
    "metrics": ("metrics.multiclass_metrics.Accuracy",),
    "calculation": {"number_of_classes": CLASSES, "label_type": "label",
                    "apply_softmax": True}}}
DICE = ("DiceLoss", {"label type": "mask"})
CROSS_ENTROPY = ("CrossEntropyLoss", {"label type": "label"})


def swin_config(rate=0.0, drop=0.0, attn_drop=0.0):
    """The small Swin U-Net, with the rates of its draws."""
    cfg = model_config()
    arch = cfg["model"]["segmentation.models.UNet"]["architecture"]
    arch["stochastic depth rate"] = rate
    block = arch["basic_block"][
        "segmentation.models.blocks.SwinTransformerBlock"]
    block.update(drop=drop, attn_drop=attn_drop)
    arch["stem"]["segmentation.models.blocks.PatchEmbed"]["drop_rate"] = drop
    return cfg


def resnet_classifier_config():
    """A ``DeepResNet`` with its own head (the image's mean, a Dense)."""
    return {"model": {"classification.models.DeepResNet": {
        "version": "v1", "bottleneck": True, "channel_sizes": (8, 16),
        "widths": (1, 1), "in_channels": 3, "base_channel_size": 4,
        "head": True, "output_size": CLASSES}}}


def swin_classifier_config(img=32):
    """A Swin encoder (``tests/test_torch_robustness.py``'s, window 2: its
    levels of 8 and 4 rows run on bands, its 2 x 2 bottom whole), token
    pooling ``output_size (1, C)``, flatten and a Linear head."""
    return {"model": {"model.FeedForwardModel": {"layers": (
        {"segmentation.models.UNet_encoder": {
            "in_channel_size": 3, "channels": (8, 16, 32),
            "change_channel_in_block": False, "depth": 2, "width": 2,
            "trainable_downsampling": True,
            "basic_block": {
                "segmentation.models.blocks.SwinTransformerBlock": {
                    "img_size": img, "patch_size": 4, "embed_dim": 8,
                    "num_heads_layers": (1, 2, 4), "window_size": 2}},
            "downsampling": {"segmentation.models.blocks.PatchMerging": {}},
            "stem": {"segmentation.models.blocks.PatchEmbed": {
                "patch_size": 4}}}},
        {"torch.nn.AdaptiveAvgPool2d": {"output_size": (1, 32)}},
        "torch.nn.Flatten",
        {"torch.nn.Linear": {"in_features": 32,
                             "out_features": CLASSES}})}}}


def _segmentation_batch(seed, n=4, frag=2, side=SIDE):
    rng = np.random.default_rng(seed)
    x = rng.random((frag, n, side, side, 3)).astype(np.float32)
    return {"x": x, "mask": (x[..., 0] > 0.6).astype(np.int32)}


def _classification_batch(seed, n=4, frag=2, side=32):
    rng = np.random.default_rng(seed)
    return {"x": rng.random((frag, n, side, side, 3)).astype(np.float32),
            "label": rng.integers(0, CLASSES, (frag, n)).astype(np.int64)}


def _float64(tree):
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v
            for k, v in tree.items()}


def _weights(cfg, dtype=torch.float32, seed=0):
    """The port's initial weights of *cfg*, biases and norm parameters
    moved off their init, in *dtype*."""
    model = build_model(ConfigDict, registry, Model, cfg)
    model.init(seed)
    generator = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in model.module.parameters():
            if p.ndim == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=generator))
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in model.module.state_dict().items()}


def _run(cfg, grid, batches, held, state_dict, dtype=torch.float32,
         metrics=SEGMENTATION, loss=DICE, **extra):
    return {"grid": (("data", "spatial"), grid), "model_config": cfg,
            "state_dict": state_dict, "dtype": dtype, "optimizer": OPTIMIZER,
            "metrics": metrics, "loss": loss, "clip": None,
            "batches": batches, "held": held, **extra}


def _one_process(run):
    """The run's steps in this process: (per-step logs, state dict)."""
    model = build_model(ConfigDict, registry, Model, run["model_config"])
    model.module.to(run["dtype"])
    model.module.load_state_dict(run["state_dict"])
    optimizer = Optimizer(ConfigDict(OPTIMIZER), num_epochs=1,
                          batches_per_epoch=len(run["batches"]))
    state = TrainState.create(model.module, optimizer.init(model.module),
                              seed=1)
    name, params = run["loss"]
    loss = losses.Loss(getattr(losses, name), ConfigDict(params))
    calculator = MetricsCalculator(ConfigDict(run["metrics"]), loss=loss)
    augment = run.get("augment")
    step = make_train_step(
        model, loss, calculator, optimizer,
        device_augment=augments.make_classification_device_augment(
            **augment) if augment else None)
    set_fused_image_mode(run.get("fused_image", "off"))
    metrics_state, logs = calculator.init_state("cpu"), []
    try:
        for batch in run["batches"]:
            state, metrics_state, per_batch = step(
                state, metrics_state,
                {k: torch.from_numpy(v) for k, v in batch.items()})
            logs.append({k: float(v) for k, v in per_batch.items()})
    finally:
        set_fused_image_mode("off")
    return logs, model.module.state_dict()


def _spawn(kind, world, tmp, runs):
    torch.save({"runs": runs}, tmp / "payload.pt")
    spawn_ranks(kind, world, tmp, [f"r{r}.pt" for r in range(world)],
                tmp / "payload.pt", timeout=300)
    return [torch.load(tmp / f"r{r}.pt", weights_only=False)
            for r in range(world)]


def _assert_equal_runs(got, want, tol_logs, tol_params, what):
    """Every rank's step logs and parameters against one process's."""
    logs, state_dict = want
    for r, rank in enumerate(got):
        for k, (row, ref) in enumerate(zip(rank["logs"], logs)):
            for key, value in ref.items():
                np.testing.assert_allclose(
                    row[key], value, rtol=tol_logs, atol=tol_logs,
                    err_msg=f"{what} rank {r} step {k} {key}")
        for key, value in state_dict.items():
            if value.is_floating_point():
                np.testing.assert_allclose(
                    rank["state_dict"][key].numpy(), value.numpy(),
                    rtol=tol_params, atol=tol_params,
                    err_msg=f"{what} rank {r} {key}")


# ---------------------------------------------------------------------------
# the forward at data x spatial 2 x 2 against the JAX package's
# ---------------------------------------------------------------------------

def _jax_pair(cfg, side):
    model = build_model(JaxConfigDict, jax_registry, JaxModel, cfg)
    variables = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.key(0), {"x": np.zeros((1, side, side, 3), np.float32)}))
    port = transplant(variables, build_model(ConfigDict, registry, Model,
                                             cfg).module)
    return model, variables, port.state_dict()


def _jax_sharded_forward(model, variables, x, fused):
    """The JAX eval forward of *x* with its height over the ``'spatial'``
    axis of a 2 x 2 mesh (``shard_batch``'s ``spatial_axis``)."""
    mesh = create_mesh(("data", "spatial"), shape=(2, 2),
                       devices=jax.devices()[:4])
    xs = jax_shard({"x": x}, mesh, spatial_axis="spatial")["x"]
    vs = jax.device_put(variables, replicated(mesh))
    jax_ops.set_fused_image_mode("on" if fused else "off")
    try:
        with mesh:
            out = jax.jit(lambda v, t: model.module.apply(
                v, t, train=False))(vs, xs)
        return np.asarray(out)
    finally:
        jax_ops.set_fused_image_mode("off")


@pytest.fixture(scope="module")
def forwards(tmp_path_factory):
    """The JAX sharded forwards and the port's 2 x 2 ranks (one spawn):
    the Swin U-Net on both attention paths, the pretraining classifier."""
    tmp = tmp_path_factory.mktemp("spatial_forward")
    swin_model, swin_vars, swin_weights = _jax_pair(swin_config(), SIDE)
    pre_cfg = pretrain_model_config()
    pre_model, pre_vars, pre_weights = _jax_pair(pre_cfg, 32)
    swin_x = np.random.default_rng(0).random((2, SIDE, SIDE, 3)).astype(
        np.float32)
    pre_x = np.random.default_rng(1).random((4, 32, 32, 3)).astype(
        np.float32)
    want = {"swin off": _jax_sharded_forward(swin_model, swin_vars, swin_x,
                                             False),
            "swin on": _jax_sharded_forward(swin_model, swin_vars, swin_x,
                                            True),
            "pretrain": _jax_sharded_forward(pre_model, pre_vars, pre_x,
                                             False)}
    grid = (("data", "spatial"), (2, 2))
    runs = [{"grid": grid, "model_config": swin_config(),
             "state_dict": swin_weights, "x": swin_x, "fused_image": mode}
            for mode in ("off", "on")]
    runs.append({"grid": grid, "model_config": pre_cfg,
                 "state_dict": pre_weights, "x": pre_x})
    got = _spawn("forward", 4, tmp, runs)
    return want, {name: [rank[i] for rank in got]
                  for i, name in enumerate(want)}


@pytest.mark.parametrize("mode", ["off", "on"])
def test_swin_forward_at_2x2_equals_jax(forwards, mode):
    want, got = forwards
    for r, rank in enumerate(got[f"swin {mode}"]):
        # one sample and 32 of 64 rows a rank
        assert rank["local_shape"] == (1, SIDE // 2, SIDE, 1)
        np.testing.assert_allclose(rank["out"].numpy(), want[f"swin {mode}"],
                                   rtol=0, atol=FORWARD_TOL,
                                   err_msg=f"rank {r}")


def test_pretrain_forward_at_2x2_equals_jax(forwards):
    want, got = forwards
    for r, rank in enumerate(got["pretrain"]):
        assert rank["local_shape"] == (2, CLASSES)
        np.testing.assert_allclose(rank["out"].numpy(), want["pretrain"],
                                   rtol=0, atol=FORWARD_TOL,
                                   err_msg=f"rank {r}")


# ---------------------------------------------------------------------------
# train steps on 1 x 2 and 1 x 4 bands
# ---------------------------------------------------------------------------

def _jax_swin_step(variables, batch):
    """The JAX one-device step of the small Swin U-Net: its Dice loss and
    the parameters after it, under the port's names."""
    model = build_model(JaxConfigDict, jax_registry, JaxModel,
                        swin_config())
    optimizer = JaxOptimizer(JaxConfigDict(OPTIMIZER), num_epochs=1,
                             batches_per_epoch=1)
    state = JaxTrainState.create(
        variables, optimizer.tx.init(variables["params"]),
        jax.random.key(1))
    loss = JaxLoss(JaxDiceLoss, JaxConfigDict({"label type": "mask"}))
    calculator = JaxCalculator(JaxConfigDict(SEGMENTATION), loss=loss)
    step = jax_train_step(model, loss, calculator, optimizer, donate=False)
    state, _, per_batch = step(state, calculator.init_state(),
                               jax.device_put(batch, jax.devices()[0]))
    after = transplant(jax.tree_util.tree_map(np.asarray, {
        "params": state.params}), build_model(
            ConfigDict, registry, Model, swin_config()).module)
    return float(per_batch["dice_loss"]), after.state_dict()


def _swin_runs(grid):
    """The Swin U-Net's step runs on *grid*: float32 from the JAX weights,
    float64 on each attention path; and with the expected results."""
    model, variables, weights = _jax_pair(swin_config(), SIDE)
    batch = _segmentation_batch(0)
    held = _segmentation_batch(9, n=2, frag=1)
    wide = {k: v.double() if v.is_floating_point() else v
            for k, v in weights.items()}
    runs = [_run(swin_config(), grid, [batch], held, weights)]
    runs += [_run(swin_config(), grid, [_float64(batch)], _float64(held),
                  wide, torch.float64, fused_image=mode)
             for mode in ("off", "on")]
    return runs, (_jax_swin_step(variables, batch),)


def _classifier_runs(grid):
    """The classifiers' float64 step runs on *grid*."""
    configs = {"pretrain": (pretrain_model_config(), 32)}
    if grid == (1, 2):
        configs.update(deep_resnet=(resnet_classifier_config(), 32),
                       swin_encoder=(swin_classifier_config(), 32))
    return {name: _run(cfg, grid,
                       [_float64(_classification_batch(0, side=side))],
                       _float64(_classification_batch(9, n=2, frag=1,
                                                      side=side)),
                       _weights(cfg, torch.float64), torch.float64,
                       CLASSIFICATION, CROSS_ENTROPY)
            for name, (cfg, side) in configs.items()}


def _steps(grid, tmp_path_factory):
    """Every step run of one grid in one spawn: the Swin U-Net's, the
    classifiers' and, at 1 x 2, the draws and the augmentation."""
    tmp = tmp_path_factory.mktemp(f"spatial_steps_{grid[1]}")
    swin_runs, jax_ref = _swin_runs(grid)
    classifiers = _classifier_runs(grid)
    extra = {}
    if grid == (1, 2):
        drawing = swin_config(rate=0.2, drop=0.1, attn_drop=0.1)
        extra["draws"] = _run(
            drawing, grid, [_segmentation_batch(s) for s in range(2)],
            _segmentation_batch(9, n=2, frag=1), _weights(drawing))
        extra["augment"] = _run(
            pretrain_model_config(), grid,
            [_classification_batch(s, side=40) for s in range(2)],
            _classification_batch(9, n=2, frag=1, side=32),
            _weights(pretrain_model_config()), metrics=CLASSIFICATION,
            loss=CROSS_ENTROPY, augment_kind="classification",
            augment={"out_size": 32, "n_classes": CLASSES})
    runs = swin_runs + list(classifiers.values()) + list(extra.values())
    got = _spawn("step", grid[0] * grid[1], tmp, runs)
    ranks = [[rank[i] for rank in got] for i in range(len(runs))]
    names = ["swin f32", "swin f64 off", "swin f64 on", *classifiers,
             *extra]
    return {"jax": jax_ref[0], "runs": dict(zip(names, runs)),
            "ranks": dict(zip(names, ranks))}


@pytest.fixture(scope="module")
def two_bands(tmp_path_factory):
    return _steps((1, 2), tmp_path_factory)


@pytest.fixture(scope="module")
def four_bands(tmp_path_factory):
    return _steps((1, 4), tmp_path_factory)


@pytest.mark.parametrize("bands", ["two_bands", "four_bands"])
def test_swin_step_equals_jax_and_one_process(request, bands):
    steps = request.getfixturevalue(bands)
    (jax_loss, jax_params) = steps["jax"]
    for r, rank in enumerate(steps["ranks"]["swin f32"]):
        np.testing.assert_allclose(rank["logs"][0]["dice_loss"], jax_loss,
                                   rtol=LOSS_TOL, err_msg=f"rank {r}")
        for name, value in jax_params.items():
            np.testing.assert_allclose(
                rank["state_dict"][name].numpy(), value.numpy(),
                rtol=STEP_TOL, atol=STEP_TOL, err_msg=f"rank {r} {name}")
    for mode in ("off", "on"):
        name = f"swin f64 {mode}"
        _assert_equal_runs(steps["ranks"][name],
                           _one_process(steps["runs"][name]), F64_TOL,
                           F64_TOL, name)


@pytest.mark.parametrize("bands,name", [
    ("two_bands", "pretrain"), ("four_bands", "pretrain"),
    ("two_bands", "deep_resnet"), ("two_bands", "swin_encoder")])
def test_classifier_steps_equal_one_process_in_float64(request, bands,
                                                       name):
    steps = request.getfixturevalue(bands)
    _assert_equal_runs(steps["ranks"][name],
                       _one_process(steps["runs"][name]), F64_TOL, F64_TOL,
                       name)


def test_swin_draws_on_two_bands_equal_one_process(two_bands):
    _assert_equal_runs(two_bands["ranks"]["draws"],
                       _one_process(two_bands["runs"]["draws"]), LOSS_TOL,
                       RTOL, "draws")


def test_classification_augment_takes_the_whole_image(two_bands):
    """The step crops, flips, mixes and erases the whole 40 x 40 image,
    then cuts the 32 x 32 crop's rows: one process's steps."""
    _assert_equal_runs(two_bands["ranks"]["augment"],
                       _one_process(two_bands["runs"]["augment"]), LOSS_TOL,
                       RTOL, "augment")


# ---------------------------------------------------------------------------
# the cyclic shift across bands
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_roll_rows_equals_torch_roll(tmp_path, world):
    """``roll_rows`` by +-1 and +-3 rows of bands of 4 rows (and by the
    whole band) gathers to ``torch.roll`` of the whole image, and each
    band's gradient is its rows of the reverse roll's: exact copies."""
    rng = np.random.default_rng(world)
    x = torch.from_numpy(rng.standard_normal((2, 4 * world, 5, 3)))
    cotangent = torch.from_numpy(rng.standard_normal(tuple(x.shape)))
    shifts = [-1, 1, -3, 3, -4]
    torch.save({"x": x, "cotangent": cotangent, "shifts": shifts},
               tmp_path / "payload.pt")
    spawn_ranks("roll", world, tmp_path, [f"r{r}.pt" for r in range(world)],
                tmp_path / "payload.pt")
    for r in range(world):
        got = torch.load(tmp_path / f"r{r}.pt", weights_only=False)
        for shift in shifts:
            rolled, grad = got[shift]
            assert torch.equal(rolled, torch.roll(x, shift, dims=1)), shift
            want = torch.roll(cotangent, -shift, dims=1)[:, 4 * r:4 * r + 4]
            assert torch.equal(grad, want), (r, shift)
