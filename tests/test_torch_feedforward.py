"""The port's pretraining classifier against the JAX package's, on the CPU:
a ``model.FeedForwardModel`` of ``segmentation.models.UNet_encoder``
(depth 2, channels 4-8-16), ``AdaptiveAvgPool2d``, ``Flatten`` and
``Linear``, built from the same config by either package, the JAX weights
carried across with ``transfer.state_dict_from_jax``.  Logits agree within
TOL in eval and train mode, and so do the BatchNorm running statistics
after a train forward and one cross-entropy + AdamW step (loss, gradient
norm, every parameter but the conv biases that feed a BatchNorm, which the
BatchNorm cancels, and the logits after the step).  The head layers on
their own (average pooling with padding, adaptive pooling to uneven bins
and of a token sequence, LayerNorm) agree with JAX's as well."""
import jax
import numpy as np
import pytest
import torch

from medsegpretrainimagenet_tpu.config import ConfigDict as JaxConfigDict
from medsegpretrainimagenet_tpu.config import registry as jax_registry
from medsegpretrainimagenet_tpu.losses import CrossEntropyLoss as JaxCE
from medsegpretrainimagenet_tpu.losses import Loss as JaxLoss
from medsegpretrainimagenet_tpu.models import Model as JaxModel
from medsegpretrainimagenet_tpu.models import blocks as jax_blocks
from medsegpretrainimagenet_tpu.optim import Optimizer as JaxOptimizer
from medsegpretrainimagenet_tpu.train import TrainState as JaxTrainState
from medsegpretrainimagenet_tpu.train import \
    make_train_step as jax_train_step
from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
from medsegpretrainimagenet_tpu_torch.losses import CrossEntropyLoss, Loss
from medsegpretrainimagenet_tpu_torch.models import Model
from medsegpretrainimagenet_tpu_torch.models import blocks
from medsegpretrainimagenet_tpu_torch.models.feedforward import \
    FeedForwardModel
from medsegpretrainimagenet_tpu_torch.optim import Optimizer
from medsegpretrainimagenet_tpu_torch.train import (TrainState,
                                                    make_train_step)

from torch_port_helpers import build_model, transplant

TOL = 1e-5
SIZE, IMAGES, CLASSES = 16, 4, 5
OPTIMIZER = {"torch.optim.AdamW": {
    "learning_rate": {"optim.scheduler.LinearWarmupScheduler": {
        "base": 0.004, "warmup_length": 2,
        "main_scheduler": {"torch.optim.lr_scheduler.CosineAnnealingLR": {
            "eta_min": 1.0e-06, "T_max": "auto"}},
        "iteration_unit": "batch"}},
    "betas": (0.9, 0.999), "weight_decay": 0.05}}


def pretrain_model_config(channels=(4, 8, 16), classes=CLASSES):
    """A whole ``model`` config section of the pretraining classifier
    (``config/pretraining/unet_encoder``'s shape, cut to size): a U-Net
    encoder, adaptive average pooling, flatten and a Linear head."""
    return {"model": {"model.FeedForwardModel": {"layers": (
        {"segmentation.models.UNet_encoder": {
            "in_channel_size": 3, "channels": tuple(channels),
            "depth": len(channels) - 1}},
        {"torch.nn.AdaptiveAvgPool2d": {"output_size": 1}},
        "torch.nn.Flatten",
        {"torch.nn.Linear": {"in_features": channels[-1],
                             "out_features": classes}})}}}


@pytest.fixture(scope="module")
def pair():
    jmodel = build_model(JaxConfigDict, jax_registry, JaxModel,
                         pretrain_model_config())
    variables = jmodel.init(jax.random.key(0), {
        "x": np.zeros((1, SIZE, SIZE, 3), np.float32)})
    variables = jax.tree_util.tree_map(np.asarray, variables)
    return jmodel, variables


def _port(variables):
    model = build_model(ConfigDict, registry, Model, pretrain_model_config())
    transplant(variables, model.module)
    return model


def _images(seed=0):
    return np.random.default_rng(seed).random(
        (IMAGES, SIZE, SIZE, 3)).astype(np.float32)


def test_module_names_carry_the_layer_indices(pair):
    _, variables = pair
    model = _port(variables)
    assert isinstance(model.module, FeedForwardModel)
    names = set(model.module.state_dict())
    assert "layers.0.stem_block.Conv_0.weight" in names
    assert "layers.0.level_convs.0.0.BatchNorm_0.running_mean" in names
    # the parameterless pool and flatten keep their indices
    assert {"layers.3.Dense_0.weight", "layers.3.Dense_0.bias"} <= names
    assert set(variables["params"]) == {"layers_0", "layers_3"}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_logits_and_running_statistics_match_jax(pair, train):
    jmodel, variables = pair
    model = _port(variables)
    x = _images()
    if train:
        want, updates = jmodel.module.apply(variables, x, train=True,
                                            mutable=["batch_stats"])
    else:
        want = jmodel.module.apply(variables, x, train=False)
    model.module.train(train)
    with torch.no_grad():
        got = model.module(torch.from_numpy(x))
    assert got.shape == (IMAGES, CLASSES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    if train:
        stats = transplant({"params": variables["params"],
                            "batch_stats": updates["batch_stats"]},
                           _port(variables).module).state_dict()
        for name, value in model.module.state_dict().items():
            if "running_" in name:
                np.testing.assert_allclose(value.numpy(),
                                           stats[name].numpy(), rtol=TOL,
                                           atol=TOL, err_msg=name)


def test_cross_entropy_adamw_step_matches_jax(pair):
    jmodel, variables = pair
    x = (_images(3) * 255).astype(np.uint8)
    label = np.random.default_rng(4).integers(0, CLASSES, IMAGES).astype(
        np.int32)
    batch = {"x": x[None], "label": label[None]}

    optimizer = JaxOptimizer(JaxConfigDict(OPTIMIZER), num_epochs=1,
                             batches_per_epoch=3)
    jstate = JaxTrainState.create(
        variables, optimizer.tx.init(variables["params"]), jax.random.key(1))
    jloss = JaxLoss(JaxCE, JaxConfigDict({"label type": "label",
                                          "label_smoothing": 0.1}))
    step = jax_train_step(jmodel, jloss, None, optimizer, donate=False)
    jstate, _, jper = step(jstate, None, batch)

    model = _port(variables)
    p_opt = Optimizer(ConfigDict(OPTIMIZER), num_epochs=1,
                      batches_per_epoch=3)
    state = TrainState.create(model.module, p_opt.init(model.module), seed=1)
    loss = Loss(CrossEntropyLoss, ConfigDict({"label type": "label",
                                              "label_smoothing": 0.1}))
    pstep = make_train_step(model, loss, None, p_opt)
    state, _, per = pstep(state, None, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    for key in ("loss", "gradient_magnitude"):
        np.testing.assert_allclose(per[key].item(), float(jper[key]),
                                   rtol=TOL, atol=TOL, err_msg=key)
    assert per["learning_rate"] == pytest.approx(
        float(jper["learning_rate"]), rel=1e-6)

    want = transplant({"params": jstate.params,
                       "batch_stats": jstate.batch_stats},
                      _port(variables).module)
    compared = 0
    for name, value in model.module.state_dict().items():
        pre_bn_bias = ".Conv_" in name and name.endswith(".bias") \
            and "stem" not in name
        if pre_bn_bias or name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(value.numpy(),
                                   want.state_dict()[name].numpy(),
                                   rtol=TOL, atol=TOL, err_msg=name)
        compared += 1
    assert compared >= 20
    x_eval = torch.from_numpy(_images(5))
    model.module.eval()
    with torch.no_grad():
        np.testing.assert_allclose(model.module(x_eval).numpy(),
                                   want(x_eval).numpy(), rtol=TOL, atol=TOL)


def test_weight_init_reaches_the_head_linear():
    """``fill_weight_init_kwargs`` and ``init_weight`` reach the Linear
    inside a FeedForwardModel: its kernel is redrawn by the scheme and its
    bias filled, as JAX's are."""
    cfg = pretrain_model_config(channels=(8, 16, 32), classes=200)
    cfg["model"]["model.FeedForwardModel"]["weight_init"] = {
        "torch.nn.init.kaiming_normal_": {"nonlinearity": "relu"}}
    model = build_model(ConfigDict, registry, Model, cfg)
    model.init(0)
    before = model.module.layers[3].Dense_0.weight.detach().clone()
    model_dict = ConfigDict(cfg)["model"].value()
    Model.fill_weight_init_kwargs(model_dict)
    model.init_weight(model_dict, torch.Generator().manual_seed(1))
    weight = model.module.layers[3].Dense_0.weight.detach()
    assert not torch.equal(weight, before)
    # kaiming normal, fan in 32, gain sqrt(2): std 0.25
    assert weight.std().item() == pytest.approx((2 / 32) ** 0.5, rel=0.1)
    assert torch.count_nonzero(model.module.layers[3].Dense_0.bias) == 0


HEAD_LAYERS = [
    ("AvgPool2d", dict(kernel_size=2), (2, 8, 10, 3)),
    ("AvgPool2d", dict(kernel_size=3, stride=2, padding=1), (2, 9, 7, 3)),
    ("AdaptiveAvgPool2d", dict(output_size=1), (2, 8, 10, 3)),
    ("AdaptiveAvgPool2d", dict(output_size=(3, 4)), (2, 8, 10, 3)),
    ("AdaptiveAvgPool2d", dict(output_size=(1, 6)), (2, 12, 6)),
    ("Flatten", dict(), (2, 3, 4, 5)),
]


@pytest.mark.parametrize("name, kwargs, shape", HEAD_LAYERS)
def test_head_layers_match_jax(name, kwargs, shape):
    x = np.random.default_rng(0).random(shape).astype(np.float32)
    jlayer = getattr(jax_blocks, name)(**kwargs)
    want = jlayer.apply({}, x)
    got = getattr(blocks, name)(**kwargs)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("name, port_cls, kwargs", [
    ("Linear", "Linear", dict(in_features=6, out_features=4)),
    ("LayerNorm", "TorchLayerNorm", dict(normalized_shape=6)),
])
def test_parametric_head_layers_match_jax(name, port_cls, kwargs):
    rng = np.random.default_rng(1)
    x = rng.random((3, 5, 6)).astype(np.float32)
    jlayer = getattr(jax_blocks, name)(**kwargs)
    variables = jlayer.init(jax.random.key(0), x)
    variables = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.normal(size=v.shape).astype(np.float32)
        * 0.1, variables)
    want = jlayer.apply(variables, x)
    layer = transplant(variables, getattr(blocks, port_cls)(**kwargs))
    with torch.no_grad():
        got = layer(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
