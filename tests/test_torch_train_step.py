"""The port's train and eval steps against the JAX package's, on the CPU
in float32: a small U-Net with BatchNorm, transplanted weights, SGD with
momentum, weight decay and a poly schedule, Dice loss, the Dice/accuracy
metric family and global-norm clipping that applies, for three steps on
uint8 batches, with one fragment of 4 and with two fragments of 2.  The
loss, gradient norm, lr and metric counts of every step, and then the
parameters and BatchNorm running statistics, agree within 1e-4.  The
biases of the convolutions in front of a BatchNorm are held only through
the outputs: their gradient is zero up to rounding, so they walk apart
between backends without changing anything."""
import jax
import numpy as np
import pytest
import torch

from medsegpretrainimagenet_tpu.config import ConfigDict as JaxConfigDict
from medsegpretrainimagenet_tpu.config import registry as jax_registry
from medsegpretrainimagenet_tpu.losses import DiceLoss as JaxDiceLoss
from medsegpretrainimagenet_tpu.losses import Loss as JaxLoss
from medsegpretrainimagenet_tpu.metrics import \
    MetricsCalculator as JaxCalculator
from medsegpretrainimagenet_tpu.models import Model as JaxModel
from medsegpretrainimagenet_tpu.optim import Optimizer as JaxOptimizer
from medsegpretrainimagenet_tpu.train import TrainState as JaxTrainState
from medsegpretrainimagenet_tpu.train import make_eval_step as jax_eval_step
from medsegpretrainimagenet_tpu.train import \
    make_train_step as jax_train_step
from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
from medsegpretrainimagenet_tpu_torch.losses import DiceLoss, Loss
from medsegpretrainimagenet_tpu_torch.metrics import MetricsCalculator
from medsegpretrainimagenet_tpu_torch.models import Model
from medsegpretrainimagenet_tpu_torch.optim import Optimizer
from medsegpretrainimagenet_tpu_torch.train import (TrainState,
                                                    make_eval_step,
                                                    make_train_step)

from torch_port_helpers import build_model, transplant, unet_config

TOL = 1e-4
STEPS, IMAGES, SIZE = 3, 4, 16
CLIP = 0.05
OPTIMIZER = {"sgd": {"momentum": 0.9, "weight decay": 1e-4,
                     "learning_rate": {
                         "optim.scheduler.PolyLearningRateDecay": {
                             "base": 0.05, "exponent": 0.9,
                             "iteration_unit": "batch",
                             "number_of_iterations": "auto"}}}}
METRICS = {"metrics": {"metrics": ("metrics.DiceIndex", "metrics.Accuracy"),
                       "calculation": {"thresholds": 0.5}}}


def _batches(seed=0, n=STEPS):
    """uint8 images with a bright square and its mask, (IMAGES, SIZE,
    SIZE, ...) per step."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = (rng.random((IMAGES, SIZE, SIZE, 3)) * 90).astype(np.uint8)
        mask = np.zeros((IMAGES, SIZE, SIZE), np.uint8)
        for i in range(IMAGES):
            r, c = rng.integers(2, SIZE - 8, 2)
            x[i, r:r + 6, c:c + 6] += 150
            mask[i, r:r + 6, c:c + 6] = 1
        out.append({"x": x, "mask": mask})
    return out


def _stack(batch, n_frag):
    return {k: v.reshape((n_frag, -1) + v.shape[1:])
            for k, v in batch.items()}


def _port(variables, model_cfg=None, seed=1, freeze=None):
    model = build_model(ConfigDict, registry, Model,
                        model_cfg or unet_config())
    transplant(variables, model.module)
    mask = None
    if freeze is not None:
        model.freeze_and_unfreeze(ConfigDict(freeze))
        mask = model.trainable_mask()
    optimizer = Optimizer(ConfigDict(OPTIMIZER), num_epochs=1,
                          batches_per_epoch=STEPS, trainable_mask=mask)
    state = TrainState.create(model.module, optimizer.init(model.module),
                              seed=seed)
    loss = Loss(DiceLoss, ConfigDict({"label type": "mask"}))
    calculator = MetricsCalculator(ConfigDict(METRICS), loss=loss)
    return model, optimizer, state, loss, calculator


@pytest.fixture(scope="module")
def jax_model():
    model = build_model(JaxConfigDict, jax_registry, JaxModel, unet_config())
    variables = model.init(jax.random.key(0),
                           {"x": np.zeros((1, SIZE, SIZE, 3), np.float32)})
    return model, variables


def _jax_run(model, variables, n_frag, batches, freeze=None):
    mask = None
    if freeze is not None:
        model = build_model(JaxConfigDict, jax_registry, JaxModel,
                            unet_config())
        model.freeze_and_unfreeze(JaxConfigDict(freeze))
        mask = model.trainable_mask(variables["params"])
    optimizer = JaxOptimizer(JaxConfigDict(OPTIMIZER), num_epochs=1,
                             batches_per_epoch=STEPS, trainable_mask=mask)
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
        logs.append(jax.device_get(per_batch))
    return state, calculator.finalize_epoch(metrics_state), logs, \
        (loss, calculator)


def _port_run(variables, n_frag, batches, freeze=None):
    model, optimizer, state, loss, calculator = _port(variables,
                                                      freeze=freeze)
    step = make_train_step(model, loss, calculator, optimizer,
                           grad_clip_value=CLIP)
    metrics_state, logs = calculator.init_state("cpu"), []
    for batch in batches:
        state, metrics_state, per_batch = step(
            state, metrics_state,
            {k: torch.from_numpy(v) for k, v in _stack(batch,
                                                       n_frag).items()})
        logs.append(per_batch)
    return model, state, calculator.finalize_epoch(metrics_state), logs, \
        (loss, calculator)


def _pre_bn_bias(name: str) -> bool:
    return ".Conv_" in name and name.endswith(".bias") \
        and "upsamples" not in name and "final" not in name \
        and "stem" not in name


@pytest.mark.parametrize("n_frag", [1, 2], ids=["whole", "two_fragments"])
def test_three_steps_match_jax(jax_model, n_frag):
    jmodel, variables = jax_model
    batches = _batches()
    jstate, jvalues, jlogs, (jloss, jcalc) = _jax_run(jmodel, variables,
                                                      n_frag, batches)
    model, state, values, logs, (loss, calc) = _port_run(variables, n_frag,
                                                         batches)
    assert state.step == STEPS and state.micro_step == STEPS
    for k, (got, want) in enumerate(zip(logs, jlogs)):
        assert got["learning_rate"] == pytest.approx(
            float(want["learning_rate"]), rel=1e-6)
        assert isinstance(got["dice_loss"], torch.Tensor)
        for key in ("dice_loss", "gradient_magnitude",
                    "true_positives_threshold_0.5",
                    "false_positives_threshold_0.5"):
            np.testing.assert_allclose(got[key].item(), float(want[key]),
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"step {k} {key}")
        # the clip applied: the logged norm is the one before clipping
        assert got["gradient_magnitude"].item() > CLIP
    for key in jvalues:
        np.testing.assert_allclose(values[key], jvalues[key], rtol=TOL,
                                   atol=TOL, err_msg=key)

    want = transplant({"params": jstate.params,
                       "batch_stats": jstate.batch_stats},
                      build_model(ConfigDict, registry, Model,
                                  unet_config()).module).state_dict()
    got = model.module.state_dict()
    compared = 0
    for name, value in got.items():
        if _pre_bn_bias(name) or name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                   rtol=TOL, atol=TOL, err_msg=name)
        compared += 1
    assert compared > 40
    assert got["enc.level_convs.0.0.BatchNorm_0.num_batches_tracked"] \
        == STEPS * n_frag

    # eval on held-out data: running statistics, loss and metrics
    held = _stack(_batches(seed=5, n=1)[0], 2)
    jeval = jax_eval_step(jmodel, jloss, jcalc, donate=False)
    jm, jb = jeval(jstate, jcalc.init_state(), held)
    peval = make_eval_step(model, loss, calc)
    pm, pb = peval(state, calc.init_state("cpu"),
                   {k: torch.from_numpy(v) for k, v in held.items()})
    np.testing.assert_allclose(pb["dice_loss"].item(),
                               float(jb["dice_loss"]), rtol=TOL, atol=TOL)
    jv, pv = jcalc.finalize_epoch(jm), calc.finalize_epoch(pm)
    for key in jv:
        np.testing.assert_allclose(pv[key], jv[key], rtol=TOL, atol=TOL,
                                   err_msg=key)


@pytest.mark.parametrize("n_frag", [1, 2], ids=["whole", "two_fragments"])
def test_frozen_encoder_three_steps_match_jax(jax_model, n_frag):
    """``freeze_weights: encoder`` with clipping on: the frozen parameters
    stay as loaded, while their fresh gradients of each step (and only
    those) still count in the logged norm and the clip factor, as in the
    JAX step, where the freeze lives in the optimizer's transform."""
    jmodel, variables = jax_model
    freeze = {"weight_init": {"freeze_weights": "encoder"}}
    batches = _batches(seed=2)
    jstate, _, jlogs, _ = _jax_run(jmodel, variables, n_frag, batches,
                                   freeze=freeze)
    model, state, _, logs, _ = _port_run(variables, n_frag, batches,
                                         freeze=freeze)
    for k, (got, want) in enumerate(zip(logs, jlogs)):
        for key in ("dice_loss", "gradient_magnitude"):
            np.testing.assert_allclose(got[key].item(), float(want[key]),
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"step {k} {key}")
        assert got["gradient_magnitude"].item() > CLIP

    want = transplant({"params": jstate.params,
                       "batch_stats": jstate.batch_stats},
                      build_model(ConfigDict, registry, Model,
                                  unet_config()).module).state_dict()
    start = transplant(variables, build_model(
        ConfigDict, registry, Model, unet_config()).module).state_dict()
    frozen = 0
    for name, value in model.module.named_parameters():
        if name.startswith("enc."):
            assert torch.equal(value.detach(), start[name]), name
            frozen += 1
        elif not _pre_bn_bias(name):
            np.testing.assert_allclose(value.detach().numpy(),
                                       want[name].numpy(), rtol=TOL,
                                       atol=TOL, err_msg=name)
    assert frozen > 10


def test_accumulation_equals_the_single_batch_step(jax_model):
    """Two fragments of the same two images against one batch of all four
    copies: the same batch statistics in every BatchNorm, so the mean of
    the fragments' gradients is the batch's gradient (the running
    statistics differ: they chain twice)."""
    _, variables = jax_model
    half = {k: v[:2] for k, v in _batches(n=1)[0].items()}
    stacks = [{k: np.stack([v, v]) for k, v in half.items()},
              {k: np.concatenate([v, v])[None] for k, v in half.items()}]
    runs = []
    for stack in stacks:
        model, optimizer, state, loss, calculator = _port(variables)
        step = make_train_step(model, loss, calculator, optimizer,
                               grad_clip_value=CLIP)
        _, _, per_batch = step(state, calculator.init_state("cpu"),
                               {k: torch.from_numpy(v)
                                for k, v in stack.items()})
        runs.append((per_batch, dict(model.module.named_parameters())))
    (acc, acc_params), (whole, whole_params) = runs
    for key in ("dice_loss", "gradient_magnitude"):
        np.testing.assert_allclose(acc[key].item(), whole[key].item(),
                                   rtol=1e-6, err_msg=key)
    for name, param in acc_params.items():
        np.testing.assert_allclose(param.detach().numpy(),
                                   whole_params[name].detach().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_step_random_stream_is_seeded(jax_model):
    """Dropout and a device augmentation draw from a generator derived
    from (seed, micro_step, fragment): the same seed repeats a step, another
    seed does not, and the metrics see the augmented fragment."""
    _, variables = jax_model
    cfg = unet_config(basic_block={"segmentation.models.blocks.ConvBlock": {
        "dropout": {"rate": 0.5}}})
    seen = []

    def augment(generator, fragment):
        seen.append(generator)
        flip = torch.rand((), generator=generator) < 2  # always, but drawn
        x = torch.where(flip, fragment["x"].flip(2), fragment["x"])
        return dict(fragment, x=x, mask=torch.ones_like(fragment["mask"]))

    stack = {k: torch.from_numpy(v)
             for k, v in _stack(_batches(n=1)[0], 2).items()}
    results = []
    for seed in (3, 3, 4):
        model, optimizer, state, loss, calculator = _port(variables, cfg,
                                                          seed=seed)
        step = make_train_step(model, loss, calculator, optimizer,
                               device_augment=augment)
        _, metrics_state, _ = step(state, calculator.init_state("cpu"),
                                   stack)
        results.append(model.module.state_dict()[
            "dec.final.Conv_0.weight"].clone())
        counts = calculator.finalize_epoch(metrics_state)
        assert counts["metrics/accuracy_threshold_0.5"] == pytest.approx(
            metrics_state["cm_0.5"]["tp"].item() / (IMAGES * SIZE * SIZE))
    assert len(seen) == 6 and all(isinstance(g, torch.Generator)
                                  for g in seen)
    assert torch.equal(results[0], results[1])
    assert not torch.equal(results[0], results[2])


def test_parameter_without_gradient_follows_the_jax_rule(jax_model):
    """A trainable parameter the loss does not reach: optax applies momentum
    and weight decay to its zero gradient, and so does the port's step
    (torch.optim alone would skip it).  Three steps, against the JAX
    optimizer's transform on zero gradients."""
    _, variables = jax_model
    opt_cfg = {"sgd": {"momentum": 0.9, "weight decay": 0.1,
                       "learning_rate": {"constant": {"base": 0.05}}}}
    model = build_model(ConfigDict, registry, Model, unet_config())
    transplant(variables, model.module)
    model.module.register_parameter(
        "unused", torch.nn.Parameter(torch.ones(3)))
    optimizer = Optimizer(ConfigDict(opt_cfg), num_epochs=1,
                          batches_per_epoch=STEPS)
    state = TrainState.create(model.module, optimizer.init(model.module), 1)
    loss = Loss(DiceLoss, ConfigDict({"label type": "mask"}))
    step = make_train_step(model, loss, None, optimizer)
    for batch in _batches():
        state, _, _ = step(state, None, {k: torch.from_numpy(v)[None]
                                         for k, v in batch.items()})

    jopt = JaxOptimizer(JaxConfigDict(opt_cfg), num_epochs=1,
                        batches_per_epoch=STEPS)
    params = {"unused": np.ones(3, np.float32)}
    opt_state = jopt.tx.init(params)
    for _ in range(STEPS):
        updates, opt_state = jopt.tx.update(
            {"unused": np.zeros(3, np.float32)}, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    np.testing.assert_allclose(model.module.unused.detach().numpy(),
                               np.asarray(params["unused"]), rtol=1e-6,
                               atol=1e-7)
    assert float(model.module.unused.detach()[0]) < 0.99
