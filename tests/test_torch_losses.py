"""The port's losses against the JAX package's on the same predictions:
values and gradients with respect to the prediction, within 1e-6 (float32
on the CPU), and the Loss wrapper's target selection, naming and float32
accumulation of a bf16 prediction."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medsegpretrainimagenet_tpu import losses as jax_losses
from medsegpretrainimagenet_tpu.config import ConfigDict as JaxConfigDict
from medsegpretrainimagenet_tpu_torch import losses
from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry

TOL = 1e-6


def _probs(seed, shape, edges=False):
    p = np.random.default_rng(seed).random(shape).astype(np.float32)
    if edges:  # exact 0 and 1 reach the log clamps
        p.flat[0], p.flat[1] = 0.0, 1.0
    return p


def _labels(seed, shape, n):
    return np.random.default_rng(seed).integers(0, n, shape).astype(np.int32)


def _hold(jax_fn, port_fn, prediction, target):
    """Value and d(value)/d(prediction) of both, within TOL."""
    ref, ref_grad = jax.value_and_grad(
        lambda p: jax_fn(p, jnp.asarray(target)))(jnp.asarray(prediction))
    p = torch.from_numpy(prediction).requires_grad_()
    out = port_fn(p, torch.from_numpy(target))
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_grad),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("batchwise", [True, False])
@pytest.mark.parametrize("background", [True, False])
def test_dice_loss_binary_matches_jax(batchwise, background):
    kwargs = dict(batchwise=batchwise, include_background=background)
    _hold(jax_losses.DiceLoss(**kwargs), losses.DiceLoss(**kwargs),
          _probs(0, (3, 8, 8, 1)), _labels(1, (3, 8, 8), 2))


@pytest.mark.parametrize("background", [True, False])
def test_dice_loss_multiclass_softmax_matches_jax(background):
    kwargs = dict(include_background=background, apply_softmax=True,
                  smoothing_term=1e-3)
    logits = np.random.default_rng(2).standard_normal(
        (2, 6, 6, 3)).astype(np.float32)
    _hold(jax_losses.DiceLoss(**kwargs), losses.DiceLoss(**kwargs),
          logits, _labels(3, (2, 6, 6, 1), 3))


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_bce_loss_matches_jax(reduction):
    _hold(jax_losses.BCELoss(reduction=reduction),
          losses.BCELoss(reduction=reduction),
          _probs(4, (8, 1), edges=True), _labels(5, (8, 1), 2))


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("softmax", [True, False])
def test_cross_entropy_matches_jax(smoothing, softmax):
    kwargs = dict(label_smoothing=smoothing, apply_softmax=softmax)
    if softmax:
        prediction = np.random.default_rng(6).standard_normal(
            (6, 4)).astype(np.float32)
    else:
        prediction = _probs(6, (6, 4), edges=True)
    for target in (_labels(7, (6,), 4), _labels(7, (6, 1), 4),
                   np.eye(4, dtype=np.float32)[_labels(8, (6,), 4)]):
        _hold(jax_losses.CrossEntropyLoss(**kwargs),
              losses.CrossEntropyLoss(**kwargs), prediction, target)


def test_loss_wrapper_matches_jax_on_bf16_prediction():
    """The wrapper picks the target column and accumulates a bf16
    prediction in float32: the same value as the loss of its float32
    copy, and JAX's wrapper on the same bf16 values."""
    pred = torch.from_numpy(_probs(9, (2, 8, 8, 1))).bfloat16()
    mask = _labels(10, (2, 8, 8), 2)
    cfg = {"label type": "mask", "batchwise": False}
    port = losses.Loss(losses.DiceLoss, ConfigDict(dict(cfg)))
    ref = jax_losses.Loss(jax_losses.DiceLoss, JaxConfigDict(dict(cfg)))
    assert port.name == ref.name == "dice_loss"
    batch = {"x": torch.zeros(2), "mask": torch.from_numpy(mask)}
    value = port(pred, batch)
    assert value.dtype == torch.float32
    assert value.item() == losses.DiceLoss(batchwise=False)(
        pred.float(), batch["mask"]).item()
    want = ref(jnp.asarray(pred.float().numpy()).astype(jnp.bfloat16),
               {"mask": jnp.asarray(mask)})
    np.testing.assert_allclose(value.item(), float(want), rtol=TOL)
    # multi-output models: train_prediction_index selects the output
    indexed = losses.Loss(losses.DiceLoss, ConfigDict(
        {"train_prediction_index": 1}))
    assert indexed((torch.zeros_like(pred), pred), batch).item() == \
        losses.DiceLoss()(pred.float(), batch["mask"]).item()


def test_losses_resolve_through_the_registry():
    for name, cls in (("segmentation.losses.DiceLoss", losses.DiceLoss),
                      ("torch.nn.BCELoss", losses.BCELoss),
                      ("torch.nn.CrossEntropyLoss",
                       losses.CrossEntropyLoss)):
        assert registry.resolve(name) is cls
    cfg = ConfigDict({"loss": {"segmentation.losses.DiceLoss": {}}})
    registry.fill_spec(cfg, "loss")
    loss = registry.build(cfg, key="loss", wrapper=losses.Loss)
    assert loss.calculator.batchwise and loss.calculator.eps == 1e-5
