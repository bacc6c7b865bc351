"""Loss functions and the Loss wrapper: the port of ``losses/__init__.py``.

DiceLoss (smooth 1 - DSC with a squared-prediction denominator, batchwise
or per-sample, background handling), a manual BCE, CrossEntropy with label
smoothing and a no-softmax variant, and a wrapper that selects the target
column (``label_type``), accumulates a bf16 prediction in float32 and names
the loss for logging.  Losses are plain ``(prediction, target) -> scalar``
functions of tensors; the train step runs the backward.  Layout is NHWC:
the class axis is -1.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ..config import ConfigDict, register
from ..config.registry import get_kwargs
from ..utils.naming import snake_name

__all__ = ["Loss", "DiceLoss", "BCELoss", "CrossEntropyLoss"]

_LOG_CLAMP = -100.0


def _squeeze_channel(target: torch.Tensor) -> torch.Tensor:
    """Accept (B,H,W), (B,H,W,1), (B,) or (B,1) targets uniformly."""
    if target.ndim >= 2 and target.shape[-1] == 1:
        return target[..., 0]
    return target


@register("segmentation.losses.DiceLoss", "dice_loss")
class DiceLoss:
    """Smooth 1 - DSC.

    DSC uses a squared-prediction denominator; with ``batchwise`` the score
    pools all samples, otherwise per-sample scores are averaged; classes are
    one-vs-rest over ``mask == i`` with optional background inclusion (a
    one-channel prediction p stands for the two classes 1 - p and p).
    """

    def __init__(self, batchwise: bool = True, include_background: bool = True,
                 smoothing_term: float = 1e-5, apply_softmax: bool = False,
                 *args, **kwargs):
        self.eps = smoothing_term
        self.batchwise = batchwise
        self.include_background = include_background
        self.softmax = apply_softmax
        self.name = "dice_loss"

    def _dice(self, y_hat, y, axes):
        intersection = torch.sum(y * y_hat, dim=axes)
        y_size = torch.sum(y, dim=axes)
        y_hat_size = torch.sum(y_hat ** 2, dim=axes)
        return (2 * intersection + self.eps) / (y_size + y_hat_size + self.eps)

    def __call__(self, prediction, mask, *args, **kwargs):
        if self.softmax:
            prediction = torch.softmax(prediction, dim=-1)
        mask = _squeeze_channel(mask).to(prediction.dtype)
        classes_start = int(not self.include_background)
        channels = prediction.unbind(-1)
        if len(channels) == 1:
            if self.include_background:
                channels = (1 - channels[0], channels[0])
            else:
                classes_start = 0
                mask = 1 - mask
        # spatial axes of the per-class (B, H, W) tensors (+ batch when
        # pooling batchwise)
        axes = tuple(range(0 if self.batchwise else 1, mask.ndim))
        scores = [self._dice(channels[i], (mask == i).to(prediction.dtype),
                             axes)
                  for i in range(classes_start, len(channels))]
        return 1 - torch.cat([torch.atleast_1d(s) for s in scores]).mean()


@register("classification.losses.BCELoss", "torch.nn.BCELoss", "bce_loss")
class BCELoss:
    """Manual binary cross entropy on probabilities, logs clamped at
    -100."""

    def __init__(self, reduction: str = "mean", *args, **kwargs):
        self.reduction = reduction
        self.name = "bce_loss"

    def __call__(self, prediction, label, *args, **kwargs):
        label = _squeeze_channel(label).to(prediction.dtype)
        prediction = _squeeze_channel(prediction)
        log_p = torch.clamp(torch.log(prediction), min=_LOG_CLAMP)
        log_1p = torch.clamp(torch.log1p(-prediction), min=_LOG_CLAMP)
        value = -(label * log_p + (1 - label) * log_1p)
        if self.reduction == "mean":
            return value.mean()
        if self.reduction == "sum":
            return value.sum()
        return value


@register("classification.losses.CrossEntropyLoss",
          "torch.nn.CrossEntropyLoss", "cross_entropy_loss")
class CrossEntropyLoss:
    """Cross entropy with label smoothing.

    ``apply_softmax=True``: *prediction* is logits over the last axis, the
    target integer classes (or a one-hot/smoothed distribution of the
    prediction's shape).  ``apply_softmax=False``: the prediction is already
    a distribution; its logs are clamped at -100.
    """

    def __init__(self, label_smoothing: float = 0.0,
                 apply_softmax: bool = True, *args, **kwargs):
        if label_smoothing >= 0.5:
            raise ValueError("Label smoothing value should be < 0.5")
        self.smooth = label_smoothing
        self.apply_softmax = apply_softmax
        self.name = "cross_entropy_loss"

    def _one_hot(self, label, n_classes, dtype, pred_ndim):
        label = _squeeze_channel(label)
        # a float label is "already one-hot / mixed" only when its full
        # shape matches the prediction's; checking just the last axis
        # misreads an (N,) index vector whenever N == n_classes
        if label.ndim == pred_ndim and label.shape[-1] == n_classes \
                and label.is_floating_point():
            return label.to(dtype)
        return F.one_hot(label.long(), n_classes).to(dtype)

    def __call__(self, prediction, label, *args, **kwargs):
        n_classes = prediction.shape[-1]
        onehot = self._one_hot(label, n_classes, prediction.dtype,
                               prediction.ndim)
        if self.apply_softmax:
            # torch.nn.CrossEntropyLoss smoothing: (1-s)*onehot + s/K
            target = onehot * (1 - self.smooth) + self.smooth / n_classes \
                if self.smooth else onehot
            log_pred = torch.log_softmax(prediction, dim=-1)
        else:
            # the no-softmax variant clamps the one-hot instead
            target = torch.clamp(onehot, self.smooth / n_classes,
                                 1 - self.smooth / n_classes) \
                if self.smooth else onehot
            log_pred = torch.clamp(torch.nan_to_num(
                torch.log(prediction), neginf=_LOG_CLAMP), min=_LOG_CLAMP)
        return -(log_pred * target).sum(dim=-1).mean()


def _to_f32(prediction):
    """bf16 predictions (also inside tuples) in float32: losses reduce over
    millions of pixels and accumulate in float32."""
    if isinstance(prediction, (tuple, list)):
        return type(prediction)(_to_f32(p) for p in prediction)
    if isinstance(prediction, torch.Tensor) \
            and prediction.dtype == torch.bfloat16:
        return prediction.float()
    return prediction


class Loss:
    """Wrapper selecting the target column and naming the loss.

    ``__call__(prediction, batch)`` returns the scalar loss; the train step
    runs its backward and averages the fragments' gradients.
    """

    PARAMS = {"label type": "mask"}

    def __init__(self, loss_fn: Callable, config_dict: Optional[ConfigDict]
                 = None, default_prediction_index: int = 0,
                 *args, **kwargs):
        if config_dict is None:
            config_dict = ConfigDict()
        # the output of a multi-output model when the loss config sets no
        # train_prediction_index: the global training/prediction_index
        self.default_prediction_index = int(default_prediction_index)
        loss_kwargs = get_kwargs(
            loss_fn, config_dict.mask("label_type", "train_prediction_index"))
        loss_kwargs = {k.replace(" ", "_"): v for k, v in loss_kwargs.items()}
        self.calculator = loss_fn(*args, **kwargs, **loss_kwargs)
        self.name = getattr(self.calculator, "name", snake_name(
            getattr(loss_fn, "__name__", type(self.calculator).__name__)))
        self.label_type = config_dict.get("label type",
                                          self.PARAMS["label type"])
        self.prediction_index = config_dict.get("train_prediction_index",
                                                None)
        self.PASS_ALL_INPUTS = config_dict.get(
            "pass_all_inputs", getattr(self.calculator, "PASS_ALL_INPUTS",
                                       False))

    def __call__(self, prediction, batch: Dict[str, Any]):
        if self.PASS_ALL_INPUTS or self.label_type is None:
            # an explicit ``label type: null`` routes to the pass-all-inputs
            # path, as PASS_ALL_INPUTS does
            return self.calculator(
                prediction=_to_f32(prediction),
                **{k: v for k, v in batch.items() if k != "x"})
        if isinstance(prediction, (tuple, list)):
            idx = self.prediction_index \
                if self.prediction_index is not None \
                else self.default_prediction_index
            prediction = prediction[idx]
        return self.calculator(_to_f32(prediction), batch[self.label_type])
