"""Binary confusion matrix + derived metrics (device accumulators).

The port of ``metrics/confusion.py``: ``ConfusionMatrixSpec`` counts
TP/TN/FP/FN (per class when ``multilabel``) with NaN handling, and the
derived family (Accuracy, BalancedAccuracy, Sensitivity, Specificity,
Precision, Tversky/Dice/Jaccard, MCC) reads the shared CM with the
reference's 'invalid' -> neutral-value semantics.

The CM update is one reduction per threshold over a stack of four boolean
maps; the other counts follow from those exactly.  Derived values are
computed on the host from the counts at step or epoch boundaries, so
nothing here syncs inside the hot loop.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from .base import MetricSpec, threshold_tag

__all__ = ["ConfusionMatrixSpec", "DerivedCMSpec", "DERIVED_CM_METRICS",
           "derived_cm_value", "trim_multilabel_cm", "is_cm_count_name"]


def _as_binary_maps(prediction, target):
    """Normalise shapes: prediction (..., 1) + target broadcastable."""
    if prediction.ndim and prediction.shape[-1] == 1:
        prediction = prediction[..., 0]
    if target.ndim and target.shape[-1] == 1 \
            and target.ndim == prediction.ndim + 1:
        target = target[..., 0]
    return prediction, target.reshape(prediction.shape)


#: raw CM count column names: computed and fed to derived metrics, never
#: logged to the CSVs (the reference's aggregator drops them)
CM_COUNT_PREFIXES = ("true_positives_threshold_",
                     "false_positives_threshold_",
                     "true_negatives_threshold_",
                     "false_negatives_threshold_",
                     "class_counts_threshold_")


def is_cm_count_name(name: str) -> bool:
    return name.startswith(CM_COUNT_PREFIXES)


def trim_multilabel_cm(host_state: Dict[str, Any]) -> Dict[str, Any]:
    """Trim oversized multilabel CM buffers to the observed class count
    (the buffers are sized from ``number_of_classes``, the counts that
    matter from the prediction's channel axis, recorded in
    ``n_classes``)."""
    n = host_state.get("n_classes")
    if n is None:
        return host_state
    n = int(n)
    if n <= 0 or np.ndim(host_state["tp"]) == 0 \
            or n >= host_state["tp"].shape[-1]:
        return host_state
    return {k: (np.asarray(v)[:n]
                if k in ("tp", "fp", "tn", "fn", "class_counts") else v)
            for k, v in host_state.items()}


class ConfusionMatrixSpec(MetricSpec):
    """TP/FP/TN/FN accumulator at one threshold.

    ``multilabel`` keeps the class axis (per-class count vectors);
    ``ignore_nans`` removes NaN-target pixels from the TN count, as the
    reference does.
    """

    def __init__(self, threshold: float = 0.5, label_type: str = "mask",
                 multilabel: bool = False, ignore_nans: bool = True,
                 num_classes: int = 1):
        self.threshold = threshold
        self.label_type = label_type
        self.multilabel = multilabel
        self.ignore_nans = ignore_nans
        self.num_classes = num_classes if multilabel else 1
        self.key = f"cm_{threshold_tag(threshold)}"

    def init_state(self, device):
        shape = (self.num_classes,) if self.multilabel else ()
        state = {key: torch.zeros(shape, dtype=torch.float32, device=device)
                 for key in ("tp", "fp", "tn", "fn", "class_counts")}
        if self.multilabel:
            state["n_classes"] = torch.zeros((), dtype=torch.int32,
                                             device=device)
        return state

    def update(self, state, prediction, batch):
        target = batch[self.label_type]
        if self.multilabel:
            # keep the trailing class axis: (B, H, W, C) -> per-class counts
            dims = tuple(range(1, prediction.ndim))
        else:
            prediction, target = _as_binary_maps(prediction, target)
            dims = tuple(range(1, prediction.ndim + 1))
        target = target.float()
        pos = target == 1
        pred_pos = prediction >= self.threshold
        nans = torch.isnan(target)
        if self.multilabel:
            # a target of another shape broadcasts against the prediction
            # (e.g. one (B, H, W, 1) mask for every class), as in JAX
            pos, pred_pos = torch.broadcast_tensors(pos, pred_pos)
            nans = nans.expand(pos.shape)
        # one reduction: TP, predicted positives, positives, NaN targets;
        # FP, FN and TN follow exactly in integer arithmetic
        maps = [pos & pred_pos, pred_pos, pos]
        if self.ignore_nans:
            maps.append(nans)
        sums = torch.stack(maps).sum(dim=dims) if dims \
            else torch.stack(maps).long()
        tp, predicted, positives = sums[0], sums[1], sums[2]
        total = math.prod(pos.shape[:len(dims)] if self.multilabel
                          else prediction.shape)
        tn = total - predicted - positives + tp
        if self.ignore_nans:
            tn = tn - sums[3]
        counts = {"tp": tp, "fp": predicted - tp, "tn": tn,
                  "fn": positives - tp, "class_counts": positives}
        counts = {k: v.float() for k, v in counts.items()}
        if self.multilabel:
            observed = int(counts["tp"].shape[-1])
            buffer_size = int(state["tp"].shape[-1])
            if observed > buffer_size:
                raise ValueError(
                    f"multilabel confusion matrix buffers hold "
                    f"{buffer_size} classes but the prediction has "
                    f"{observed} channels; set "
                    f"metrics/calculation/number_of_classes >= {observed}")
            new_state = {}
            for k, v in counts.items():
                new_state[k] = state[k].clone()
                new_state[k][:observed] += v
            new_state["n_classes"] = torch.clamp(state["n_classes"],
                                                 min=observed)
        else:
            new_state = {k: state[k] + v for k, v in counts.items()}
        tag = threshold_tag(self.threshold)
        per_batch = {f"true_positives_threshold_{tag}": counts["tp"],
                     f"false_positives_threshold_{tag}": counts["fp"],
                     f"true_negatives_threshold_{tag}": counts["tn"],
                     f"false_negatives_threshold_{tag}": counts["fn"]}
        return new_state, per_batch

    def finalize(self, host_state) -> Dict[str, float]:
        host_state = trim_multilabel_cm(host_state)
        tag = threshold_tag(self.threshold)
        out = {f"true_positives_threshold_{tag}": host_state["tp"],
               f"false_positives_threshold_{tag}": host_state["fp"],
               f"true_negatives_threshold_{tag}": host_state["tn"],
               f"false_negatives_threshold_{tag}": host_state["fn"],
               f"class_counts_threshold_{tag}": host_state["class_counts"]}
        return {k: (float(v) if np.ndim(v) == 0 else np.asarray(v))
                for k, v in out.items()}


# ---------------------------------------------------------------------------
# derived metrics: pure functions of (tp, fp, tn, fn)
# ---------------------------------------------------------------------------

def _accuracy(tp, fp, tn, fn, **kw):
    total = tp + fp + tn + fn
    if total == 0:
        return "invalid"
    return (tp + tn) / total


def _balanced_accuracy(tp, fp, tn, fn, **kw):
    p, n = tp + fn, fp + tn
    if p == 0 and n == 0:
        return "invalid"
    if p == 0:
        return tn / n
    if n == 0:
        return tp / p
    return (tp / p + tn / n) / 2


def _sensitivity(tp, fp, tn, fn, **kw):
    p = tp + fn
    return "invalid" if p == 0 else tp / p


def _specificity(tp, fp, tn, fn, **kw):
    n = tn + fp
    return "invalid" if n == 0 else tn / n


def _precision(tp, fp, tn, fn, **kw):
    denom = tp + fp
    return "invalid" if denom == 0 else tp / denom


def _tversky(w_tp, w_fp, w_fn, eps):
    def fn(tp, fp, tn, fn_, **kw):
        if tp + fp + fn_ == 0:
            return "invalid"
        return (w_tp * tp + eps) / (w_tp * tp + w_fp * fp + w_fn * fn_ + eps)
    return fn


def _mcc(tp, fp, tn, fn, **kw):
    num = tp * tn - fp * fn
    denom_sq = (tp + fn) * (tp + fp) * (tn + fp) * (tn + fn)
    if denom_sq == 0:
        return "invalid"
    return num / math.sqrt(denom_sq)


#: name -> (calculator(tp,fp,tn,fn), neutral value on 'invalid')
DERIVED_CM_METRICS = {
    "accuracy": (_accuracy, 0),
    "balanced_accuracy": (_balanced_accuracy, 0),
    "sensitivity": (_sensitivity, 0),
    "specificity": (_specificity, 0),
    "precision": (_precision, 0),
    "dice_index": (_tversky(2, 1, 1, 1), 1),
    "jaccard_index": (_tversky(1, 1, 1, 1), 1),
    "mcc": (_mcc, 0),
}


def derived_cm_value(name: str, tp, fp, tn, fn, eps: Optional[float] = None,
                     weights=None):
    """``weights=(w_tp, w_fp, w_fn)`` evaluates a general Tversky index
    (reference ``metrics.py:237-259``; defaults there are (1, 1, 1))."""
    if weights is not None:
        calc, neutral = _tversky(*weights, 1 if eps is None else eps), 1
    else:
        calc, neutral = DERIVED_CM_METRICS[name]
        if eps is not None and name in ("dice_index", "jaccard_index"):
            w = (2, 1, 1) if name == "dice_index" else (1, 1, 1)
            calc = _tversky(*w, eps)
    value = calc(float(tp), float(fp), float(tn), float(fn))
    return neutral if value == "invalid" else value


class DerivedCMSpec(MetricSpec):
    """A metric derived from a shared ConfusionMatrixSpec's state."""

    def __init__(self, name: str, threshold: float = 0.5,
                 eps: Optional[float] = None, weights=None,
                 display_name: Optional[str] = None):
        self.base_name = name
        self.threshold = threshold
        self.eps = eps
        self.weights = tuple(weights) if weights is not None else None
        tag = threshold_tag(threshold)
        self.name = f"{display_name or name}_threshold_{tag}"
        self.key = self.name
        self.reads = (f"cm_{tag}",)

    def init_state(self, device):
        return {}

    def update(self, state, prediction, batch):
        return state, {}

    def finalize_from(self, own_state, read_states) -> Dict[str, float]:
        cm = trim_multilabel_cm(read_states[self.reads[0]])
        tp, fp, tn, fn = (np.asarray(cm[k]) for k in ("tp", "fp", "tn", "fn"))
        if tp.ndim == 0:
            value = derived_cm_value(self.base_name, tp, fp, tn, fn, self.eps,
                                     weights=self.weights)
            return {self.name: float(value)}
        # multilabel: macro average over classes
        values = [derived_cm_value(self.base_name, *cls, eps=self.eps,
                                   weights=self.weights)
                  for cls in zip(tp, fp, tn, fn)]
        return {self.name: float(np.mean(values))}

    def batch_value(self, counts: Dict[str, Any]) -> Dict[str, float]:
        """Per-step value from this step's CM increments (batch CSV)."""
        tag = threshold_tag(self.threshold)
        tp = float(np.sum(counts[f"true_positives_threshold_{tag}"]))
        fp = float(np.sum(counts[f"false_positives_threshold_{tag}"]))
        tn = float(np.sum(counts[f"true_negatives_threshold_{tag}"]))
        fn = float(np.sum(counts[f"false_negatives_threshold_{tag}"]))
        return {self.name: float(derived_cm_value(
            self.base_name, tp, fp, tn, fn, self.eps,
            weights=self.weights))}
