"""Multiclass metrics on a device-side K x K confusion matrix.

The port of ``metrics/multiclass.py`` (the reference's
``metrics/multiclass_metrics.py``): ``MultiClassCMSpec`` (pooled K x K
counts), ``MCAccuracySpec`` (mean of per-step accuracies), ``Top5AccuracySpec``
(pooled), the ``AverageBinaryCMSpec`` family (macro one-vs-rest Dice,
Jaccard, balanced accuracy over the classes present in the epoch, with
optional classwise columns and their history plot), and macro one-vs-rest
AUROC / AP and HD95.

The K x K update is one fixed-length ``scatter_add_`` over ``y * K + y_hat``
(no ``bincount``, which reads its input's extent back to the host); the
per-class AUC values come from one batched sort, the per-class HD95 from one
batched EDT over every class and sample.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .auc import auroc_rows, average_precision_rows
from .base import MetricSpec
from .confusion import derived_cm_value
from .hd95 import batch_mean_of_valid, hd95_batch

__all__ = ["MultiClassCMSpec", "MCAccuracySpec", "Top5AccuracySpec",
           "AverageBinaryCMSpec", "ClasswiseBinaryCMSpec",
           "AverageContinuousSpec", "MCHD95Spec", "binary_cm_from_multiclass"]


def _labels_from(prediction, batch, label_type) -> torch.Tensor:
    """Integer class targets from a label/mask column (argmax if one-hot)."""
    y = batch.get(label_type)
    if y is None:
        y = batch.get("label", batch.get("mask"))
    if y.shape == prediction.shape:
        y = torch.argmax(y, dim=-1)
    if y.ndim and y.shape[-1] == 1 and y.ndim == prediction.ndim:
        y = y[..., 0]
    return y.to(torch.int32)


class MultiClassCMSpec(MetricSpec):
    """Pooled K x K confusion matrix (rows = truth, cols = prediction)."""

    def __init__(self, num_classes: int, label_type: str = "label"):
        self.num_classes = num_classes
        self.label_type = label_type
        self.key = "multiclass_cm"

    def init_state(self, device):
        # per-class truth counts are the matrix's row sums: no accumulator
        k = self.num_classes
        return {"cm": torch.zeros((k, k), dtype=torch.float32,
                                  device=device)}

    def update(self, state, prediction, batch):
        k = self.num_classes
        y = _labels_from(prediction, batch, self.label_type).reshape(-1)
        y_hat = torch.argmax(prediction, dim=-1).reshape(-1)
        flat = y.long() * k + y_hat
        # a label outside [0, K) counts nowhere, as bincount(length=K*K)
        # drops it
        inside = (flat >= 0) & (flat < k * k)
        counts = torch.zeros(k * k, dtype=torch.int64, device=flat.device)
        counts.scatter_add_(0, torch.where(inside, flat, 0), inside.long())
        return {"cm": state["cm"] + counts.reshape(k, k).float()}, {}

    def finalize(self, host_state) -> Dict[str, float]:
        return {}


def binary_cm_from_multiclass(cm: np.ndarray, idx: int):
    """One-vs-rest (tp, fp, tn, fn) for class *idx* of a K x K matrix."""
    tp = cm[idx, idx]
    fn = cm[idx, :].sum() - tp
    fp = cm[:, idx].sum() - tp
    tn = cm.sum() - tp - fn - fp
    return tp, fp, tn, fn


class MCAccuracySpec(MetricSpec):
    """Mean of per-step accuracies (the reference's
    ``multiclass_metrics.Accuracy`` averages batch accuracies over the
    epoch rather than pooling), computed from the predictions."""

    def __init__(self, num_classes: int, label_type: str = "label"):
        self.num_classes = num_classes
        self.label_type = label_type
        self.key = "accuracy"
        self.name = "accuracy"

    def init_state(self, device):
        return {"sum": torch.zeros((), dtype=torch.float32, device=device),
                "count": torch.zeros((), dtype=torch.float32, device=device)}

    def update(self, state, prediction, batch):
        y = _labels_from(prediction, batch, self.label_type).reshape(-1)
        y_hat = torch.argmax(prediction, dim=-1).reshape(-1)
        value = (y == y_hat).float().mean()
        return ({"sum": state["sum"] + value, "count": state["count"] + 1},
                {self.name: value})

    def finalize(self, host_state) -> Dict[str, float]:
        count = float(host_state["count"])
        return {self.name: float(host_state["sum"]) / count if count else 0.0}


class Top5AccuracySpec(MetricSpec):
    """Pooled top-5 accuracy (the reference's ``Top5Accuracy``).  Which
    member of a tie at the n-th place ``topk`` keeps can differ from
    ``lax.top_k``'s."""

    def __init__(self, label_type: str = "label", n: int = 5):
        self.label_type = label_type
        self.n = n
        self.key = "top_5_accuracy"
        self.name = "top_5_accuracy"

    def init_state(self, device):
        return {"correct": torch.zeros((), dtype=torch.float32,
                                       device=device),
                "total": torch.zeros((), dtype=torch.float32, device=device)}

    def update(self, state, prediction, batch):
        y = _labels_from(prediction, batch, self.label_type)
        flat_pred = prediction.reshape(-1, prediction.shape[-1])
        top_n = torch.topk(flat_pred, self.n, dim=-1).indices
        correct = (top_n == y.reshape(-1)[:, None]).any(dim=-1)
        num_correct = correct.sum().float()
        total = float(correct.shape[0])
        return ({"correct": state["correct"] + num_correct,
                 "total": state["total"] + total},
                {self.name: num_correct / total})

    def finalize(self, host_state) -> Dict[str, float]:
        total = float(host_state["total"])
        return {self.name: float(host_state["correct"]) / total
                if total else 0.0}


class AverageBinaryCMSpec(MetricSpec):
    """Macro one-vs-rest CM metric over the classes present in the epoch
    (the reference's ``AverageBinaryCMMetric``), with optional classwise
    values.  With classwise logging on, the reference also asks for the
    trainer's extra last pass (``multiclass_metrics.py:189``) and exports a
    history plot of the classwise columns at the end of training
    (``:247-260``); both are kept."""

    reads = ("multiclass_cm",)

    def __init__(self, base_name: str, name: str,
                 include_background: bool = False,
                 classwise: bool = False,
                 class_names: Optional[Sequence[str]] = None,
                 eps: Optional[float] = None,
                 num_classes: Optional[int] = None,
                 plural_name: Optional[str] = None,
                 validate: bool = True):
        self.base_name = base_name    # e.g. 'dice_index'
        self.name = name              # e.g. 'mean_dice_index'
        self.start = int(not include_background)
        self.classwise = classwise
        self.class_names = list(class_names or [])
        self.eps = eps
        self.key = name
        self.num_classes = num_classes
        self.plural_name = plural_name or base_name + "s"
        self.validate = validate
        # only the classwise-logging variant forces the extra last pass
        self.requires_last_pass = bool(classwise)

    def init_state(self, device):
        return {}

    def update(self, state, prediction, batch):
        return state, {}

    def _class_label(self, idx: int, num_classes: int) -> str:
        names = list(self.class_names)
        # a leading 'background' entry is dropped when the list is longer
        # than the averaged classes (multiclass_metrics.py:176-178)
        if len(names) > num_classes - self.start:
            names = names[1:]
        offset = idx - self.start
        if 0 <= offset < len(names):
            return f"{self.base_name}_" + str(names[offset]).replace(" ", "_")
        return f"{self.base_name}_class_{idx}"

    def finalize_from(self, own_state, read_states) -> Dict[str, float]:
        cm = np.asarray(read_states["multiclass_cm"]["cm"])
        values, out = [], {}
        neutral = {"dice_index": 1, "jaccard_index": 1}.get(self.base_name, 0)
        for idx in range(self.start, cm.shape[0]):
            present = cm[idx, :].sum() + cm[:, idx].sum() > 0
            if present:
                tp, fp, tn, fn = binary_cm_from_multiclass(cm, idx)
                value = derived_cm_value(self.base_name, tp, fp, tn, fn,
                                         self.eps)
                values.append(value)
            if self.classwise:
                # an absent class still emits its (neutral) key: the CSV
                # writer pins its header to the first epoch's row
                out[self._class_label(idx, cm.shape[0])] = \
                    float(value) if present else float(neutral)
        out[self.name] = float(np.mean(values)) if values else float(neutral)
        return out

    def _legend_label(self, metric_name: str) -> str:
        # the class names with spaces (multiclass_metrics.py:252-255)
        return metric_name[len(self.base_name) + 1:].replace("_", " ")

    def evaluate_at_end(self, save_path: Optional[str] = None,
                        extensions: Sequence[str] = (), **kwargs) -> None:
        """The classwise history plot at the end of training (the
        reference's ``AverageBinaryCMMetric.evaluate_at_end``): reads the
        classwise ``val_metrics/`` columns back out of ``epoch_logs.csv``
        and exports ``plots/<plural_name>_plot``."""
        if not self.classwise or not self.validate or not save_path \
                or not self.num_classes:
            return
        import csv
        import os
        path = os.path.join(save_path, "epoch_logs.csv")
        if not os.path.isfile(path):
            return
        with open(path, newline="") as fh:
            rows = list(csv.DictReader(fh))
        if not rows:
            return
        names = [self._class_label(idx, self.num_classes)
                 for idx in range(self.start, self.num_classes)]
        cols = [(n, f"val_metrics/{n}") for n in names
                if f"val_metrics/{n}" in rows[0]]
        if not cols:
            return
        ys = [[float(r[col]) for r in rows] for _, col in cols]
        from ..plotting import GeneralPlotter, export_plot
        plotter = GeneralPlotter(dict(
            Ys=ys, xlabel="epoch", ylabel=self.base_name,
            title=f"Validation {self.plural_name}".replace("_", " "),
            legend={"labels": [self._legend_label(n) for n, _ in cols]},
            dirname=os.path.join(save_path, "plots"),
            fname=f"{self.plural_name}_plot"))
        export_plot(plotter, extensions)


class ClasswiseBinaryCMSpec(AverageBinaryCMSpec):
    """Classwise-only variant (the reference's ``ClasswiseBinaryCMMetric``:
    it exports the history plot but asks for no last pass)."""

    def __init__(self, *args, **kwargs):
        kwargs["classwise"] = True
        super().__init__(*args, **kwargs)
        self.requires_last_pass = False

    def _legend_label(self, metric_name: str) -> str:
        # the reference legends with the full metric names
        return metric_name

    def finalize_from(self, own_state, read_states) -> Dict[str, float]:
        out = super().finalize_from(own_state, read_states)
        out.pop(self.name, None)
        return out


class AverageContinuousSpec(MetricSpec):
    """Macro one-vs-rest AUROC / AP over the class probability channels
    (the reference's ``AverageBinaryContinuousMetric``): the per-batch
    value is the mean over all classes (a class with one label value adds
    its neutral 0); the epoch value is the mean over all classes of each
    class's mean of per-batch values over its valid batches.  Each class
    keeps a (sum, count) pair on the device."""

    FNS = {"area_under_roc": auroc_rows,
           "average_precision_score": average_precision_rows}

    def __init__(self, kind: str, num_classes: int,
                 include_background: bool = False, apply_softmax: bool = False,
                 label_type: str = "label"):
        self.kind = kind
        self.num_classes = num_classes
        self.start = int(not include_background)
        self.apply_softmax = apply_softmax
        self.label_type = label_type
        # the reference's names (multiclass_metrics.py:549-569)
        self.name = kind
        self.key = self.name

    def init_state(self, device):
        k = self.num_classes - self.start
        return {"sum": torch.zeros(k, dtype=torch.float32, device=device),
                "count": torch.zeros(k, dtype=torch.float32, device=device)}

    def update(self, state, prediction, batch):
        if self.apply_softmax:
            prediction = torch.softmax(prediction, dim=-1)
        y = _labels_from(prediction, batch, self.label_type)
        class_ids = torch.arange(self.start, self.num_classes,
                                 device=prediction.device)
        scores = torch.movedim(prediction[..., self.start:], -1, 0).reshape(
            self.num_classes - self.start, -1)          # (K', n)
        targets = y.reshape(-1)[None, :] == class_ids[:, None]
        values, valids = self.FNS[self.kind](scores, targets)
        valids = valids.float()
        new_state = {"sum": state["sum"] + values * valids,
                     "count": state["count"] + valids}
        return new_state, {self.name: values.mean()}

    def finalize(self, host_state) -> Dict[str, float]:
        sums = np.asarray(host_state["sum"], np.float64)
        cnts = np.asarray(host_state["count"], np.float64)
        per_class = np.where(cnts > 0, sums / np.maximum(cnts, 1), 0.0)
        return {self.name: float(np.mean(per_class)) if per_class.size
                else 0.0}


class MCHD95Spec(MetricSpec):
    """Macro one-vs-rest HD95 over the class channels (the reference's
    ``AverageBinaryDiscreteMetric`` -> ``ModifiedHausdorffDistance``).

    Predictions binarize by argmax (``multiclass_metrics.py:589``).  The
    per-batch value is the mean over the classes present in the batch
    (predicted or true anywhere in it; 0 when none is); the epoch value is
    the mean over all classes of each class's mean of its nonzero per-batch
    values (the reference's ``if value != 0`` guard), 0 for a class with
    none.  A batch's class value is the mean HD95 over the samples where
    both masks are nonempty.
    """

    def __init__(self, num_classes: int,
                 include_background: bool = False, label_type: str = "mask"):
        self.num_classes = num_classes
        self.start = int(not include_background)
        self.label_type = label_type
        self.name = "modified_hausdorff_distance"
        self.key = self.name

    def init_state(self, device):
        k = self.num_classes - self.start
        return {"sum": torch.zeros(k, dtype=torch.float32, device=device),
                "count": torch.zeros(k, dtype=torch.float32, device=device)}

    def update(self, state, prediction, batch):
        y = _labels_from(prediction, batch, self.label_type)
        y_hat = torch.argmax(prediction, dim=-1)
        class_ids = torch.arange(self.start, self.num_classes,
                                 device=prediction.device)
        shape = (-1,) + (1,) * y_hat.ndim
        pred_bin = y_hat[None] == class_ids.reshape(shape)   # (K', B, H, W)
        true_bin = y.reshape(y_hat.shape)[None] == class_ids.reshape(shape)
        k, b = pred_bin.shape[:2]
        values, valids = hd95_batch(pred_bin.reshape((k * b,)
                                                     + pred_bin.shape[2:]),
                                    true_bin.reshape((k * b,)
                                                     + true_bin.shape[2:]))
        values = batch_mean_of_valid(values.reshape(k, b),
                                     valids.reshape(k, b))
        present = (pred_bin.reshape(k, -1).any(1)
                   | true_bin.reshape(k, -1).any(1)).float()
        n_present = present.sum()
        batch_value = torch.where(
            n_present > 0,
            (values * present).sum() / torch.clamp(n_present, min=1.0), 0.0)
        new_state = {"sum": state["sum"] + values,
                     "count": state["count"] + (values != 0).float()}
        return new_state, {self.name: batch_value}

    def finalize(self, host_state) -> Dict[str, float]:
        sums = np.asarray(host_state["sum"], np.float64)
        cnts = np.asarray(host_state["count"], np.float64)
        per_class = np.where(cnts > 0, sums / np.maximum(cnts, 1), 0.0)
        return {self.name: float(np.mean(per_class)) if per_class.size
                else 0.0}
