"""MetricsCalculator: config -> metric specs over a device state dict.

The port of ``metrics/calculator.py``: threshold fan-out (one confusion
matrix and its derived family per threshold), shared parent accumulators
(a confusion matrix is computed once, derived metrics read it), the loss
value in the same dict, ``metrics/`` key prefixing, and the per-step /
per-epoch value protocol:

* ``init_state(device)`` -> dict of device accumulators (the JAX dtypes)
* ``update(state, prediction, batch)`` — tensor operations only, folded
  into the train and eval steps; returns (new_state, per-step tensors)
* ``finalize_epoch(state)`` — one host sync per epoch producing the
  ``{'metrics/<name>': value, '<loss_name>': value}`` row

The whole metric suite of the JAX package is here: the binary
confusion-matrix family (accuracy, balanced accuracy, sensitivity,
specificity, precision, Dice, Jaccard, Tversky, MCC), HD95, AUROC and
average precision, and the multiclass family on a K x K confusion matrix.
The host-side epoch loggers (sample images, ROC and PR curves) are named in
the same ``metrics/metrics`` list and built by ``metrics/host_loggers.py``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ConfigDict
from ..utils.device import resolve_device
from .auc import AUCSpec
from .base import MetricSpec, threshold_tag
from .confusion import (ConfusionMatrixSpec, DerivedCMSpec,
                        is_cm_count_name)
from .hd95 import HD95Spec
from .multiclass import (AverageBinaryCMSpec, AverageContinuousSpec,
                         ClasswiseBinaryCMSpec, MCAccuracySpec, MCHD95Spec,
                         MultiClassCMSpec, Top5AccuracySpec)

__all__ = ["MetricsCalculator", "cm_log_epochs", "to_host"]


def _host_logger_names():
    from .host_loggers import HOST_LOGGER_NAMES
    return HOST_LOGGER_NAMES


def cm_log_epochs(calc_config) -> tuple:
    """(active_epochs, do_last) of the confusion-matrix export
    (``multiclass_metrics.py:64-70``): ``log_confusion_matrix_at`` defaults
    to 'last'.  The trainer's export schedule and the calculator's
    last-pass flag both read it from here."""
    if not calc_config.get("log_confusion_matrix", False):
        return [], False
    at = calc_config.get("log_confusion_matrix_at", "last")
    if isinstance(at, (str, int)):
        at = [at]
    at = list(at)
    return [int(e) for e in at if e != "last"], "last" in at


def to_host(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A (nested) dict with every tensor as a numpy array of its dtype, in
    one device-to-host copy; other values pass through."""
    tensors = []

    def collect(node):
        for value in node.values():
            if isinstance(value, dict):
                collect(value)
            elif isinstance(value, torch.Tensor):
                tensors.append(value)
    collect(tree)
    flat = torch.cat([t.detach().reshape(-1).double()
                      for t in tensors]).cpu().numpy() if tensors \
        else np.zeros(0)
    offset = 0

    def rebuild(node):
        nonlocal offset
        out = {}
        for key, value in node.items():
            if isinstance(value, dict):
                out[key] = rebuild(value)
            elif isinstance(value, torch.Tensor):
                n = value.numel()
                out[key] = flat[offset:offset + n].reshape(
                    tuple(value.shape)).astype(
                        str(value.dtype).replace("torch.", ""))
                offset += n
            else:
                out[key] = value
        return out
    return rebuild(tree)


_BINARY_DERIVED = {
    "metrics.Accuracy": "accuracy",
    "metrics.BalancedAccuracy": "balanced_accuracy",
    "metrics.Sensitivity": "sensitivity",
    "metrics.Specificity": "specificity",
    "metrics.Precision": "precision",
    "metrics.DiceIndex": "dice_index",
    "metrics.JaccardIndex": "jaccard_index",
    "metrics.MCC": "mcc",
}


class MetricsCalculator:
    """Builds and drives the metric suite described by a config."""

    METRIC_CALC_PATH = "metrics/calculation"
    METRICS_PATH = "metrics/metrics"
    PARAMS = {"thresholds": 0.5}

    #: defaults filled into metrics/calculation per requested metric
    _FILL_DEFAULTS = {
        "metrics.multiclass_metrics": {
            "number_of_classes": 1000,
            "log_confusion_matrix": False,
            "include_background_in_averages": False,
        },
        "metrics.multiclass_metrics.DiceIndex": {
            "log_classwise_dice_idcs": True},
        "metrics.multiclass_metrics.JaccardIndex": {
            "log_classwise_jaccard_idcs": False},
        "metrics.multiclass_metrics.AUROC": {"apply_softmax": False},
        "metrics.multiclass_metrics.AveragePrecision": {
            "apply_softmax": False},
        "metrics.ConfusionMatrix": {"multilabel": False, "ignore_nans": True},
    }

    @staticmethod
    def fill_kwargs(config_dict: ConfigDict):
        calc = config_dict.get_or_update(MetricsCalculator.METRIC_CALC_PATH,
                                         {"calculation": {"default": {}}})
        if not isinstance(calc, ConfigDict):
            calc = ConfigDict()
            config_dict[MetricsCalculator.METRIC_CALC_PATH] = calc
        names = config_dict.get_str_tuple(MetricsCalculator.METRICS_PATH)
        table = MetricsCalculator._FILL_DEFAULTS
        calc.get_or_update("label_type", "mask")
        if any(not name.startswith("metrics.multiclass_metrics")
               for name in names):
            calc.get_or_update("thresholds",
                               MetricsCalculator.PARAMS["thresholds"])
        for name in names:
            if name.startswith("metrics.multiclass_metrics"):
                calc.fill_with_defaults(table["metrics.multiclass_metrics"])
            for key in (name, "metrics.ConfusionMatrix"
                        if name in _BINARY_DERIVED else None):
                if key in table:
                    calc.fill_with_defaults(table[key])
        if calc.get("log_confusion_matrix", False):
            calc.get_or_update("log_confusion_matrix_at", "last")
        return config_dict

    def __init__(self, config_dict: ConfigDict, loss=None,
                 class_names: Optional[Sequence[str]] = None,
                 validate: bool = True):
        MetricsCalculator.fill_kwargs(config_dict)
        calc: ConfigDict = config_dict[self.METRIC_CALC_PATH]
        names = config_dict.get_str_tuple(self.METRICS_PATH)

        thresholds = calc.get("thresholds", 0.5)
        if isinstance(thresholds, (int, float)):
            thresholds = [thresholds]
        thresholds = list(thresholds)

        label_type = calc.get("label_type", "mask")
        if isinstance(label_type, ConfigDict):
            label_type = label_type.key()
        multilabel = bool(calc.get("multilabel", False))
        ignore_nans = bool(calc.get("ignore_nans", True))
        num_classes = int(calc.get("number_of_classes", 1000))
        include_bg = bool(calc.get("include_background_in_averages", False))
        apply_softmax = bool(calc.get("apply_softmax", False))
        self.label_type = label_type

        self.specs: Dict[str, MetricSpec] = {}

        def add(spec: MetricSpec):
            self.specs.setdefault(spec.key, spec)

        def ensure_cm(threshold: float):
            key = f"cm_{threshold_tag(threshold)}"
            if key not in self.specs:
                add(ConfusionMatrixSpec(threshold=threshold,
                                        label_type=label_type,
                                        multilabel=multilabel,
                                        ignore_nans=ignore_nans,
                                        num_classes=num_classes))

        def ensure_mc_cm():
            if "multiclass_cm" not in self.specs:
                add(MultiClassCMSpec(num_classes, label_type=label_type))

        if calc.get("log_confusion_matrix", False):
            # the CM export needs the K x K accumulator even when no
            # multiclass metric reads it
            ensure_mc_cm()

        def binary_cm(base, name, classwise=False, eps=None,
                      plural_name=None, spec=AverageBinaryCMSpec):
            ensure_mc_cm()
            add(spec(base, name, include_background=include_bg,
                     classwise=classwise, class_names=class_names, eps=eps,
                     num_classes=num_classes, plural_name=plural_name,
                     validate=validate))

        def continuous(kind):
            add(AverageContinuousSpec(kind, num_classes,
                                      include_background=include_bg,
                                      apply_softmax=apply_softmax,
                                      label_type=label_type))

        mc = "metrics.multiclass_metrics."
        # Dice/Jaccard/Tversky read eps from the calc dict
        cm_eps = float(calc.get("eps", 1))
        for name in names:
            if name in _BINARY_DERIVED:
                for t in thresholds:
                    ensure_cm(t)
                    eps = cm_eps if _BINARY_DERIVED[name] in (
                        "dice_index", "jaccard_index") else None
                    add(DerivedCMSpec(_BINARY_DERIVED[name], threshold=t,
                                      eps=eps))
            elif name == "metrics.TverskyIndex":
                # general Tversky: name + weights from the calc dict
                weights = (float(calc.get("weight_of_tps", 1)),
                           float(calc.get("weight_of_fps", 1)),
                           float(calc.get("weight_of_fns", 1)))
                tname = str(calc.get("name", "tversky_index"))
                for t in thresholds:
                    ensure_cm(t)
                    add(DerivedCMSpec("tversky_index", threshold=t,
                                      eps=cm_eps, weights=weights,
                                      display_name=tname))
            elif name == "metrics.ConfusionMatrix":
                for t in thresholds:
                    ensure_cm(t)
            elif name == "metrics.ModifiedHausdorffDistance":
                for t in thresholds:
                    add(HD95Spec(threshold=t, label_type=label_type))
            elif name == "metrics.AUROC":
                add(AUCSpec("area_under_roc", label_type=label_type))
            elif name == "metrics.AveragePrecision":
                add(AUCSpec("average_precision_score",
                            label_type=label_type))
            elif name == mc + "Accuracy":
                add(MCAccuracySpec(num_classes, label_type=label_type))
            elif name == mc + "Top5Accuracy":
                add(Top5AccuracySpec(label_type=label_type))
            elif name == mc + "DiceIndex":
                binary_cm("dice_index", "mean_dice_index", eps=1,
                          classwise=bool(calc.get("log_classwise_dice_idcs",
                                                  True)),
                          plural_name="dice_indices")
            elif name == mc + "JaccardIndex":
                binary_cm("jaccard_index", "mean_jaccard_index", eps=1,
                          classwise=bool(calc.get(
                              "log_classwise_jaccard_idcs", False)),
                          plural_name="jaccard_indices")
            elif name == mc + "BalancedAccuracy":
                binary_cm("balanced_accuracy", "mean_balanced_accuracy")
            elif name == mc + "ClasswiseAccuracies":
                binary_cm("accuracy", "classwise_accuracies",
                          plural_name="accuracies",
                          spec=ClasswiseBinaryCMSpec)
            elif name == mc + "ClasswiseBalancedAccuracies":
                binary_cm("balanced_accuracy",
                          "classwise_balanced_accuracies",
                          plural_name="balanced_accuracies",
                          spec=ClasswiseBinaryCMSpec)
            elif name == mc + "ClasswiseDiceIndices":
                # 'dice_indicies' keeps the reference's artifact name
                # verbatim (multiclass_metrics.py:410)
                binary_cm("dice_index", "classwise_dice_indices", eps=1,
                          plural_name="dice_indicies",
                          spec=ClasswiseBinaryCMSpec)
            elif name == mc + "AUROC":
                continuous("area_under_roc")
            elif name == mc + "AveragePrecision":
                continuous("average_precision_score")
            elif name == mc + "ModifiedHausdorffDistance":
                # argmax binarization: not threshold-dependent
                add(MCHD95Spec(num_classes, include_background=include_bg,
                               label_type=label_type))
            elif name in _host_logger_names():
                continue   # host-side epoch loggers, built by the trainer
            else:
                import warnings
                warnings.warn(f"Unknown metric {name!r}; skipping.")

        self.loss = loss
        self.loss_name = getattr(loss, "name", "loss")
        if "multiclass_cm" in self.specs:
            # multiclass_metrics.py:70: the last pass when the CM export
            # epochs include 'last'
            _, do_last = cm_log_epochs(calc)
            if do_last:
                self.specs["multiclass_cm"].requires_last_pass = True
        self.requires_last_pass = any(
            getattr(s, "requires_last_pass", False)
            for s in self.specs.values())

    # ------------------------------------------------------------------
    # device-side protocol
    # ------------------------------------------------------------------

    def init_state(self, device=None) -> Dict[str, Any]:
        """Zeroed accumulators on *device* (the card unless named)."""
        device = resolve_device(device)
        state = {key: spec.init_state(device)
                 for key, spec in self.specs.items()}
        state["__loss__"] = {
            "sum": torch.zeros((), dtype=torch.float32, device=device),
            "count": torch.zeros((), dtype=torch.float32, device=device)}
        return state

    def update(self, state, prediction, batch,
               loss_value=None) -> Tuple[dict, Dict[str, Any]]:
        """Fold one (virtual) batch into the state; no host sync."""
        if isinstance(prediction, torch.Tensor) \
                and prediction.dtype == torch.bfloat16:
            prediction = prediction.float()  # mixed precision
        new_state = dict(state)
        per_batch: Dict[str, Any] = {}
        for key, spec in self.specs.items():
            new_slice, values = spec.update(state[key], prediction, batch)
            new_state[key] = new_slice
            per_batch.update(values)
        if loss_value is not None:
            new_state["__loss__"] = {
                "sum": state["__loss__"]["sum"] + loss_value,
                "count": state["__loss__"]["count"] + 1.0}
            per_batch[self.loss_name] = loss_value
        return new_state, per_batch

    # ------------------------------------------------------------------
    # host-side protocol
    # ------------------------------------------------------------------

    def finalize_epoch(self, state) -> Dict[str, float]:
        host = to_host(state)
        values: Dict[str, float] = {}
        for key, spec in self.specs.items():
            out = spec.finalize_from(host[key],
                                     {r: host[r] for r in spec.reads}) \
                if spec.reads else spec.finalize(host[key])
            for name, value in out.items():
                if is_cm_count_name(name):
                    continue   # the reference's log filter
                if isinstance(value, (int, float, np.floating, np.integer)):
                    values[f"metrics/{name}"] = float(value)
        loss_state = host.get("__loss__")
        if loss_state is not None and self.loss is not None:
            count = float(loss_state["count"])
            values[self.loss_name] = float(loss_state["sum"]) / count \
                if count else 0.0
        return values

    def evaluate_at_end(self, *args, **kwargs) -> None:
        """End-of-training export hooks (``metric_wrapper.py:324-329``),
        called once after the optional last pass; each spec's hook runs in
        its own error envelope, so one failing export does not stop the
        others."""
        from ..utils.errors import swallow
        for name, spec in self.specs.items():
            hook = getattr(spec, "evaluate_at_end", None)
            if callable(hook):
                with swallow(f"Exception in the end-of-training hook "
                             f"of metric {name!r}."):
                    hook(*args, **kwargs)

    def epoch_confusion_matrix(self, state) -> Optional[np.ndarray]:
        """Host copy of the pooled K x K confusion matrix, or None (the
        trainer's export under ``log_confusion_matrix``)."""
        if "multiclass_cm" not in self.specs:
            return None
        return state["multiclass_cm"]["cm"].detach().cpu().numpy()

    def batch_values(self, per_batch: Dict[str, Any]) -> Dict[str, float]:
        """Host view of one step's values (for batch_logs.csv), with the
        derived CM values from the step's counts; one transfer for the
        whole dict."""
        return self.batch_values_host(to_host(per_batch))

    def batch_values_host(self, per_batch: Dict[str, Any]
                          ) -> Dict[str, float]:
        """:meth:`batch_values` of values already on the host."""
        # sorted, as the JAX package's pytree read-back orders the keys
        host = {k: np.asarray(per_batch[k]) for k in sorted(per_batch)}
        values = {}
        for key, value in host.items():
            if value.ndim == 0 and not is_cm_count_name(key):
                values[key] = float(value)
        for spec in self.specs.values():
            if isinstance(spec, DerivedCMSpec):
                try:
                    values.update(spec.batch_value(host))
                except KeyError:
                    pass
        unprefixed = (self.loss_name, "gradient_magnitude", "learning_rate")
        return {("" if key in unprefixed else "metrics/") + key: value
                for key, value in values.items()}
