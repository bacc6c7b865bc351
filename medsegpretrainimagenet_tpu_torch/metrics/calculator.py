"""MetricsCalculator: config -> metric specs over a device state dict.

The port of ``metrics/calculator.py``: threshold fan-out (one confusion
matrix and its derived family per threshold), shared parent accumulators
(the CM is computed once, derived metrics read it), the loss value in the
same dict, ``metrics/`` key prefixing, and the per-step / per-epoch value
protocol:

* ``init_state(device)`` -> dict of device accumulators (the JAX dtypes)
* ``update(state, prediction, batch)`` — tensor operations only, folded
  into the train and eval steps; returns (new_state, per-step tensors)
* ``finalize_epoch(state)`` — one host sync per epoch producing the
  ``{'metrics/<name>': value, '<loss_name>': value}`` row

This slice ports the binary confusion-matrix family (accuracy, balanced
accuracy, sensitivity, specificity, precision, Dice, Jaccard, Tversky,
MCC).  AUC, HD95, the multiclass specs and the host-side loggers are
ROADMAP queue M4's rest; a config that asks for one raises
NotImplementedError.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..config import ConfigDict
from ..utils.device import resolve_device
from .base import MetricSpec, threshold_tag
from .confusion import (ConfusionMatrixSpec, DerivedCMSpec,
                        is_cm_count_name)

__all__ = ["MetricsCalculator"]

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

#: metrics of the JAX package that this port does not have yet
_NOT_PORTED = ("metrics.AUROC", "metrics.AveragePrecision",
               "metrics.ModifiedHausdorffDistance",
               "metrics.multiclass_metrics.",
               "segmentation.image_logging.ImageLogger", "metrics.ROCCurve",
               "metrics.PrecisionRecallCurve")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: this port has the binary "
        f"confusion-matrix family; AUC, HD95, the multiclass metrics and "
        f"the host loggers are ROADMAP queue M4")


class MetricsCalculator:
    """Builds and drives the metric suite described by a config."""

    METRIC_CALC_PATH = "metrics/calculation"
    METRICS_PATH = "metrics/metrics"
    PARAMS = {"thresholds": 0.5}

    @staticmethod
    def fill_kwargs(config_dict: ConfigDict):
        calc = config_dict.get_or_update(MetricsCalculator.METRIC_CALC_PATH,
                                         {"calculation": {"default": {}}})
        if not isinstance(calc, ConfigDict):
            calc = ConfigDict()
            config_dict[MetricsCalculator.METRIC_CALC_PATH] = calc
        names = config_dict.get_str_tuple(MetricsCalculator.METRICS_PATH)
        calc.get_or_update("label_type", "mask")
        if names:
            calc.get_or_update("thresholds",
                               MetricsCalculator.PARAMS["thresholds"])
        if any(name in _BINARY_DERIVED or name == "metrics.ConfusionMatrix"
               for name in names):
            calc.fill_with_defaults({"multilabel": False,
                                     "ignore_nans": True})
        return config_dict

    def __init__(self, config_dict: ConfigDict, loss=None):
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
        self.label_type = label_type
        if calc.get("log_confusion_matrix", False):
            raise _not_ported("log_confusion_matrix (the multiclass CM)")

        self.specs: Dict[str, MetricSpec] = {}

        def add(spec: MetricSpec):
            self.specs.setdefault(spec.key, spec)

        def ensure_cm(threshold: float):
            key = f"cm_{threshold_tag(threshold)}"
            if key not in self.specs:
                add(ConfusionMatrixSpec(
                    threshold=threshold, label_type=label_type,
                    multilabel=bool(calc.get("multilabel", False)),
                    ignore_nans=bool(calc.get("ignore_nans", True)),
                    num_classes=int(calc.get("number_of_classes", 1000))))

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
            elif name.startswith(_NOT_PORTED):
                raise _not_ported(name)
            else:
                import warnings
                warnings.warn(f"Unknown metric {name!r}; skipping.")

        self.loss = loss
        self.loss_name = getattr(loss, "name", "loss")

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

    @staticmethod
    def _to_host(tree: Dict[str, Any]) -> Dict[str, Any]:
        """A (nested) dict with every tensor as a numpy array of its
        dtype, in one device-to-host copy; other values pass through."""
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

    def finalize_epoch(self, state) -> Dict[str, float]:
        host = self._to_host(state)
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

    def batch_values(self, per_batch: Dict[str, Any]) -> Dict[str, float]:
        """Host view of one step's values (for batch_logs.csv), with the
        derived CM values from the step's counts; one transfer for the
        whole dict."""
        return self._batch_values_host(self._to_host(per_batch))

    def batch_values_window(self, rows) -> list:
        """:meth:`batch_values` of a window of steps, in one transfer for
        the whole window (the loop's per-window read-back)."""
        host = self._to_host({str(i): row for i, row in enumerate(rows)})
        return [self._batch_values_host(host[str(i)])
                for i in range(len(rows))]

    def _batch_values_host(self, per_batch: Dict[str, Any]
                           ) -> Dict[str, float]:
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
