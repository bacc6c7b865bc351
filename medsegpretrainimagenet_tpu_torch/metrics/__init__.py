"""Metrics of the port (``metrics/``): the device-side suite (binary
confusion-matrix family, HD95, AUROC / AP, the multiclass family) with the
calculator that drives it, the host-side epoch loggers, and the medpy-style
surface-distance API."""
from .auc import AUCSpec  # noqa: F401
from .base import MetricSpec, snake_name, threshold_tag  # noqa: F401
from .calculator import MetricsCalculator  # noqa: F401
from .confusion import (DERIVED_CM_METRICS, ConfusionMatrixSpec,  # noqa: F401
                        DerivedCMSpec, derived_cm_value)
from .hd95 import HD95Spec  # noqa: F401
from .host_loggers import (ImageLogger, PrecisionRecallCurve,  # noqa: F401
                           ROCCurve, build_host_loggers)
from .multiclass import (AverageBinaryCMSpec,  # noqa: F401
                         AverageContinuousSpec, ClasswiseBinaryCMSpec,
                         MCAccuracySpec, MCHD95Spec, MultiClassCMSpec,
                         Top5AccuracySpec)

__all__ = ["MetricSpec", "MetricsCalculator", "ConfusionMatrixSpec",
           "DerivedCMSpec", "DERIVED_CM_METRICS", "derived_cm_value",
           "threshold_tag", "snake_name", "AUCSpec", "HD95Spec",
           "MultiClassCMSpec", "MCAccuracySpec", "Top5AccuracySpec",
           "AverageBinaryCMSpec", "ClasswiseBinaryCMSpec",
           "AverageContinuousSpec", "MCHD95Spec", "ImageLogger", "ROCCurve",
           "PrecisionRecallCurve", "build_host_loggers"]
