"""Device-side metrics of the port (``metrics/``): the binary
confusion-matrix family and the calculator that drives it."""
from .base import MetricSpec, snake_name, threshold_tag  # noqa: F401
from .calculator import MetricsCalculator  # noqa: F401
from .confusion import (DERIVED_CM_METRICS, ConfusionMatrixSpec,  # noqa: F401
                        DerivedCMSpec, derived_cm_value)

__all__ = ["MetricSpec", "MetricsCalculator", "ConfusionMatrixSpec",
           "DerivedCMSpec", "DERIVED_CM_METRICS", "derived_cm_value",
           "threshold_tag", "snake_name"]
