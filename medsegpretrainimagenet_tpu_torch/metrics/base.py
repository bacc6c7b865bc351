"""Metric protocol: device-side accumulator state + host finalisation.

The port of ``metrics/base.py``.  Every metric is a **spec** owning a slice
of a state dict of device tensors; ``update`` folds one batch into it with
tensor operations only (no host sync per batch), and ``finalize`` runs on
host numpy once per epoch.

State dtypes are the JAX package's: counters are float32.  Epoch pixel
counts reach ~1e9, where the float32 step is ~64, a relative error of
~3e-5, far below the 0.005 Dice spread the reference publishes across
seeds.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from ..utils.naming import snake_name

__all__ = ["MetricSpec", "threshold_tag", "snake_name"]


def threshold_tag(threshold: float) -> str:
    """Format a threshold exactly like the reference string-formats it."""
    return str(threshold)


class MetricSpec:
    """One metric (or a shared parent accumulator like a confusion matrix).

    Subclasses define:

    * ``key``: unique state key in the calculator's state dict
    * ``init_state(device) -> dict`` of device tensors
    * ``update(state, prediction, batch) -> (state, per_batch: dict)`` —
      tensor operations only; ``per_batch`` values are device tensors
      logged per optimizer step
    * ``finalize(host_state) -> dict[str, float]`` — host-side epoch values
    """

    key: str = "metric"
    #: the trainer's extra no-grad pass over train and val after training
    requires_last_pass: bool = False
    #: optional end-of-training export hook (save_path, extensions)
    evaluate_at_end: Optional[Callable] = None

    def init_state(self, device):
        raise NotImplementedError

    def update(self, state, prediction, batch: Dict[str, Any]):
        raise NotImplementedError

    def finalize(self, host_state) -> Dict[str, float]:
        raise NotImplementedError

    # metrics that only *read* another spec's state (CM-derived family)
    reads: Tuple[str, ...] = ()

    def finalize_from(self, own_state,
                      read_states: Dict[str, Any]) -> Dict[str, float]:
        """Finalize with access to the states this spec ``reads``."""
        return self.finalize(own_state)
