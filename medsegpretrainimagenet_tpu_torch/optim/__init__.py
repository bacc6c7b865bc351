"""Optimizers and learning-rate schedules of the port (``optim/``)."""
from .optimizers import OPTIMIZERS, Optimizer, build_optimizer  # noqa: F401
from .schedules import (DEFAULT_BASE_LR, ScheduleSpec,  # noqa: F401
                        build_schedule, fill_schedule_spec)

__all__ = ["Optimizer", "OPTIMIZERS", "build_optimizer", "ScheduleSpec",
           "build_schedule", "fill_schedule_spec", "DEFAULT_BASE_LR"]
