"""Command-line surface: ``python -m medsegpretrainimagenet_tpu_torch.cli
config.yaml [--continued] [--device cpu]``."""
from .experiment import main  # noqa: F401
from .run_experiment import experiment, run_exp  # noqa: F401

__all__ = ["main", "experiment", "run_exp"]
