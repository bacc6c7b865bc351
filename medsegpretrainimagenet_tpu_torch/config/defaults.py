"""Global experiment defaults.

The port's own copy of ``medsegpretrainimagenet_tpu/config/defaults.py``
(the reference's ``utils/default_dict.py``): the
table of harness-level defaults injected into every experiment config before
component construction.  Names are kept identical so the shipped reference
YAMLs resolve the same way.
"""
from __future__ import annotations

import secrets

__all__ = ["default_experiment_config", "default_model_eval"]

#: drawn ONCE per process, like the reference's module-level table
#: (``default_dict.py:6``): all experiments of a grid sweep that omit an
#: explicit seed then share one seed, so cross-experiment comparisons
#: isolate the swept hyperparameter instead of confounding it with
#: seed-to-seed variance
_PROCESS_SEED = secrets.randbelow(1_000_000)


def default_experiment_config() -> dict:
    """Fresh defaults table (the seed default is fixed per process)."""
    return {
        "model": "segmentation.models.UNet",
        "meta/technical/experiment_name": "Experiment",
        "meta/technical/save_destination": "../logs/",
        "meta/technical/seed": _PROCESS_SEED,
        "experiment/number_of_epochs": 150,
        "experiment/number_of_trials": 1,
        "training/optimizer": "sgd",
        "training/loss": "torch.nn.BCELoss",
        "metrics/metrics": ("metrics.DiceIndex",),
        "data/transforms": {
            "train": ("segmentation.transforms.wrapped_transforms.RandomRotation",
                      "segmentation.transforms.wrapped_transforms.CenterCrop"),
            "val": tuple(),
        },
        "data/data": "segmentation.datasets.ACDC",
        "meta/technical/log_to_device": True,
        "meta/technical/number_of_data_loader_workers": 0,
        "meta/technical/log_metric_and_loss_plots": False,
        "meta/technical/maximum_actual_batch_size": 24,
        "meta/technical/verbose": False,
        "meta/technical/use_cudnn_benchmarking": True,
        "meta/technical/use_deterministic_algorithms": False,
        "meta/technical/number_of_cpu_threads": 16,
        "meta/technical/export_plots_as": ("json", "html"),
        "meta/technical/log_best_model": True,
        "meta/technical/log_last_model": True,
        "meta/technical/memory_usage_limit": -1,
        "training/gradient_clipping/max_value": None,
        "training/gradient_clipping/norm": 2.0,
    }


#: watched-metric default for best-model checkpointing
default_model_eval = {"metric": "val_metrics/accuracy", "mode": "max"}
