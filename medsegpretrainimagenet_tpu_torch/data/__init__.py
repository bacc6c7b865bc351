"""Data layer: the COVID-QU, ACDC and ImageNet readers, balanced
sampling, the segmentation and classification transforms, host resampling
(``warp``) and loading with device prefetch.
IDRiD and ``MixedDataset`` are ROADMAP queue M5's rest."""
from ..config.registry import register_not_ported
from .dataset import Dataset  # noqa: F401
from .loader import BalancedDataLoader, prefetch_to_device  # noqa: F401
from .sampling import BalancedSource, assemble_batch  # noqa: F401
from . import transforms  # noqa: F401
from . import readers  # noqa: F401

register_not_ported("data.MixedDataset", "mixed_dataset",
                    item="M5 (data/mixed.py)")

__all__ = ["Dataset", "BalancedDataLoader", "BalancedSource",
           "assemble_batch", "prefetch_to_device"]
