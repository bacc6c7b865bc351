"""Data layer: the COVID-QU, ACDC, IDRiD and ImageNet readers, the union
of several of them (``MixedDataset``), balanced sampling, the segmentation
and classification transforms, host resampling (``warp``) and loading with
device prefetch."""
from .dataset import Dataset  # noqa: F401
from .loader import BalancedDataLoader, prefetch_to_device  # noqa: F401
from .mixed import MixedDataset  # noqa: F401
from .sampling import BalancedSource, assemble_batch  # noqa: F401
from . import transforms  # noqa: F401
from . import readers  # noqa: F401

__all__ = ["Dataset", "MixedDataset", "BalancedDataLoader", "BalancedSource",
           "assemble_batch", "prefetch_to_device"]
