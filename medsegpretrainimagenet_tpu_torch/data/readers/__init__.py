"""Dataset readers.  COVID-QU is ported; ACDC, IDRiD, ImageNet and the
NIfTI helpers are ROADMAP queue M5's rest: a config that names one raises
NotImplementedError."""
from ...config.registry import register_not_ported
from .covidqu import COVIDQUDataset  # noqa: F401

register_not_ported("segmentation.datasets.ACDC", "acdc",
                    item="M5 (readers/acdc.py)")
register_not_ported("segmentation.datasets.IDRiD", "idrid",
                    item="M5 (readers/idrid.py)")
register_not_ported("classification.datasets.ImageNet", "imagenet",
                    item="M5 (readers/imagenet.py)")

__all__ = ["COVIDQUDataset"]
