"""Dataset readers.  COVID-QU, ACDC (with the NIfTI codec) and ImageNet
are ported; IDRiD is ROADMAP queue M5's rest: a config that names it
raises NotImplementedError."""
from ...config.registry import register_not_ported
from .acdc import ACDC  # noqa: F401
from .covidqu import COVIDQUDataset  # noqa: F401
from .imagenet import ImageNet  # noqa: F401
from .nifti import load_nii, save_nii  # noqa: F401

register_not_ported("segmentation.datasets.IDRiD", "idrid",
                    item="M5 (readers/idrid.py)")

__all__ = ["COVIDQUDataset", "ACDC", "ImageNet", "load_nii", "save_nii"]
