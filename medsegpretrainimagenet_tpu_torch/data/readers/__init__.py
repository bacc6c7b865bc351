"""Dataset readers.  COVID-QU and ACDC (with the NIfTI codec) are ported;
IDRiD and ImageNet are ROADMAP queue M5's rest: a config that names one
raises NotImplementedError."""
from ...config.registry import register_not_ported
from .acdc import ACDC  # noqa: F401
from .covidqu import COVIDQUDataset  # noqa: F401
from .nifti import load_nii, save_nii  # noqa: F401

register_not_ported("segmentation.datasets.IDRiD", "idrid",
                    item="M5 (readers/idrid.py)")
register_not_ported("classification.datasets.ImageNet", "imagenet",
                    item="M5 (readers/imagenet.py)")

__all__ = ["COVIDQUDataset", "ACDC", "load_nii", "save_nii"]
