"""Dataset readers: COVID-QU, ACDC (with the NIfTI codec), IDRiD and
ImageNet."""
from .acdc import ACDC  # noqa: F401
from .covidqu import COVIDQUDataset  # noqa: F401
from .idrid import IDRiD  # noqa: F401
from .imagenet import ImageNet  # noqa: F401
from .nifti import load_nii, save_nii  # noqa: F401

__all__ = ["COVIDQUDataset", "ACDC", "IDRiD", "ImageNet", "load_nii", "save_nii"]
