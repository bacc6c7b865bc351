"""Transforms: the generic machinery, the segmentation augmentations and
the classification augmentations (with the ``torchvision.transforms``
names of the pretraining configs)."""
from .core import (Compose, ConvertToType, CutMix, LambdaTransform,  # noqa
                   Mixup, RepeatChannels, TransformWrapper, build_transform)
from . import classification  # noqa: F401
from . import segmentation  # noqa: F401

__all__ = ["Compose", "ConvertToType", "CutMix", "LambdaTransform", "Mixup",
           "RepeatChannels", "TransformWrapper", "build_transform"]
