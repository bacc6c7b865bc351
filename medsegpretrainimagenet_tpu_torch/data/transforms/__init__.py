"""Transforms: the generic machinery and the segmentation augmentations.
The classification transforms are ROADMAP queue M5's rest: a config that
names one raises NotImplementedError."""
from ...config.registry import register_not_ported
from .core import (Compose, ConvertToType, CutMix, LambdaTransform,  # noqa
                   Mixup, RepeatChannels, TransformWrapper, build_transform)
from . import segmentation  # noqa: F401

for _name in ("OneHotEncoding", "CutMix", "MixupOrCutMix", "RandAugment"):
    register_not_ported(f"classification.transforms.{_name}",
                        item="M5 (transforms/classification.py)")
for _name in ("Resize", "CenterCrop", "RandomHorizontalFlip",
              "RandomResizedCrop", "ColorJitter", "RandomErasing"):
    register_not_ported(f"torchvision.transforms.{_name}",
                        item="M5 (transforms/classification.py)")

__all__ = ["Compose", "ConvertToType", "CutMix", "LambdaTransform", "Mixup",
           "RepeatChannels", "TransformWrapper", "build_transform"]
