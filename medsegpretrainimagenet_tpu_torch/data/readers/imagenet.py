"""ImageNet-1k reader (channels-first .npy files + labels.json).

The port's own copy of ``medsegpretrainimagenet_tpu/data/readers/imagenet.py``
(the reference's ``classification/datasets.py:10-47``): a ``labels.json``
maps npy paths to classes 1..1000 (stored 0-based); the validation split is
the official one, by a ``val`` marker in the file name, or a seeded random
split; a lazy ``load_function`` reads and scales each image at item time.

Layout: the stored npy files are channels-first uint8; the load function
moves a (1 or 3, H, W) array to channels-last and scales it to float32 in
[0, 1] as a product with the float32 ``1 / 255`` (the JAX package's native
conversion, which differs from a division in the last bit for 126 of the
256 values).  ``uint8_transfer: true`` keeps the images uint8: the train
step divides by 255 on the card.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from ...config import ConfigDict, register
from ..dataset import Dataset
from .covidqu import data_root

__all__ = ["ImageNet"]

_INV_255 = np.float32(1.0 / 255.0)


def _load_npy_image_uint8(path: str) -> np.ndarray:
    """The stored image, channels-last, in its stored dtype."""
    arr = np.load(path)
    if arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[0] < arr.shape[-1]:
        arr = np.moveaxis(arr, 0, -1)  # CHW -> HWC
    return np.ascontiguousarray(arr)


def _load_npy_image(path: str) -> np.ndarray:
    arr = _load_npy_image_uint8(path)
    if arr.dtype == np.uint8:
        return arr.astype(np.float32) * _INV_255
    return arr.astype(np.float32) / 255.0


@register("classification.datasets.ImageNet", "imagenet")
class ImageNet(Dataset):
    PARAMS = {
        "use_official_validation": {
            "argument name": "official_val", "default": True},
        "split": {"argument name": "val_split_percentage", "default": 0.2},
        "labels file": {"argument name": "labels_file",
                        "default": "labels.json"},
    }

    #: filename marker of official validation images
    VAL_MARKER = "val"

    def __init__(self, ds_dict: ConfigDict, seed: Optional[int] = None,
                 *args, **kwargs):
        root = ds_dict.get("path") or os.path.join(data_root(), "imagenet")
        labels_file = ds_dict.get("labels file", "labels.json")
        with open(os.path.join(root, labels_file)) as fh:
            labels_map = json.load(fh)
        paths = list(labels_map.keys())
        labels = np.asarray([labels_map[p] for p in paths], np.int32) - 1
        paths = [p if os.path.isabs(p) else os.path.join(root, p)
                 for p in paths]

        official = ds_dict.get(
            "use_official_validation",
            ds_dict.get("use official validation set", True))
        if official:
            is_val = np.asarray(
                [self.VAL_MARKER in os.path.basename(p) for p in paths])
        else:
            split = ds_dict.get(
                "split", ds_dict.get("val split percentage", 0.2))
            rnd = np.random.default_rng(ds_dict.get("seed") or seed)
            is_val = rnd.permutation(len(paths)) < int(split * len(paths))

        def subset(mask):
            return {"x": [p for p, m in zip(paths, mask) if m],
                    "label": labels[mask]}

        self.train = subset(~is_val)
        self.val = subset(is_val)
        #: lazy per-column loader consumed by the loader
        uint8 = ds_dict.get("uint8_transfer", False)
        self.load_function = {"x": _load_npy_image_uint8 if uint8
                              else _load_npy_image}

    def __iter__(self):
        return iter((self.train, self.val))
