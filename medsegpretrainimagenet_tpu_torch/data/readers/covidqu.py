"""COVID-QU-Ex reader (npy stacks).

The port's own copy of ``medsegpretrainimagenet_tpu/data/readers/covidqu.py``
(the reference's ``segmentation/datasets/datasets.py:22-147``): loads
``imgs.npy`` and ``masks.npy`` / ``inf_masks.npy`` stacks for the lung or
infection task, binarizes masks, scales images to [0, 1], resizes to
``image_sizes``, and splits train/val either randomly
(``val_split_percentage``) or using the official test partition
(``validate_on_test``).  Resizing is the port's numpy bilinear map
(``data/warp.py``), OpenCV's ``INTER_LINEAR`` to float rounding, bit for
bit on uint8.

Output layout is channels-last: ``x`` (N, H, W, 1) float32, ``mask``
(N, H, W) int32.  The data root defaults to the reference's relative path
and can be overridden with the ``MST_DATA_DIR`` environment variable.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ...config import ConfigDict, register
from .. import warp
from ..dataset import Dataset

__all__ = ["COVIDQUDataset"]


def data_root() -> str:
    return os.environ.get("MST_DATA_DIR", "../data")


@register("segmentation.datasets.COVIDQUDataset", "covidqu")
class COVIDQUDataset(Dataset):
    PARAMS = {
        "val split percentage": {"argument name": "val_split_percentage",
                                 "default": 0.2},
        "load masks": {"argument name": "return_masks", "default": True},
        "load distance maps": {"argument name": "return_distances",
                               "default": False},
        "lung or infection": {"argument name": "task", "default": "lung"},
        "validate on test": {"argument name": "validate_on_test",
                             "default": False},
        "image sizes": {"argument name": "image_sizes", "default": 256},
        "uint8_transfer": {"argument name": "uint8_transfer",
                           "default": False},
    }

    @staticmethod
    def _task_path(task: str) -> str:
        if task == "lung":
            return "Lung_segm/data arrays"
        if task == "inf":
            return "Inf_segm/data arrays/COVID-19"
        raise ValueError(f"Task must be 'lung' or 'inf', not {task!r}")

    @classmethod
    def _load_imgs(cls, task_path: str, partition: str) -> np.ndarray:
        return np.load(os.path.join(data_root(), "COVID_QU", task_path,
                                    partition, "imgs.npy"))

    @classmethod
    def _load_masks(cls, task_path: str, task: str,
                    partition: str) -> np.ndarray:
        name = "masks" if task == "lung" else "inf_masks"
        raw = np.load(os.path.join(data_root(), "COVID_QU", task_path,
                                   partition, f"{name}.npy"))
        return np.where(raw != 0, 1, 0).astype(np.float32)

    def __init__(self, ds_dict: ConfigDict, seed: Optional[int] = None,
                 *args, **kwargs):
        return_masks = ds_dict.get("load masks", True)
        return_distances = ds_dict.get("load distance maps", False)
        split = ds_dict.get("val split percentage", 0.2)
        task = ds_dict.get("lung or infection", "lung")
        if isinstance(task, ConfigDict):
            task = task.key()
        validate_on_test = ds_dict.get("validate on test", False)
        size = ds_dict.get("image sizes", 256)
        if isinstance(size, int):
            size = (size, size)
        task_path = self._task_path(task)

        imgs = self._load_imgs(task_path, "train and val")
        n_trainval = len(imgs)
        if validate_on_test:
            imgs = np.concatenate(
                [imgs, self._load_imgs(task_path, "test")], axis=0)
        uint8 = ds_dict.get("uint8_transfer", False)
        imgs = np.squeeze(imgs)
        if not uint8:
            imgs = imgs.astype(np.float32) / np.float32(255.0)
        # image_sizes is (width, height), OpenCV's dsize order; skip the
        # no-op resize only in the square case, where the order is moot
        hw = (size[1], size[0])
        if not (size[0] == size[1] == imgs.shape[1] == imgs.shape[2]):
            imgs = np.stack([warp.resize(img, hw) for img in imgs])
        imgs = imgs[..., None]  # (N, H, W, 1); uint8 images are /255'd
        # on device by the train/eval steps (train/step.py)

        if validate_on_test:
            train_idcs = np.concatenate(
                [np.full(n_trainval, True),
                 np.full(len(imgs) - n_trainval, False)])
        else:
            rnd = np.random.default_rng(ds_dict.get("seed") or seed)
            order = np.arange(len(imgs))
            rnd.shuffle(order)
            val_length = int(split * n_trainval)
            train_idcs = order >= val_length
        val_idcs = ~train_idcs

        train_data = {"x": imgs[train_idcs]}
        val_data = {"x": imgs[val_idcs]}

        if return_masks:
            masks = self._load_masks(task_path, task, "train and val")
            if validate_on_test:
                masks = np.concatenate(
                    [masks, self._load_masks(task_path, task, "test")],
                    axis=0)
            masks = np.squeeze(masks)
            if not (size[0] == size[1] == masks.shape[1] == masks.shape[2]):
                masks = np.stack([warp.resize(mask, hw) for mask in masks])
            masks = masks.astype(np.int32)
            train_data["mask"] = masks[train_idcs]
            val_data["mask"] = masks[val_idcs]

        if return_distances:
            if validate_on_test:
                # distances.npy only covers the train-and-val stack; the
                # reference crashes with a bare IndexError here
                # (``datasets.py:138-146``) — fail with a real message
                raise ValueError(
                    "load_distance_maps is not available together with "
                    "validate_on_test: distance maps only exist for the "
                    "'train and val' split")
            distances = np.squeeze(np.load(os.path.join(
                data_root(), "COVID_QU", task_path, "train and val",
                "distances.npy")))
            # keep geometry in sync with the resized images (the reference
            # never resizes distance maps, so mismatched image_sizes crash
            # at batch assembly); values measure pixel distances at the
            # native grid, so they rescale by the (mean) zoom factor too
            if not (size[0] == size[1] == distances.shape[1]
                    == distances.shape[2]):
                scale = (size[1] / distances.shape[1]
                         + size[0] / distances.shape[2]) / 2.0
                distances = np.stack(
                    [warp.resize(d, hw) for d in distances]) \
                    * np.float32(scale)
            train_data["distance_map"] = distances[train_idcs]
            val_data["distance_map"] = distances[val_idcs]

        self.train, self.val = train_data, val_data
