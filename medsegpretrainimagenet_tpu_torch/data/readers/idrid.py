"""IDRiD retinal lesion reader (fundus jpgs + per-class .tif masks).

The port of ``data/readers/idrid.py``: 2848 x 4288 fundus images with up
to five lesion-mask classes; a 96-px border crop left and right, ``/255``
to float64, a resize to ``base_image_sizes``; the train / test split from
the file names, ``train_set_size`` subsampling, multilabel (0/1 per class)
or argmax single-label masks, and sliding-window crops (train at
``train_crop_stride``, val at the crop size) with a darkness filter that
drops crops whose mean is under ``1 - darkness_threshold``.

Images are decoded with PIL and resized with :func:`warp.resize`, numpy
versions of OpenCV's linear resize: the float64 image by its double
arithmetic, the uint8 masks by its 11-bit fixed point, so the values are
the JAX package's.  The splits draw from ``np.random.default_rng(seed)``
in the JAX package's order, so they are its splits.

Output layout is channels-last: ``x`` (N, H, W, 3) float32; ``mask``
(N, H, W) int for single-label, (N, H, W, K) 0/1 for multilabel.
"""
from __future__ import annotations

import glob
import itertools
import os
import re
from typing import Optional

import numpy as np
from PIL import Image

from ...config import ConfigDict, register
from .. import warp
from ..dataset import Dataset
from .covidqu import data_root

__all__ = ["IDRiD"]


def _pair(value) -> tuple:
    """An int, or a 1- or 2-sequence, as a pair."""
    value = (value,) if isinstance(value, int) else tuple(value)
    return value * 2 if len(value) == 1 else value


@register("segmentation.datasets.IDRiD", "idrid")
class IDRiD(Dataset):
    CLASSES_DICT = {"MA": "microaneurysms",
                    "HE": "haemorrhages",
                    "EX": "hard exudates",
                    "SE": "soft exudates",
                    "OD": "optic disc"}

    PARAMS = {
        "base_image_sizes": (1024, 2048),
        "cropped_image_sizes": (512, 512),
        "train_crop_stride": (256, 256),
        "darkness_threshold": 0.99,
        "task": "MA",
        "validation_set": "test",
        "train_set_size": 54,
    }

    DEFAULT_VAL_SIZE = 27
    LEFT_CROP, RIGHT_CROP = 96, 96

    @staticmethod
    def fill_kwargs(config_dict: ConfigDict):
        val_set = config_dict.get("validation_set")
        if isinstance(val_set, ConfigDict):
            val_set = val_set.key()
        if val_set == "random":
            config_dict.get_or_update("validation_set_size",
                                      IDRiD.DEFAULT_VAL_SIZE)
        task = config_dict.get("task")
        tasks = (task,) if isinstance(task, str) else tuple(task or ("MA",))
        if isinstance(task, ConfigDict):
            tasks = (task.key(),)
        if len(tasks) == 1:
            config_dict.get_or_update("include_negatives", False)
        else:
            config_dict.get_or_update("multilabel", False)

    @classmethod
    def _paths(cls):
        base = os.path.join(data_root(), "idrid",
                            "Segmentation", "A. Segmentation")
        imgs = os.path.join(base, "1. Original Images")
        masks = os.path.join(base, "2. All Segmentation Groundtruths")
        pattern = re.compile(
            re.escape(imgs) + r"/(?P<source_set>a. Training Set|"
            r"b. Testing Set)/IDRiD_(?P<id>\d+)\.jpg")
        return imgs, masks, pattern

    def __init__(self, config_dict: ConfigDict, seed: Optional[int] = None,
                 *args, **kwargs):
        task = config_dict.get("task", "MA")
        if isinstance(task, ConfigDict):
            task = task.key()
        tasks = (task,) if isinstance(task, str) else tuple(task)
        classes = [self.CLASSES_DICT[t] for t in tasks]
        self.CLASSES = classes
        all_classes = list(self.CLASSES_DICT.values())
        task_dirs = [f"{all_classes.index(c) + 1}. {c.title()}"
                     for c in classes]

        imgs_path, masks_path, fname_pattern = self._paths()
        img_paths = sorted(
            glob.glob(os.path.join(imgs_path, "a. Training Set", "*"))
            + glob.glob(os.path.join(imgs_path, "b. Testing Set", "*")))

        include_negatives = len(tasks) > 1 \
            or config_dict.get("include_negatives", False)
        multilabel = len(tasks) == 1 or config_dict.get("multilabel", False)
        base_sizes = _pair(config_dict.get("base_image_sizes", (1024, 2048)))
        crop = slice(self.LEFT_CROP, -self.RIGHT_CROP)

        imgs, masks, from_test = [], [], []
        for img_path in img_paths:
            match = fname_pattern.match(img_path)
            if match is None:
                continue
            source_set, img_id = match["source_set"], match["id"]

            with Image.open(img_path) as image:
                arr = np.asarray(image)[:, crop] / 255
            arr = warp.resize(arr, base_sizes)  # (H, W, 3) float64

            mask = []
            if not multilabel:
                mask.append(np.zeros(base_sizes, dtype=int))
            include_img = True
            for task_abbrev, task_dir in zip(tasks, task_dirs):
                mask_path = os.path.join(
                    masks_path, source_set, task_dir,
                    f"IDRiD_{img_id}_{task_abbrev}.tif")
                if not os.path.isfile(mask_path):
                    if include_negatives:
                        mask.append(np.zeros(base_sizes, dtype=int))
                    else:
                        include_img = False
                        break
                else:
                    with Image.open(mask_path) as image:
                        mask_arr = np.asarray(image)[:, crop]
                    if mask_arr.ndim == 3:  # RGB(A): lesion in any channel
                        mask_arr = mask_arr[:, :, :3].max(axis=-1)
                    mask_arr = warp.resize(mask_arr.astype(np.uint8),
                                           base_sizes)
                    mask.append(np.where(mask_arr == 0, 0, 1))
            if include_img:
                imgs.append(arr.astype(np.float32))
                masks.append(np.stack(mask, axis=-1))   # (H, W, K)
                from_test.append(source_set == "b. Testing Set")

        imgs = np.stack(imgs)
        masks = np.stack(masks)
        from_test = np.array(from_test)
        if not multilabel:
            masks = masks.argmax(axis=-1)[..., None]    # (N, H, W, 1) labels

        rng = np.random.default_rng(config_dict.get("seed") or seed)
        val_set = config_dict.get("validation_set", "test")
        if isinstance(val_set, ConfigDict):
            val_set = val_set.key()
        if val_set == "test":
            val_idcs = from_test
        elif val_set == "train":
            val_idcs = ~from_test
        elif val_set == "random":
            val_size = config_dict.get("validation_set_size",
                                       self.DEFAULT_VAL_SIZE)
            val_idcs = rng.permutation(len(from_test)) < val_size
        else:
            raise ValueError(
                "Parameter 'validation_set' must be one of 'test', "
                f"'train', or 'random', not '{val_set}'.")

        train_imgs, val_imgs = imgs[~val_idcs], imgs[val_idcs]
        train_masks, val_masks = masks[~val_idcs], masks[val_idcs]

        train_set_size = config_dict.get("train_set_size",
                                         self.PARAMS["train_set_size"])
        if train_set_size > len(train_imgs):
            raise ValueError(
                f"Specified train set size {train_set_size} is larger than "
                f"the total number of train images ({len(train_imgs)}).")
        train_sel = rng.permutation(len(train_imgs)) < train_set_size
        train_imgs, train_masks = train_imgs[train_sel], train_masks[train_sel]

        def finalize(m):
            return m[..., 0] if m.shape[-1] == 1 else m

        crop_sizes = config_dict.get("cropped_image_sizes", (512, 512))
        if crop_sizes is not None:
            crop_sizes = _pair(crop_sizes if isinstance(crop_sizes, (
                list, tuple)) else int(crop_sizes))
        if crop_sizes is None or crop_sizes == base_sizes:
            self.train = {"x": train_imgs, "mask": finalize(train_masks)}
            self.val = {"x": val_imgs, "mask": finalize(val_masks)}
            return

        stride = _pair(config_dict.get("train_crop_stride") or crop_sizes)
        threshold = 1 - config_dict.get("darkness_threshold", 0.99)
        self.kept, self.dropped = {}, {}

        for set_type, strides, base_imgs, base_masks in zip(
                ("train", "val"), (stride, crop_sizes),
                (train_imgs, val_imgs), (train_masks, val_masks)):
            crops, crop_masks = [], []
            num_crops = [(b - c) // s + 1 for b, c, s in
                         zip(base_sizes, crop_sizes, strides)]
            for img, mask in zip(base_imgs, base_masks):
                for i, j in itertools.product(range(num_crops[0]),
                                              range(num_crops[1])):
                    x0 = min(i * strides[0], base_sizes[0] - crop_sizes[0])
                    y0 = min(j * strides[1], base_sizes[1] - crop_sizes[1])
                    sl = (slice(x0, x0 + crop_sizes[0]),
                          slice(y0, y0 + crop_sizes[1]))
                    cropped = img[sl]
                    if np.mean(cropped) < threshold:  # on the float32 image
                        continue
                    crops.append(cropped)
                    crop_masks.append(mask[sl])
            self.kept[set_type] = len(crops)
            self.dropped[set_type] = \
                len(base_imgs) * num_crops[0] * num_crops[1] - len(crops)
            setattr(self, set_type,
                    {"x": np.stack(crops),
                     "mask": finalize(np.stack(crop_masks))})
