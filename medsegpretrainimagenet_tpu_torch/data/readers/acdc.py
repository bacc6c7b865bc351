"""ACDC cardiac MRI reader (NIfTI patient volumes).

The port's own copy of ``medsegpretrainimagenet_tpu/data/readers/acdc.py``
(the reference's ``segmentation/datasets/datasets.py:326-404``): patient
directories under ``training/`` (and ``testing/`` with ``validate_on_test``)
each hold ``*frame*.nii.gz`` image / ``_gt`` label pairs; every (H, W, Z)
volume is resized slice by slice and the slices are stacked.  Classes:
RV cavity / myocardium / LV cavity, 0 the background.

Resizing is the port's numpy map (``data/warp.py``): the float64 volumes
bilinearly in double, as OpenCV resizes them, the labels by nearest.  Like
the reference, ``image_sizes = (a, b)`` is passed on as OpenCV's
``dsize = (width, height)``, so a non-square size gives b rows of a
columns.

Output layout is channels-last: ``x`` (N, H, W, 1) float32, ``mask``
(N, H, W) int32 with values 0..3.
"""
from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np

from ...config import ConfigDict, register
from .. import warp
from ..dataset import Dataset
from .covidqu import data_root
from .nifti import load_nii

__all__ = ["ACDC"]


@register("segmentation.datasets.ACDC", "acdc")
class ACDC(Dataset):
    PARAMS = {
        "val split percentage": {"argument name": "val_split_percentage",
                                 "default": 0.2},
        "validate on test": {"argument name": "validate_on_test",
                             "default": False},
        "image sizes": {"argument name": "image_sizes", "default": 256},
    }

    CLASSES = ("RV cavity", "myocardium", "LV cavity")

    @staticmethod
    def _frame_pairs(patient_dirs):
        img_paths, label_paths = [], []
        for patient in patient_dirs:
            frames = sorted(glob.glob(os.path.join(patient,
                                                   "*frame*.nii.gz")))
            imgs, labels = frames[0::2], frames[1::2]
            for i, l in zip(imgs, labels):
                if i[:-7] + "_gt.nii.gz" != l:
                    raise ValueError(f"Wrong path pairing! img path: {i}, "
                                     f"labels path: {l}")
            img_paths += imgs
            label_paths += labels
        return img_paths, label_paths

    @staticmethod
    def _load_stack(paths, size, is_label):
        vols = []
        for path in paths:
            vol = load_nii(path)[0]             # (H, W, Z) float64
            # size is OpenCV's (width, height), as the reference passes it
            vol = warp.resize(vol, (size[1], size[0]),
                              "nearest" if is_label else "linear")
            if vol.ndim == 2:
                vol = vol[..., None]
            vols.append(vol)
        stack = np.concatenate(vols, axis=2).transpose(2, 0, 1)
        return stack.astype(np.int32) if is_label \
            else stack.astype(np.float32)

    def __init__(self, ds_dict: ConfigDict, seed: Optional[int] = None,
                 *args, **kwargs):
        split = ds_dict.get("val split percentage", 0.2)
        validate_on_test = ds_dict.get("validate on test", False)
        size = ds_dict.get("image sizes", 256)
        if isinstance(size, int):
            size = (size, size)

        root = os.path.join(data_root(), "ACDC")
        patient_paths = sorted(
            p for p in glob.glob(os.path.join(root, "training", "*"))
            if os.path.isdir(p))
        n = len(patient_paths)

        if not validate_on_test:
            rnd = np.random.default_rng(ds_dict.get("seed") or seed)
            order = np.arange(n)
            rnd.shuffle(order)
            val_length = int(split * n)
            train_idcs = order >= val_length
        else:
            patient_paths += sorted(
                p for p in glob.glob(os.path.join(root, "testing", "*"))
                if os.path.isdir(p))
            train_idcs = np.concatenate(
                [np.full(n, True), np.full(len(patient_paths) - n, False)])
        val_idcs = ~train_idcs
        patients = np.array(patient_paths)

        train_imgs, train_labels = self._frame_pairs(patients[train_idcs])
        val_imgs, val_labels = self._frame_pairs(patients[val_idcs])

        self.train = {
            "x": self._load_stack(train_imgs, size, False)[..., None],
            "mask": self._load_stack(train_labels, size, True)}
        self.val = {
            "x": self._load_stack(val_imgs, size, False)[..., None],
            "mask": self._load_stack(val_labels, size, True)}
