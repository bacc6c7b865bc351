"""Joint image+mask augmentations (host-side numpy, channels-last).

The port's own copy of
``medsegpretrainimagenet_tpu/data/transforms/segmentation.py`` (the
reference's ``segmentation/transforms/{transforms,wrapped_transforms}.py``):
every transform acts jointly on ``x`` (H, W, C) and, when present,
``mask`` / ``distance_map`` (H, W), with nearest-neighbour resampling for
masks.  Where the JAX module calls OpenCV, this one calls the port's own
numpy maps (``data/warp.py``); the random parameters are drawn with numpy
exactly as the JAX module draws them, so the same seed gives the same
angles, flips and crops.

Registered names keep the reference aliases
(``segmentation.transforms.wrapped_transforms.*``) so shipped YAMLs run
unchanged.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ...config import ConfigDict, register
from .. import warp

__all__ = ["RandomRotation", "RandomFlip", "RandomHorizontalFlip",
           "CenterCrop", "Resize", "Partition", "RandomPick",
           "DiscreteOrRandomRot"]


def _border(mode) -> str:
    if isinstance(mode, ConfigDict):
        mode = mode.key()
    return warp.border_name(mode)


def _ensure_hwc(x):
    x = np.asarray(x)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[..., None]
    return x, squeeze


def _warp_affine(arr, matrix, dsize, nearest, border_mode, fill,
                 window=None):
    """``warp.warp_affine`` with OpenCV's scalar border value: OpenCV warps
    at most four channels at a time and fills the first of each group of
    four with *fill*, the others with 0; the JAX module inherits that."""
    arr, _ = _ensure_hwc(np.asarray(arr, np.float32))
    fills = np.where(np.arange(arr.shape[2]) % 4 == 0, float(fill), 0.0)
    return warp.warp_affine(arr, matrix, dsize, nearest=nearest,
                            border=border_mode, fill=fills, window=window)


def _rotate_array(arr, angle, nearest, border_mode, fill):
    """Rotation around the image centre, keeping the original size
    (albumentations ``Rotate`` semantics)."""
    h, w = arr.shape[:2]
    matrix = warp.rotation_matrix((w / 2 - 0.5, h / 2 - 0.5), angle, 1.0)
    return _warp_affine(arr, matrix, (w, h), nearest, border_mode, fill)


class _JointTransform:
    """Base: applies ``self.apply(img, is_mask, rng_draws)`` to x and the
    mask/distance-map columns jointly with one random draw per call."""

    def _draw(self):  # override: one sample of random parameters
        return None

    def apply(self, arr, is_mask, draw):
        raise NotImplementedError

    def __call__(self, k: int = 1, **data):
        draw = self._draw()
        for key in ("x", "mask", "distance_map"):
            if key not in data or data[key] is None:
                continue
            arr, squeeze = _ensure_hwc(data[key])
            out = self.apply(arr, key != "x", draw)
            data[key] = out[..., 0] if squeeze else out
        data["k"] = k
        return data


@register("segmentation.transforms.wrapped_transforms.RandomRotation")
class RandomRotation(_JointTransform):
    """Uniform rotation in [-limit, limit] degrees; linear interpolation on
    the image, nearest on masks (reference ``wrapped_transforms.py:48-82``).
    """

    PARAMS = {"limit": 180, "border_mode": "BORDER_CONSTANT"}

    @staticmethod
    def fill_kwargs(config_dict: ConfigDict):
        border_mode = config_dict.get("border_mode", "BORDER_CONSTANT")
        if isinstance(border_mode, ConfigDict):
            border_mode = border_mode.key()
        if border_mode in ("BORDER_CONSTANT", 0):
            config_dict.get_or_update("value", 0)
            config_dict.get_or_update("mask_value", 0)

    def __init__(self, config_dict: Optional[ConfigDict] = None,
                 seed: Optional[int] = None, **kwargs):
        config_dict = config_dict or ConfigDict()
        self.limit = config_dict.get("limit", 180)
        self.border_mode = _border(config_dict.get("border_mode",
                                                   "BORDER_CONSTANT"))
        self.value = config_dict.get("value", 0)
        self.mask_value = config_dict.get("mask_value", 0)
        # reference parity (wrapped_transforms.py:81): the reference does
        # ``alb_kwargs['p'] = alb_kwargs.get('p') or 1`` — a falsy p
        # (missing, null, AND an explicit 0) all become 1.  Quirky, but
        # configs must behave identically; the device-augment path
        # (cli/run_experiment.py) applies the same coercion.
        self.p = config_dict.get("p", None) or 1
        self.rng = np.random.default_rng(seed)

    def _draw(self):
        if self.rng.random() >= self.p:
            return None
        return float(self.rng.uniform(-self.limit, self.limit))

    def apply(self, arr, is_mask, angle):
        if angle is None:
            return arr
        dtype = arr.dtype
        out = _rotate_array(
            arr, angle, is_mask, self.border_mode,
            float(self.mask_value if is_mask else self.value))
        return out.astype(dtype)


@register("segmentation.transforms.wrapped_transforms.RandomFlip")
class RandomFlip(_JointTransform):
    """Vertical and/or horizontal flip with probability ``p`` (reference
    ``wrapped_transforms.py:84-102``; 'Flip' = random choice of h/v/both)."""

    PARAMS = {"horizontal": False, "vertical": True, "probability": 0.5}

    def __init__(self, config_dict: Optional[ConfigDict] = None,
                 seed: Optional[int] = None, **kwargs):
        config_dict = config_dict or ConfigDict()
        self.horizontal = bool(config_dict.get("horizontal", False))
        self.vertical = bool(config_dict.get("vertical", True))
        if not (self.horizontal or self.vertical):
            raise ValueError("RandomFlip needs at least one direction")
        # reference parity (wrapped_transforms.py:89): falsy probability
        # (missing/null/0) coerces to 1 — same quirk as RandomRotation
        self.p = config_dict.get("probability",
                                 config_dict.get("p", None)) or 1
        self.rng = np.random.default_rng(seed)

    def _draw(self):
        if self.rng.random() >= self.p:
            return None
        if self.horizontal and self.vertical:
            # albumentations Flip: -1 (both), 0 (vertical), 1 (horizontal)
            return int(self.rng.integers(-1, 2))
        return 1 if self.horizontal else 0

    def apply(self, arr, is_mask, code):
        if code is None:
            return arr
        if code in (0, -1):
            arr = arr[::-1]
        if code in (1, -1):
            arr = arr[:, ::-1]
        return np.ascontiguousarray(arr)


@register("segmentation.transforms.wrapped_transforms.RandomHorizontalFlip")
class RandomHorizontalFlip(RandomFlip):
    PARAMS: Dict[str, Any] = {}

    def __init__(self, config_dict: Optional[ConfigDict] = None,
                 seed: Optional[int] = None, **kwargs):
        cfg = ConfigDict({"horizontal": True, "vertical": False,
                          "probability": 0.5})
        super().__init__(cfg, seed=seed)


@register("segmentation.transforms.wrapped_transforms.CenterCrop")
class CenterCrop(_JointTransform):
    PARAMS = {"size": 128}

    def __init__(self, config_dict: Optional[ConfigDict] = None,
                 size=None, **kwargs):
        if config_dict is not None:
            size = config_dict.get("size", 128)
        size = size or 128
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def apply(self, arr, is_mask, draw):
        h, w = arr.shape[:2]
        th, tw = self.size
        if h < th or w < tw:
            # albumentations CenterCrop raises here too; a negative-index
            # slice would silently return a malformed sliver
            raise ValueError(f"CenterCrop size {self.size} exceeds image "
                             f"size {(h, w)}")
        top = (h - th) // 2
        left = (w - tw) // 2
        return arr[top:top + th, left:left + tw]


@register("segmentation.transforms.wrapped_transforms.Resize")
class Resize(_JointTransform):
    """Resize image (linear) and mask (nearest) to ``size``."""

    PARAMS = {"size": 224}

    def __init__(self, config_dict: Optional[ConfigDict] = None,
                 size=None, **kwargs):
        if config_dict is not None:
            size = config_dict.get("size", 224)
        size = size or 224
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def apply(self, arr, is_mask, draw):
        dtype = arr.dtype
        out = warp.resize(arr.astype(np.float32), self.size,
                          "nearest" if is_mask else "linear")
        return out.astype(dtype)


@register("segmentation.transforms.wrapped_transforms.Partition")
class Partition:
    """Deterministic grid crop selected by ``_index % num_partitions``
    (reference ``transforms.py:126-157``): one source image yields N crops
    across the epoch via the sampler's partition expansion."""

    PARAMS = {"number of partitions": {"argument name": "partition_count",
                                       "default": 4}}

    def __init__(self, config_dict: Optional[ConfigDict] = None,
                 partition_count=4, **kwargs):
        if config_dict is not None:
            partition_count = config_dict.get("number of partitions", 4)
        if isinstance(partition_count, int):
            partition_count = (int(math.isqrt(partition_count)),) * 2
        self.partition_counts = tuple(partition_count)
        self.num_partitions = int(np.prod(self.partition_counts))

    def __call__(self, k: int = 1, _index: int = 0, **data):
        if isinstance(_index, (list, tuple)):
            _index = _index[0]
        crop_idx = int(_index) % self.num_partitions
        l = crop_idx % self.partition_counts[0]  # noqa: E741
        t = crop_idx // self.partition_counts[0]
        x, _ = _ensure_hwc(data["x"])
        image_size = x.shape[:2]
        ch = image_size[0] // self.partition_counts[0]
        cw = image_size[1] // self.partition_counts[1]
        left = image_size[0] - ch if (l + 1) * ch > image_size[0] else l * ch
        top = image_size[1] - cw if (t + 1) * cw > image_size[1] else t * cw
        crop = (slice(left, left + ch), slice(top, top + cw))
        for key in ("x", "mask", "distance_map"):
            if key in data and data[key] is not None:
                data[key] = np.asarray(data[key])[crop]
        data["k"] = k
        data["_index"] = _index
        return data


@register("segmentation.transforms.wrapped_transforms.RandomPick")
class RandomPick(_JointTransform):
    """Random rotated square crop (reference ``transforms.py:75-124``):
    sample an angle, rotate with expansion, then crop a ``crop_size`` square
    whose position is chosen so it lies fully inside the original image."""

    PARAMS = {"crop size": {"argument name": "crop_size", "default": 256},
              "rotation limit": {"argument name": "rotate_limit",
                                 "default": 180}}

    def __init__(self, config_dict: Optional[ConfigDict] = None,
                 crop_size: int = 256, rotate_limit: int = 180,
                 seed: Optional[int] = None, **kwargs):
        if config_dict is not None:
            crop_size = config_dict.get("crop size", crop_size)
            rotate_limit = config_dict.get("rotation limit", rotate_limit)
        self.crop_size = crop_size
        self.rotate_limit = rotate_limit
        self.rng = np.random.default_rng(seed)

    def _coords(self, angle: int, img_size: int, u) -> Tuple[int, int]:
        alpha = np.deg2rad(angle % 90)
        sin_a, cos_a = np.sin(alpha), np.cos(alpha)
        length = img_size - self.crop_size * (sin_a + cos_a)
        rotation = np.array([[sin_a, -cos_a], [cos_a, sin_a]])
        shift = np.array([(img_size - self.crop_size * cos_a) * cos_a,
                          self.crop_size * sin_a * cos_a])
        xy = rotation @ np.floor(u * max(int(length), 1)) + shift
        return int(xy[0]), int(xy[1])

    def _draw(self):
        # ONE draw shared by every column: the crop position must be
        # identical for x and mask (reference ``transforms.py:98-104``
        # samples (angle, x, y) once) — the uniform pair is drawn here and
        # scaled to the angle-dependent range inside ``_coords``
        angle = int(self.rng.integers(-self.rotate_limit,
                                      self.rotate_limit)) \
            if self.rotate_limit else 0
        return angle, self.rng.random(2)

    def apply(self, arr, is_mask, draw):
        angle, u = draw
        img_size = arr.shape[0]
        left, top = self._coords(angle, img_size, u)
        # rotate with expansion (canvas grows to fit the rotated image)
        h, w = arr.shape[:2]
        rad = np.deg2rad(angle)
        new_w = int(abs(w * np.cos(rad)) + abs(h * np.sin(rad)) + 0.5)
        new_h = int(abs(w * np.sin(rad)) + abs(h * np.cos(rad)) + 0.5)
        matrix = warp.rotation_matrix((w / 2 - 0.5, h / 2 - 0.5), angle,
                                      1.0)
        matrix[0, 2] += (new_w - w) / 2
        matrix[1, 2] += (new_h - h) / 2
        # the crop of the rotated canvas, computed alone
        crop = _warp_affine(arr, matrix, (new_w, new_h), is_mask,
                            "BORDER_CONSTANT", 0,
                            window=(slice(top, top + self.crop_size),
                                    slice(left, left + self.crop_size)))
        # guard against edge rounding: pad to exact crop size if needed
        ph = self.crop_size - crop.shape[0]
        pw = self.crop_size - crop.shape[1]
        if ph > 0 or pw > 0:
            crop = np.pad(crop, ((0, max(ph, 0)), (0, max(pw, 0)), (0, 0)))
        return crop.astype(arr.dtype)


@register("segmentation.transforms.transforms.DiscreteOrRandomRot",
          "segmentation.transforms.wrapped_transforms.DiscreteOrRandomRot")
class DiscreteOrRandomRot:
    """90-degree rotation + flip, or a small continuous rotation (reference
    ``transforms.py:159-233``)."""

    PARAMS = {"rotation_limit": 20, "border_mode": "BORDER_CONSTANT",
              "discrete_rotation_probability": 0.5,
              "continuous_rotation_probability": 0.5}

    def __init__(self, config_dict: Optional[ConfigDict] = None,
                 seed: Optional[int] = None, **kwargs):
        config_dict = config_dict or ConfigDict()
        trimmed = config_dict.trim()
        self.rotation_limit = trimmed.get("rotation_limit", 20)
        self.p_discrete = trimmed.get("discrete_rotation_probability", 0.5)
        self.p_continuous = trimmed.get("continuous_rotation_probability",
                                        0.5)
        self.border_mode = _border(trimmed.get("border_mode",
                                               "BORDER_CONSTANT"))
        self.value = config_dict.get("padding_value", 0)
        self.mask_value = config_dict.get("mask_padding_value", 0)
        self.rng = np.random.default_rng(seed)
        self._cont = RandomRotation(ConfigDict({
            "limit": self.rotation_limit, "value": self.value,
            "mask_value": self.mask_value}), seed=seed)
        self._cont.border_mode = self.border_mode

    def __call__(self, k: int = 1, **data):
        if self.rng.binomial(1, self.p_discrete):
            # RandomRotate90(p=1) draws 0..3 inclusive — 0 turns (flip
            # only) must occur with probability 1/4 like the reference
            turns = int(self.rng.integers(0, 4))
            for key in ("x", "mask", "distance_map"):
                if key in data and data[key] is not None:
                    arr, squeeze = _ensure_hwc(data[key])
                    arr = np.rot90(arr, k=turns, axes=(0, 1))
                    arr = arr[:, ::-1]  # reference flips after rotating
                    arr = np.ascontiguousarray(arr)
                    data[key] = arr[..., 0] if squeeze else arr
            data["k"] = k
            return data
        if self.rng.binomial(1, self.p_continuous):
            return self._cont(k=k, **data)
        data["k"] = k
        return data
