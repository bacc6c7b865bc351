"""Classification augmentations and the ``torchvision.transforms`` names.

The port's own copy of ``medsegpretrainimagenet_tpu/data/transforms/
classification.py`` (the reference's ``classification/transforms.py``):
OneHotEncoding, rectangle CutMix, MixupOrCutMix, RandAugment, and numpy
versions of the ``torchvision.transforms.*`` names the pretraining configs
use (Resize, CenterCrop, RandomHorizontalFlip, RandomResizedCrop,
ColorJitter, RandomErasing).

All transforms are host-side numpy on (H, W, C) arrays; labels are class
indices or one-hot vectors.  The numpy draws are the JAX package's, in the
same order, so the same seed gives the same outputs.  Where the JAX package
calls OpenCV the port has a numpy map of its own: resizing and affine warps
in ``data/warp.py``, and here the 3 x 3 Gaussian blur, histogram
equalisation and the float RGB/HSV conversions (:func:`gaussian_blur3`,
:func:`equalize_hist`, :func:`rgb_to_hsv`, :func:`hsv_to_rgb`).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from ...config import ConfigDict, register
from .. import warp
from .core import Mixup

__all__ = ["OneHotEncoding", "CutMix", "MixupOrCutMix", "RandAugment",
           "TVResize", "TVCenterCrop", "TVRandomHorizontalFlip",
           "RandomResizedCrop", "ColorJitter", "RandomErasing",
           "gaussian_blur3", "equalize_hist", "rgb_to_hsv", "hsv_to_rgb"]


@register("classification.transforms.OneHotEncoding")
class OneHotEncoding:
    PARAMS = dict(num_classes=1000)

    def __init__(self, config_dict: Optional[ConfigDict] = None,
                 num_classes: int = 1000, **kwargs):
        if config_dict is not None:
            num_classes = config_dict.get("num_classes", num_classes)
        self.num_classes = num_classes
        # made once: a num_classes² eye per item is 4 MB at 1000 classes
        self._eye = np.eye(num_classes, dtype=np.float32)

    def _encode(self, label):
        return self._eye[np.asarray(label).astype(int)].copy()

    def __call__(self, k: int = 1, **data):
        label = data["label"]
        if k > 1 and isinstance(label, list):
            data["label"] = [self._encode(l) for l in label]  # noqa: E741
        else:
            data["label"] = self._encode(label)
        data["k"] = k
        return data


@register("classification.transforms.CutMix")
class CutMix:
    """Rectangle CutMix with a beta-drawn area over a pair of datapoints;
    channels-last spatial axes."""

    PARAMS = dict(probability=1.0, alpha=1.0)
    num_datapoints = 2

    def __init__(self, config_dict: Optional[ConfigDict] = None,
                 seed: Optional[int] = None, **kwargs):
        config_dict = config_dict or ConfigDict()
        self.p = config_dict.get("probability", 1.0)
        self.alpha = config_dict.get("alpha", 1.0)
        self.rng = np.random.default_rng(seed)

    def __call__(self, k: int = 1, **data):
        (x1, x2), (t1, t2) = data["x"][:2], data["label"][:2]
        data = {key: value[0] if isinstance(value, list) else value
                for key, value in data.items()}
        data["k"] = 1
        if self.rng.binomial(1, self.p):
            x1 = np.asarray(x1)
            x2 = np.asarray(x2)
            w, h = x1.shape[0], x1.shape[1]
            lam = self.rng.beta(self.alpha, self.alpha)
            scale = np.sqrt(1 - lam) / 2
            rx, ry = self.rng.integers(0, w), self.rng.integers(0, h)
            rw = int(np.round(w * scale))
            rh = int(np.round(h * scale))
            x_start, x_end = max(0, rx - rw), min(w, rx + rw)
            y_start, y_end = max(0, ry - rh), min(h, ry + rh)
            x = np.array(x1, copy=True)
            x[x_start:x_end, y_start:y_end] = x2[x_start:x_end, y_start:y_end]
            mu = (x_end - x_start) * (y_end - y_start) / (h * w)
            data["x"] = x
            data["label"] = (1 - mu) * np.asarray(t1) + mu * np.asarray(t2)
        return data


@register("classification.transforms.MixupOrCutMix")
class MixupOrCutMix:
    PARAMS = dict(cutmix_params=CutMix.PARAMS, mixup_params=Mixup.PARAMS,
                  switch_probability=0.5)
    num_datapoints = 2

    @staticmethod
    def fill_kwargs(config_dict: ConfigDict):
        for key, spec in (("cutmix_params", CutMix.PARAMS),
                          ("mixup_params", Mixup.PARAMS)):
            if not config_dict.has(key):
                config_dict.get_or_update(key, {})
            if isinstance(config_dict.get(key), ConfigDict):
                config_dict[key].fill_with_defaults(spec)

    def __init__(self, config_dict: Optional[ConfigDict] = None,
                 seed: Optional[int] = None, **kwargs):
        config_dict = config_dict or ConfigDict()
        MixupOrCutMix.fill_kwargs(config_dict)
        self.cutmix = CutMix(config_dict.get("cutmix_params"), seed=seed)
        self.mixup = Mixup(config_dict.get("mixup_params"), seed=seed)
        self.switch_p = config_dict.get("switch_probability", 0.5)
        self.rng = np.random.default_rng(seed)

    def __call__(self, k: int = 1, **data):
        if self.rng.binomial(1, self.switch_p):
            return self.mixup(k=k, **data)
        return self.cutmix(k=k, **data)


class _PerDatapointImage:
    """An x-only image transform that applies per element of a list of
    ``k`` images: with a pair-mixing transform (``num_datapoints = 2``)
    later in the chain the loader hands ``x`` over as a list, and the
    draws run in list order."""

    def _image(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def __call__(self, k: int = 1, **data):
        x = data["x"]
        if k > 1 and isinstance(x, list):
            data["x"] = [self._image(xi) for xi in x]
        else:
            data["x"] = self._image(x)
        data["k"] = k
        return data


# ---------------------------------------------------------------------------
# OpenCV's maps, in numpy
# ---------------------------------------------------------------------------

def gaussian_blur3(img: np.ndarray) -> np.ndarray:
    """``cv2.GaussianBlur(img, (3, 3), 0)`` of a float (H, W[, C]) image:
    the kernel [1, 2, 1] / 4 along rows, then along columns, with the
    BORDER_REFLECT_101 border, in OpenCV's order of sums (float32; double
    for a float64 image)."""
    img = np.asarray(img)
    dtype = np.float64 if img.dtype == np.float64 else np.float32
    img = img.astype(dtype, copy=False)
    quarter, half = dtype(0.25), dtype(0.5)
    pad = ((1, 1), (1, 1)) + ((0, 0),) * (img.ndim - 2)
    p = np.pad(img, pad, mode="reflect")
    rows = (p[:, :-2] + p[:, 2:]) * quarter + p[:, 1:-1] * half
    return (rows[:-2] + rows[2:]) * quarter + rows[1:-1] * half


def equalize_hist(channel: np.ndarray) -> np.ndarray:
    """``cv2.equalizeHist`` of a uint8 image: the lookup table of the
    cumulative histogram past the lowest present value, scaled by 255 over
    the count of the others in float32 and rounded half to even."""
    channel = np.asarray(channel, np.uint8)
    hist = np.bincount(channel.ravel(), minlength=256)
    low = int(np.flatnonzero(hist)[0])
    if hist[low] == channel.size:
        return np.full_like(channel, low)
    scale = np.float32(255.0) / np.float32(channel.size - hist[low])
    lut = np.zeros(256, np.uint8)
    sums = np.cumsum(hist[low + 1:]).astype(np.float32)
    lut[low + 1:] = np.clip(np.rint(sums * scale), 0, 255).astype(np.uint8)
    return lut[channel]


_FLT_EPSILON = np.float32(np.finfo(np.float32).eps)


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2HSV)`` of a float32 RGB image in
    [0, 1]: H in degrees [0, 360), S and V in [0, 1]."""
    img = np.asarray(img, np.float32)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = diff / (np.abs(v) + _FLT_EPSILON)
    step = (60.0 / (diff + _FLT_EPSILON).astype(np.float64)).astype(
        np.float32)
    h = np.where(v == r, (g - b) * step,
                 np.where(v == g, (b - r) * step + np.float32(120.0),
                          (r - g) * step + np.float32(240.0)))
    h = np.where(h < 0, h + np.float32(360.0), h)
    return np.stack([h, s, v], axis=-1).astype(np.float32)


#: OpenCV's table: per hue sector, which of (v, p, q, t) is b, g, r
_HSV_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1],
                         [0, 1, 3], [2, 1, 0]])


def hsv_to_rgb(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_HSV2RGB)`` of a float32 HSV image with
    H in degrees."""
    img = np.asarray(img, np.float32)
    h, s, v = img[..., 0], img[..., 1], img[..., 2]
    h = np.mod(h * np.float32(6.0 / 360.0), np.float32(6.0))
    sector = np.floor(h).astype(np.int64)
    h = h - sector
    outside = (sector < 0) | (sector >= 6)
    sector = np.where(outside, 0, sector)
    h = np.where(outside, np.float32(0.0), h)
    one = np.float32(1.0)
    table = np.stack([v, v * (one - s), v * (one - s * h),
                      v * (one - s * (one - h))], axis=-1)
    bgr = np.take_along_axis(table, _HSV_SECTORS[sector], axis=-1)
    rgb = bgr[..., ::-1]
    return np.where((s == 0)[..., None], v[..., None], rgb).astype(np.float32)


# ---------------------------------------------------------------------------
# RandAugment
# ---------------------------------------------------------------------------

def _affine(img, matrix, fill=0.0, nearest=True):
    """``cv2.warpAffine`` of *img* onto its own size with a constant border.
    A scalar border value is OpenCV's ``Scalar(fill, 0, 0, 0)``: it fills
    the first channel only.  A float64 image (the blend ops' float64
    factors promote the image) takes OpenCV's fixed-point warp."""
    h, w = img.shape[:2]
    channels = img.shape[2] if img.ndim > 2 else 1
    border = np.zeros(channels, img.dtype)
    border[0] = 0.0 if fill is None else fill
    if img.dtype == np.float64:
        out = warp.warp_affine_fixed(img, matrix, (w, h), nearest=nearest,
                                     fill=border)
    else:
        out = warp.warp_affine(img, matrix, (w, h), nearest=nearest,
                               fill=border)
    return out if out.ndim == 3 else out[..., None]


def _blend(a, b, factor):
    return np.clip(a + factor * (b - a), 0, 255)


def _randaugment_ops(rng, magnitude, bins, nearest=True, fill=0.0):
    """(name -> op) table following torchvision's magnitude ranges; each op
    draws its sign from *rng* when it is called."""
    frac = magnitude / max(bins - 1, 1)
    aff = lambda img, m: _affine(  # noqa: E731
        img, np.asarray(m, np.float64), fill=fill, nearest=nearest)
    return {
        "Identity": lambda img: img,
        "ShearX": lambda img: aff(img, np.float32(
            [[1, math.tan(frac * 0.3 * rng.choice((-1, 1))), 0],
             [0, 1, 0]])),
        "ShearY": lambda img: aff(img, np.float32(
            [[1, 0, 0],
             [math.tan(frac * 0.3 * rng.choice((-1, 1))), 1, 0]])),
        "TranslateX": lambda img: aff(img, np.float32(
            [[1, 0, frac * 150 / 331 * img.shape[1]
              * rng.choice((-1, 1))], [0, 1, 0]])),
        "TranslateY": lambda img: aff(img, np.float32(
            [[1, 0, 0], [0, 1, frac * 150 / 331 * img.shape[0]
                         * rng.choice((-1, 1))]])),
        "Rotate": lambda img: aff(img, warp.rotation_matrix(
            (img.shape[1] / 2, img.shape[0] / 2),
            frac * 30 * rng.choice((-1, 1)), 1.0)),
        "Brightness": lambda img: _blend(
            np.zeros_like(img), img, 1 + frac * 0.9 * rng.choice((-1, 1))),
        "Color": lambda img: _blend(
            np.repeat(img.mean(-1, keepdims=True), img.shape[-1], -1), img,
            1 + frac * 0.9 * rng.choice((-1, 1))),
        "Contrast": lambda img: _blend(
            np.full_like(img, img.mean()), img,
            1 + frac * 0.9 * rng.choice((-1, 1))),
        "Sharpness": lambda img: _blend(
            gaussian_blur3(img).reshape(img.shape), img,
            1 + frac * 0.9 * rng.choice((-1, 1))),
        "Posterize": lambda img: np.bitwise_and(
            img.astype(np.uint8),
            np.uint8(256 - (1 << int(8 - int(8 - frac * 4))))
        ).astype(img.dtype),
        "Solarize": lambda img: np.where(img >= 255 - frac * 255,
                                         255 - img, img),
        "AutoContrast": lambda img: _autocontrast(img),
        "Equalize": lambda img: _equalize(img),
    }


def _autocontrast(img):
    out = np.empty_like(img)
    for c in range(img.shape[-1]):
        ch = img[..., c]
        lo, hi = ch.min(), ch.max()
        out[..., c] = (ch - lo) * (255.0 / (hi - lo)) if hi > lo else ch
    return out


def _equalize(img):
    out = np.empty_like(img)
    for c in range(img.shape[-1]):
        out[..., c] = equalize_hist(img[..., c].astype(np.uint8)).astype(
            img.dtype)
    return out


@register("classification.transforms.RandAugment")
class RandAugment(_PerDatapointImage):
    """RandAugment over images on the 0-255 scale (a [0, 1] image is scaled
    up and back): per image, ``num_ops`` ops drawn from the 14-op table."""

    def __init__(self, num_ops: int = 2, magnitude: int = 9,
                 num_magnitude_bins: int = 31, interpolation: str = "NEAREST",
                 fill=None, seed: Optional[int] = None, **kwargs):
        self.num_ops = num_ops
        self.magnitude = magnitude
        self.bins = num_magnitude_bins
        self.nearest = str(interpolation).upper() not in (
            "BILINEAR", "LINEAR", "INTERPOLATIONMODE.BILINEAR")
        self.fill = 0.0 if fill is None else float(
            fill[0] if isinstance(fill, (list, tuple)) else fill)
        self.rng = np.random.default_rng(seed)

    def _image(self, x):
        x = np.asarray(x, dtype=np.float32)
        scale = 1.0
        if x.max() <= 1.0 + 1e-6:  # [0, 1]-scaled input: work in 0-255
            x = x * 255.0
            scale = 255.0
        # the table is rebuilt per image, as in the JAX package
        ops = _randaugment_ops(self.rng, self.magnitude, self.bins,
                               nearest=self.nearest, fill=self.fill)
        names = list(ops)
        for _ in range(self.num_ops):
            op = ops[names[int(self.rng.integers(0, len(names)))]]
            x = np.clip(op(x), 0, 255)
        return (x / scale).astype(np.float32)


# ---------------------------------------------------------------------------
# torchvision.transforms.* names (numpy, channels-last)
# ---------------------------------------------------------------------------

def _resize(x, size):
    out = warp.resize(x, size)
    return out if out.ndim == 3 else out[..., None]


@register("torchvision.transforms.Resize")
class TVResize(_PerDatapointImage):
    def __init__(self, size: int = 224, seed=None, **kwargs):
        self.size = size

    def _image(self, x):
        x = np.asarray(x, np.float32)
        h, w = x.shape[:2]
        # torchvision semantics: an int resizes the SHORTER side
        if isinstance(self.size, int):
            if h <= w:
                nh, nw = self.size, max(int(round(w * self.size / h)), 1)
            else:
                nh, nw = max(int(round(h * self.size / w)), 1), self.size
        else:
            nh, nw = self.size
        return _resize(x, (nh, nw))


@register("torchvision.transforms.CenterCrop")
class TVCenterCrop(_PerDatapointImage):
    def __init__(self, size: int = 224, seed=None, **kwargs):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def _image(self, x):
        x = np.asarray(x)
        h, w = x.shape[:2]
        th, tw = self.size
        if h < th or w < tw:
            # torchvision pads smaller images with zeros before cropping
            ph, pw = max(th - h, 0), max(tw - w, 0)
            pad = [(ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)]
            pad += [(0, 0)] * (x.ndim - 2)
            x = np.pad(x, pad)
            h, w = x.shape[:2]
        top, left = (h - th) // 2, (w - tw) // 2
        return x[top:top + th, left:left + tw]


@register("torchvision.transforms.RandomHorizontalFlip")
class TVRandomHorizontalFlip(_PerDatapointImage):
    def __init__(self, p: float = 0.5, seed=None, **kwargs):
        self.p = p
        self.rng = np.random.default_rng(seed)

    def _image(self, x):
        if self.rng.random() < self.p:
            return np.ascontiguousarray(np.asarray(x)[:, ::-1])
        return x


@register("torchvision.transforms.RandomResizedCrop")
class RandomResizedCrop(_PerDatapointImage):
    def __init__(self, size: int = 224, scale=(0.08, 1.0),
                 ratio=(3 / 4, 4 / 3), seed=None, **kwargs):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = tuple(scale)
        self.ratio = tuple(ratio)
        self.rng = np.random.default_rng(seed)

    def _image(self, x):
        x = np.asarray(x, np.float32)
        h, w = x.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = area * self.rng.uniform(*self.scale)
            log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
            aspect = math.exp(self.rng.uniform(*log_ratio))
            cw = int(round(math.sqrt(target_area * aspect)))
            ch = int(round(math.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                top = int(self.rng.integers(0, h - ch + 1))
                left = int(self.rng.integers(0, w - cw + 1))
                crop = x[top:top + ch, left:left + cw]
                break
        else:  # fallback: center crop
            side = min(h, w)
            top, left = (h - side) // 2, (w - side) // 2
            crop = x[top:top + side, left:left + side]
        return _resize(crop, self.size)


@register("torchvision.transforms.ColorJitter")
class ColorJitter(_PerDatapointImage):
    def __init__(self, brightness: float = 0.0, contrast: float = 0.0,
                 saturation: float = 0.0, hue: float = 0.0, seed=None,
                 **kwargs):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        self.rng = np.random.default_rng(seed)

    def _factor(self, strength):
        return self.rng.uniform(max(0.0, 1 - strength), 1 + strength)

    def _image(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32)
        if self.brightness:
            x = x * self._factor(self.brightness)
        if self.contrast:
            mean = x.mean()
            x = (x - mean) * self._factor(self.contrast) + mean
        if self.saturation and x.shape[-1] == 3:
            gray = x.mean(-1, keepdims=True)
            x = gray + (x - gray) * self._factor(self.saturation)
        if self.hue and x.shape[-1] == 3:
            shift = self.rng.uniform(-self.hue, self.hue)
            # a 0-255 image (the uint8 transfer path) round-trips through
            # HSV on [0, 1] and goes back to its own scale
            scale = 255.0 if x.max() > 1.5 else 1.0
            hsv = rgb_to_hsv(np.clip(x / scale, 0, 1))
            hsv[..., 0] = (hsv[..., 0] + shift * 360.0) % 360.0
            x = hsv_to_rgb(hsv) * scale
        return np.clip(x, 0.0, 1.0) if x.max() <= 1.5 else x


@register("torchvision.transforms.RandomErasing")
class RandomErasing(_PerDatapointImage):
    def __init__(self, p: float = 0.5, scale=(0.02, 0.33),
                 ratio=(0.3, 3.3), value: float = 0.0, seed=None, **kwargs):
        self.p = p
        self.scale = tuple(scale)
        self.ratio = tuple(ratio)
        self.value = value
        self.rng = np.random.default_rng(seed)

    def _image(self, x):
        x = np.asarray(x)
        if self.rng.random() < self.p:
            h, w = x.shape[:2]
            for _ in range(10):
                area = h * w * self.rng.uniform(*self.scale)
                aspect = math.exp(self.rng.uniform(
                    math.log(self.ratio[0]), math.log(self.ratio[1])))
                eh = int(round(math.sqrt(area / aspect)))
                ew = int(round(math.sqrt(area * aspect)))
                if eh < h and ew < w:
                    top = int(self.rng.integers(0, h - eh))
                    left = int(self.rng.integers(0, w - ew))
                    x = np.array(x, copy=True)
                    x[top:top + eh, left:left + ew] = self.value
                    break
        return x
