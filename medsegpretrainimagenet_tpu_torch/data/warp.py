"""Host-side image resampling in numpy: resize and affine warps.

The JAX package resamples with OpenCV (``cv2.resize``, ``cv2.warpAffine``);
the port carries its own numpy versions of the same maps, so that it runs
where OpenCV is not installed:

* :func:`resize`: bilinear with half-pixel centres and no antialiasing,
  edge pixels clamped, as ``cv2.INTER_LINEAR``.  Float images follow
  OpenCV's arithmetic (float32; float64 for a float64 image, its weights
  in float32 past 4 channels); uint8 images its 11-bit fixed-point weights
  and rounding, so both give OpenCV's values: floats to rounding, uint8
  bit for bit when shrinking (on enlarging OpenCV rounds about one pixel
  in a hundred the other way, by one gray level).  Nearest takes
  ``floor(dst * src / dst)``, OpenCV's ``INTER_NEAREST`` rule (OpenCV
  rounds that product in fixed point, so a pixel can differ on upscaling).
* :func:`warp_affine`: the inverse map ``dst(x, y) = src(M^-1 (x, y))``
  of ``cv2.warpAffine``, bilinear or nearest (round half to even), with a
  constant, replicated, reflected or wrapped border.  OpenCV 5 warps a
  float image in float on every border (OpenCV 4 quantised the source
  coordinates to 1/32 pixel; 5 does not), so the two agree to float
  rounding: within 3e-6 on [0, 1] images, and every nearest pixel equal,
  on all five borders; :func:`rotation_matrix` is
  ``cv2.getRotationMatrix2D``.

Images are (H, W) or (H, W, C) arrays.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["resize", "warp_affine", "rotation_matrix", "border_name",
           "BORDER_MODES"]

#: border mode names of the configs (OpenCV's constant names)
BORDER_MODES = ("BORDER_CONSTANT", "BORDER_REPLICATE", "BORDER_REFLECT",
                "BORDER_REFLECT_101", "BORDER_WRAP")

#: OpenCV's integer codes for the border modes
_BORDER_CODES = {0: "BORDER_CONSTANT", 1: "BORDER_REPLICATE",
                 2: "BORDER_REFLECT", 3: "BORDER_WRAP",
                 4: "BORDER_REFLECT_101"}

_COEF_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS


def border_name(mode) -> str:
    """A border mode's name from its name or OpenCV code; an unknown name
    is the constant border."""
    if isinstance(mode, int):
        return _BORDER_CODES[mode]
    return mode if mode in BORDER_MODES else "BORDER_CONSTANT"


def _linear_taps(out: int, size: int, dtype=np.float32):
    """Source index pairs and the weight of the second, per output index,
    in *dtype* as OpenCV computes them (float32, float64 for a float64
    image)."""
    f = ((np.arange(out) + 0.5) * (size / out) - 0.5).astype(dtype)
    lo = np.floor(f)
    frac = (f - lo).astype(dtype)
    lo = lo.astype(np.int64)
    under, over = lo < 0, lo >= size - 1
    frac[under | over] = 0
    lo = np.clip(lo, 0, size - 1)
    return lo, np.minimum(lo + 1, size - 1), frac


def resize(img: np.ndarray, size: Tuple[int, int],
           interpolation: str = "linear") -> np.ndarray:
    """Resize *img* to ``size = (height, width)``; the dtype is kept."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    oh, ow = int(size[0]), int(size[1])
    if interpolation == "nearest":
        ys = np.minimum(np.floor(np.arange(oh) * (h / oh)).astype(np.int64),
                        h - 1)
        xs = np.minimum(np.floor(np.arange(ow) * (w / ow)).astype(np.int64),
                        w - 1)
        return img[ys][:, xs]
    if interpolation != "linear":
        raise ValueError(f"unknown interpolation {interpolation!r}")
    work = np.float64 if img.dtype == np.float64 else np.float32
    # OpenCV weighs a float64 image of up to 4 channels in double, one of
    # more channels in float32 (and interpolates in double either way)
    weights = np.float32 if img.ndim > 2 and img.shape[2] > 4 else work
    y0, y1, fy = _linear_taps(oh, h, weights)
    x0, x1, fx = _linear_taps(ow, w, weights)
    extra = (None,) * (img.ndim - 2)
    if img.dtype == np.uint8:
        one = 1 << _COEF_BITS
        ax1 = np.rint(fx * one).astype(np.int64)[(slice(None),) + extra]
        ax0 = np.rint((1 - fx) * one).astype(np.int64)[(slice(None),) + extra]
        by1 = np.rint(fy * one).astype(np.int64)[(slice(None), None) + extra]
        by0 = np.rint((1 - fy) * one).astype(np.int64)[
            (slice(None), None) + extra]
        src = img.astype(np.int64)
        rows0 = src[y0][:, x0] * ax0 + src[y0][:, x1] * ax1
        rows1 = src[y1][:, x0] * ax0 + src[y1][:, x1] * ax1
        # OpenCV's vectorised vertical pass: 16-bit high products, +2 >> 2
        out = ((by0 * (rows0 >> 4)) >> 16) + ((by1 * (rows1 >> 4)) >> 16)
        return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)
    src = img.astype(work)
    ax1 = fx.astype(work)[(slice(None),) + extra]
    ax0 = (weights(1) - fx).astype(work)[(slice(None),) + extra]
    by1 = fy.astype(work)[(slice(None), None) + extra]
    by0 = (weights(1) - fy).astype(work)[(slice(None), None) + extra]
    rows0 = src[y0][:, x0] * ax0 + src[y0][:, x1] * ax1
    rows1 = src[y1][:, x0] * ax0 + src[y1][:, x1] * ax1
    return (rows0 * by0 + rows1 * by1).astype(img.dtype)


def rotation_matrix(center: Tuple[float, float], angle: float,
                    scale: float = 1.0) -> np.ndarray:
    """The 2 x 3 matrix of a rotation by *angle* degrees (counter-clockwise
    on screen) about *center* = (x, y), as ``cv2.getRotationMatrix2D``."""
    a = np.deg2rad(angle)
    alpha, beta = scale * np.cos(a), scale * np.sin(a)
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _border_index(i: np.ndarray, n: int, mode: str) -> np.ndarray:
    """Map out-of-range indices into [0, n) by the border rule."""
    if mode == "BORDER_REPLICATE" or n == 1:
        return np.clip(i, 0, n - 1)
    if mode == "BORDER_WRAP":
        return np.mod(i, n)
    if mode == "BORDER_REFLECT":
        i = np.mod(i, 2 * n)
        return np.where(i >= n, 2 * n - 1 - i, i)
    if mode == "BORDER_REFLECT_101":
        i = np.mod(i, 2 * n - 2)
        return np.where(i >= n, 2 * n - 2 - i, i)
    raise ValueError(f"unknown border mode {mode!r}")


def warp_affine(img: np.ndarray, matrix: np.ndarray,
                dsize: Tuple[int, int], nearest: bool = False,
                border: str = "BORDER_CONSTANT",
                fill: float = 0.0) -> np.ndarray:
    """``cv2.warpAffine(img, matrix, dsize=(width, height))`` in float32.

    Each output pixel (x, y) samples the input at ``M^-1 (x, y)``; a tap
    outside the input reads *fill* (constant border; a scalar or one value
    per channel) or the pixel the border rule maps it to."""
    border = border_name(border)
    img = np.asarray(img, np.float32)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w = img.shape[:2]
    ow, oh = int(dsize[0]), int(dsize[1])
    m = np.asarray(matrix, np.float64)
    inv = np.linalg.inv(m[:, :2])
    shift = -inv @ m[:, 2]
    ys, xs = np.mgrid[:oh, :ow].astype(np.float64)
    sx = inv[0, 0] * xs + inv[0, 1] * ys + shift[0]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + shift[1]

    def tap(yi, xi):
        if border == "BORDER_CONSTANT":
            valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            vals = img[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]
            return np.where(valid[..., None], vals, np.float32(fill))
        return img[_border_index(yi, h, border), _border_index(xi, w, border)]

    if nearest:
        out = tap(np.rint(sy).astype(np.int64), np.rint(sx).astype(np.int64))
    else:
        x0, y0 = np.floor(sx), np.floor(sy)
        fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
        x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
        out = ((1 - fy) * ((1 - fx) * tap(y0, x0) + fx * tap(y0, x0 + 1))
               + fy * ((1 - fx) * tap(y0 + 1, x0) + fx * tap(y0 + 1, x0 + 1)))
    out = out.astype(np.float32)
    return out[..., 0] if squeeze else out
