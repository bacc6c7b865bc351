"""Host-side image resampling in numpy: resize and affine warps.

The JAX package resamples with OpenCV (``cv2.resize``, ``cv2.warpAffine``);
the port carries its own numpy versions of the same maps, so that it runs
where OpenCV is not installed:

* :func:`resize`: bilinear with half-pixel centres and no antialiasing,
  edge pixels clamped, as ``cv2.INTER_LINEAR``.  Float images follow
  OpenCV 5's arithmetic (double weights and sums for 1, 3 or 4 channels;
  float32 weights for 2 or more than 4, summed in the image's precision);
  uint8 images its 11-bit fixed-point weights
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
  rounding: within 3e-6 on [0, 1] images.  Nearest computes the source
  coordinates in float32 as OpenCV 5's loop does (fused multiply-adds in
  its vectorised columns, another order in its scalar tail), so every
  nearest pixel is OpenCV's, on all five borders, also where a
  coordinate falls on a half pixel; :func:`rotation_matrix` is
  ``cv2.getRotationMatrix2D``.
* :func:`warp_affine_fixed`: ``cv2.warpAffine`` of a float64 image with a
  constant border, which OpenCV 5 still runs through its fixed-point map
  (source coordinates in 1/1024 pixel, bilinear weights at 1/32 pixel):
  equal to OpenCV's to double rounding.

Images are (H, W) or (H, W, C) arrays.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["resize", "warp_affine", "warp_affine_fixed", "rotation_matrix",
           "border_name", "BORDER_MODES"]

#: border mode names of the configs (OpenCV's constant names)
BORDER_MODES = ("BORDER_CONSTANT", "BORDER_REPLICATE", "BORDER_REFLECT",
                "BORDER_REFLECT_101", "BORDER_WRAP")

#: OpenCV's integer codes for the border modes
_BORDER_CODES = {0: "BORDER_CONSTANT", 1: "BORDER_REPLICATE",
                 2: "BORDER_REFLECT", 3: "BORDER_WRAP",
                 4: "BORDER_REFLECT_101"}

_COEF_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS
_AB_BITS, _INTER_BITS = 10, 5  # OpenCV's fixed-point warp: 1/1024, 1/32


def border_name(mode) -> str:
    """A border mode's name from its name or OpenCV code; an unknown name
    is the constant border."""
    if isinstance(mode, int):
        return _BORDER_CODES[mode]
    return mode if mode in BORDER_MODES else "BORDER_CONSTANT"


def _linear_taps(out: int, size: int, dtype=np.float32):
    """Source index pairs and the weight of the second, per output index,
    in *dtype* as OpenCV computes them."""
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
    # OpenCV 5 weighs a float image of 1, 3 or 4 channels in double and
    # sums it in double; one of 2 or more than 4 channels has float32
    # weights, summed in the image's own precision (uint8: float32 weights)
    double = img.dtype != np.uint8 \
        and (img.shape[2] if img.ndim > 2 else 1) in (1, 3, 4)
    weights = np.float64 if double else np.float32
    work = np.float64 if double or img.dtype == np.float64 else np.float32
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
        rows0, rows1 = (_horizontal(img[y].astype(np.int64), x0, x1, ax0,
                                    ax1) for y in (y0, y1))
        # OpenCV's vectorised vertical pass: 16-bit high products, +2 >> 2
        out = ((by0 * (rows0 >> 4)) >> 16) + ((by1 * (rows1 >> 4)) >> 16)
        return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)
    ax1 = fx.astype(work)[(slice(None),) + extra]
    ax0 = (weights(1) - fx).astype(work)[(slice(None),) + extra]
    by1 = fy.astype(work)[(slice(None), None) + extra]
    by0 = (weights(1) - fy).astype(work)[(slice(None), None) + extra]
    rows0, rows1 = (_horizontal(img[y].astype(work, copy=False), x0, x1,
                                ax0, ax1) for y in (y0, y1))
    rows0 *= by0
    rows1 *= by1
    rows0 += rows1
    return rows0.astype(img.dtype, copy=False)


def _horizontal(rows: np.ndarray, x0, x1, a0, a1) -> np.ndarray:
    """``rows[:, x0] * a0 + rows[:, x1] * a1``, the horizontal pass, in
    place of its temporaries (the same products and sums)."""
    out = rows[:, x0]
    out *= a0
    right = rows[:, x1]
    right *= a1
    out += right
    return out


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


def _inverse_affine(matrix) -> np.ndarray:
    """OpenCV's inverse of a 2 x 3 affine map, in double."""
    m = np.asarray(matrix, np.float64)
    det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    det = 1.0 / det if det else 0.0
    a11, a22 = m[1, 1] * det, m[0, 0] * det
    a12, a21 = -m[0, 1] * det, -m[1, 0] * det
    return np.array([[a11, a12, -a11 * m[0, 2] - a12 * m[1, 2]],
                     [a21, a22, -a21 * m[0, 2] - a22 * m[1, 2]]])


def warp_affine(img: np.ndarray, matrix: np.ndarray,
                dsize: Tuple[int, int], nearest: bool = False,
                border: str = "BORDER_CONSTANT",
                fill: float = 0.0,
                window: Optional[Tuple[slice, slice]] = None) -> np.ndarray:
    """``cv2.warpAffine(img, matrix, dsize=(width, height))`` in float32.

    Each output pixel (x, y) samples the input at ``M^-1 (x, y)``; a tap
    outside the input reads *fill* (constant border; a scalar or one value
    per channel) or the pixel the border rule maps it to.  *window*, a
    (rows, columns) pair of slices, computes only that part of the output,
    ``warp_affine(...)[window]`` pixel for pixel."""
    border = border_name(border)
    img = np.asarray(img, np.float32)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w = img.shape[:2]
    ow, oh = int(dsize[0]), int(dsize[1])
    rows, cols = window or (slice(None), slice(None))
    ys = np.arange(oh)[rows][:, None]
    xs = np.arange(ow)[cols][None]
    inv = _inverse_affine(matrix)

    def tap(yi, xi):
        if border == "BORDER_CONSTANT":
            valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            vals = img[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]
            return np.where(valid[..., None], vals, np.float32(fill))
        return img[_border_index(yi, h, border), _border_index(xi, w, border)]

    if nearest:
        sx, sy = _nearest_coordinates(inv, ow, xs, ys)
        out = tap(np.rint(sy).astype(np.int64), np.rint(sx).astype(np.int64))
    else:
        sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
        sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
        x0, y0 = np.floor(sx), np.floor(sy)
        fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
        x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
        out = ((1 - fy) * ((1 - fx) * tap(y0, x0) + fx * tap(y0, x0 + 1))
               + fy * ((1 - fx) * tap(y0 + 1, x0) + fx * tap(y0 + 1, x0 + 1)))
    out = out.astype(np.float32)
    return out[..., 0] if squeeze else out


#: output columns per step of OpenCV 5's vectorised warp loop (two
#: 8-lane float32 vectors); the columns past the last full step take its
#: scalar loop
_WARP_STEP = 16


def _nearest_coordinates(inv: np.ndarray, ow: int, xs: np.ndarray,
                         ys: np.ndarray):
    """The float32 source coordinates of OpenCV 5's nearest warp to an
    output *ow* pixels wide, at columns *xs* (1, n) and rows *ys* (m, 1):
    the map in float32; per row ``b * y + c``; ``fma(a, x, b * y + c)`` in
    the vectorised columns and ``fma(a, x, b * y) + c`` in the scalar
    tail.  Rounded half to even, they pick OpenCV's taps, also where a
    coordinate lies on a half pixel in exact arithmetic."""
    f32 = inv.astype(np.float32)
    vector = xs < ow - ow % _WARP_STEP
    xs, ys = xs.astype(np.float64), ys.astype(np.float32)
    out = []
    for a, b, c in f32:
        by = b * ys
        # a float32 times an integer is exact in double: the sum rounds
        # once to float32, as the fused multiply-add does
        fused = (a.astype(np.float64) * xs + (by + c)).astype(np.float32)
        tail = (a.astype(np.float64) * xs + by).astype(np.float32) + c
        out.append(np.where(vector, fused, tail))
    return out


def warp_affine_fixed(img: np.ndarray, matrix: np.ndarray,
                      dsize: Tuple[int, int], nearest: bool = False,
                      fill=0.0) -> np.ndarray:
    """``cv2.warpAffine(img, matrix, dsize=(width, height))`` of a float64
    image with a constant border of *fill* (a scalar or one value per
    channel), in OpenCV's fixed-point arithmetic: per output row and
    column the inverse map's terms are rounded to 1/1024 pixel; nearest
    takes the tap those sums round to, bilinear the 1/32-pixel cell below
    them with its exact weights, summed in double.  The dtype is kept."""
    img = np.asarray(img)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w = img.shape[:2]
    ow, oh = int(dsize[0]), int(dsize[1])
    inv = _inverse_affine(matrix)
    scale = 1 << _AB_BITS
    xs, ys = np.arange(ow), np.arange(oh)
    half = scale // 2 if nearest else scale >> (_INTER_BITS + 1)
    sx = (np.rint((inv[0, 1] * ys + inv[0, 2]) * scale).astype(np.int64)
          + half)[:, None] + np.rint(inv[0, 0] * xs * scale).astype(
              np.int64)[None]
    sy = (np.rint((inv[1, 1] * ys + inv[1, 2]) * scale).astype(np.int64)
          + half)[:, None] + np.rint(inv[1, 0] * xs * scale).astype(
              np.int64)[None]
    border = np.broadcast_to(np.asarray(fill, img.dtype), (img.shape[2],))

    def tap(yi, xi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        vals = img[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]
        return np.where(valid[..., None], vals, border)

    if nearest:
        out = tap(sy >> _AB_BITS, sx >> _AB_BITS)
    else:
        sx, sy = sx >> (_AB_BITS - _INTER_BITS), sy >> (_AB_BITS - _INTER_BITS)
        cell = 1 << _INTER_BITS
        fx = ((sx & (cell - 1)) / cell)[..., None]
        fy = ((sy & (cell - 1)) / cell)[..., None]
        x0, y0 = sx >> _INTER_BITS, sy >> _INTER_BITS
        out = (tap(y0, x0) * ((1 - fy) * (1 - fx))
               + tap(y0, x0 + 1) * ((1 - fy) * fx)
               + tap(y0 + 1, x0) * (fy * (1 - fx))
               + tap(y0 + 1, x0 + 1) * (fy * fx))
    out = out.astype(img.dtype)
    return out[..., 0] if squeeze else out
