"""On-device batched augmentation: the port of the segmentation part of
``medsegpretrainimagenet_tpu/ops/augment.py``.

These ops run inside the train step on the batch already on the card, so
the host pipeline reduces to batch slicing and one copy:

* ``rotate_batch``: per-sample rotation about the image centre (bilinear
  for images, nearest for mask columns, constant fill), the inverse map of
  the host ``RandomRotation``;
* ``flip_batch``: per-sample vertical/horizontal flips;
* ``repeat_channels``: the channel repeat of ``transform.RepeatChannels``;
* ``make_device_augment``: the standard segmentation chain (rotation,
  flip, channel repeat) as one ``(generator, fragment) -> fragment``;
* ``random_resized_crop_batch``, ``mixup_or_cutmix_batch``,
  ``erase_batch`` and ``make_classification_device_augment``: the
  ImageNet pretraining chain (RandomResizedCrop, horizontal flip, one-hot,
  MixupOrCutMix over batch-permutation partners, RandomErasing) in the
  step, so the host only loads and stacks the stored uint8 images.

The draws come from the step's ``torch.Generator`` on the fragment's device,
so they queue no host sync.  JAX draws with threefry and torch with Philox:
the same seed gives other angles in the two packages, the same angles give
the same images; each op takes its draws as arguments, so the two can be
held against each other on injected draws.  As in the JAX package, the
on-card crop draws one clamped box per sample (no ten-try rejection loop)
and the mixing partner is a permutation of the batch.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["rotate_batch", "flip_batch", "repeat_channels",
           "make_device_augment", "random_resized_crop_batch",
           "mixup_or_cutmix_batch", "erase_batch",
           "make_classification_device_augment"]


def _grid(h: int, w: int, angles_rad: torch.Tensor):
    """Inverse-mapped source coordinates, (N, H, W) each, in float32."""
    cx, cy = w / 2.0 - 0.5, h / 2.0 - 0.5
    device = angles_rad.device
    ys = torch.arange(h, dtype=torch.float32, device=device) - cy
    xs = torch.arange(w, dtype=torch.float32, device=device) - cx
    dy, dx = torch.meshgrid(ys, xs, indexing="ij")
    ca = torch.cos(angles_rad)[:, None, None]
    sa = torch.sin(angles_rad)[:, None, None]
    sx = ca * dx[None] - sa * dy[None] + cx
    sy = sa * dx[None] + ca * dy[None] + cy
    return sx, sy


def _gather(images: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor):
    """images (N, H, W, C), iy/ix (N, H', W') in range -> (N, H', W', C)."""
    n, h, w, c = images.shape
    flat = (iy * w + ix).reshape(n, -1, 1).expand(-1, -1, c)
    out = torch.gather(images.reshape(n, h * w, c), 1, flat)
    return out.reshape(n, *iy.shape[1:], c)


def rotate_batch(images: torch.Tensor, angles_deg: torch.Tensor,
                 fill: float = 0.0, nearest: bool = False) -> torch.Tensor:
    """Rotate (N, H, W, C) by per-sample degrees (counter-clockwise, the
    OpenCV/albumentations convention); constant border."""
    n, h, w, c = images.shape
    angles = torch.deg2rad(angles_deg.to(torch.float32))
    sx, sy = _grid(h, w, angles)
    if nearest:
        rx, ry = torch.round(sx), torch.round(sy)
        valid = (rx >= 0) & (rx < w) & (ry >= 0) & (ry < h)
        out = _gather(images, ry.long().clamp(0, h - 1),
                      rx.long().clamp(0, w - 1))
        # new_full fills on the device: a tensor made from a host scalar
        # would be a synchronous copy
        return torch.where(valid[..., None], out, out.new_full((), fill))
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    img = images.to(torch.float32)
    fill_v = img.new_full((), fill)

    def corner(yi, xi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        vals = _gather(img, yi.clamp(0, h - 1), xi.clamp(0, w - 1))
        return torch.where(valid[..., None], vals, fill_v)

    out = ((1 - fy) * ((1 - fx) * corner(y0i, x0i)
                       + fx * corner(y0i, x0i + 1))
           + fy * ((1 - fx) * corner(y0i + 1, x0i)
                   + fx * corner(y0i + 1, x0i + 1)))
    # integer inputs round, as OpenCV's warp does (a cast would truncate)
    if not images.dtype.is_floating_point:
        return torch.round(out).to(images.dtype)
    return out.to(images.dtype)


def flip_batch(images: torch.Tensor, flip_v: torch.Tensor,
               flip_h: torch.Tensor) -> torch.Tensor:
    """Per-sample flips of (N, H, W, ...) with boolean flag vectors."""
    expand = (slice(None),) + (None,) * (images.ndim - 1)
    out = torch.where(flip_v[expand], images.flip(1), images)
    return torch.where(flip_h[expand], out.flip(2), out)


def repeat_channels(x: torch.Tensor, n: int = 3) -> torch.Tensor:
    """Repeat the channel axis *n* times: ``n`` is the repeat factor, as in
    the host ``transform.RepeatChannels`` (a C=3 input becomes 9 channels),
    so toggling device augmentation keeps the model's input shape."""
    return torch.repeat_interleave(x, n, dim=-1)


def make_device_augment(rotation_limit: Optional[float] = None,
                        rotation_probability: float = 1.0,
                        flip_vertical: bool = False,
                        flip_horizontal: bool = False,
                        flip_probability: float = 1.0,
                        channel_repeats: Optional[int] = None,
                        mask_keys: Sequence[str] = ("mask", "distance_map"),
                        fill: float = 0.0, mask_fill: float = 0.0
                        ) -> Callable:
    """Compose the standard train-time chain into ``(generator, batch) ->
    batch``.

    Applied inside the train step per fragment; geometry draws are shared
    between ``x`` and the mask columns, and the flip semantics match the
    host ``RandomFlip`` (albumentations ``Flip``: with probability p, pick
    one of {both, vertical, horizontal} when both directions are on).
    """

    def augment(generator: Optional[torch.Generator],
                batch: Dict[str, torch.Tensor]):
        batch = dict(batch)
        x = batch["x"]
        n, device = x.shape[0], x.device

        def uniform(size):
            return torch.rand(size, generator=generator, device=device)

        if rotation_limit:
            angles = (uniform((n,)) * 2 - 1) * rotation_limit
            if rotation_probability < 1.0:
                gate = uniform((n,)) < rotation_probability
                angles = torch.where(gate, angles, torch.zeros_like(angles))
            x = rotate_batch(x, angles, fill=fill)
            for key in mask_keys:
                mask = batch.get(key)
                if mask is not None and mask.ndim >= 3:
                    squeeze = mask.ndim == 3
                    m = mask[..., None] if squeeze else mask
                    # nearest by column name, like the host joint
                    # transforms (a cast mask is still a mask)
                    m = rotate_batch(m, angles, fill=mask_fill,
                                     nearest=True).to(mask.dtype)
                    batch[key] = m[..., 0] if squeeze else m

        if flip_vertical or flip_horizontal:
            gate = uniform((n,)) < flip_probability
            if flip_vertical and flip_horizontal:
                # albumentations Flip codes: -1 both, 0 vertical, 1 horiz.
                code = torch.randint(-1, 2, (n,), generator=generator,
                                     device=device)
                fv, fh = gate & (code <= 0), gate & (code != 0)
            elif flip_vertical:
                fv, fh = gate, torch.zeros_like(gate)
            else:
                fv, fh = torch.zeros_like(gate), gate
            x = flip_batch(x, fv, fh)
            for key in mask_keys:
                mask = batch.get(key)
                if mask is not None and mask.ndim >= 3:
                    batch[key] = flip_batch(mask, fv, fh)

        if channel_repeats:
            x = repeat_channels(x, channel_repeats)
        batch["x"] = x
        return batch

    return augment


# ---------------------------------------------------------------------------
# the classification pretraining chain
# ---------------------------------------------------------------------------

def _between(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``lo + u (hi - lo)`` in float32 as ``jax.random.uniform`` maps its
    [0, 1) draws *u* (the bounds rounded to float32 first)."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    return u * float(hi32 - lo32) + float(lo32)


def _bilinear_axis(img: torch.Tensor, coords: torch.Tensor,
                   dim: int) -> torch.Tensor:
    """Resample (N, H, W, C) *img* along *dim* (1 or 2) at per-sample
    float *coords* (N, out), edge pixels clamped: one axis at a time, so
    the intermediate is (N, out, W, C)."""
    size = img.shape[dim]
    lo = torch.floor(coords)
    frac = coords - lo
    i0 = lo.long().clamp(0, size - 1)
    i1 = (i0 + 1).clamp(max=size - 1)
    shape = [img.shape[0], 1, 1, 1]
    shape[dim] = coords.shape[1]
    frac = frac.reshape(shape)
    index_shape = list(img.shape)
    index_shape[dim] = coords.shape[1]

    def take(index):
        return torch.gather(img, dim, index.reshape(shape).expand(
            index_shape))
    return (1 - frac) * take(i0) + frac * take(i1)


def random_resized_crop_batch(images: torch.Tensor, out_size: int,
                              u_area: torch.Tensor, u_ratio: torch.Tensor,
                              u_top: torch.Tensor, u_left: torch.Tensor,
                              scale=(0.08, 1.0),
                              ratio=(3 / 4, 4 / 3)) -> torch.Tensor:
    """Per-sample RandomResizedCrop of (N, H, W, C) to (out_size,
    out_size), bilinear with half-pixel centres, from uniform draws (N,)
    in [0, 1): the area fraction, the log aspect ratio, and the box's top
    and left within the room left.  An integer image rounds back."""
    n, h, w, _ = images.shape
    area = h * w * _between(u_area, *scale)
    aspect = torch.exp(_between(u_ratio, math.log(ratio[0]),
                                math.log(ratio[1])))
    cw = torch.clamp(torch.sqrt(area * aspect), 1.0, w)
    ch = torch.clamp(torch.sqrt(area / aspect), 1.0, h)
    top = u_top * (h - ch)
    left = u_left * (w - cw)
    centers = torch.arange(out_size, dtype=torch.float32,
                           device=images.device) + 0.5
    sy = top[:, None] + centers[None] * (ch[:, None] / out_size) - 0.5
    sx = left[:, None] + centers[None] * (cw[:, None] / out_size) - 0.5
    out = _bilinear_axis(_bilinear_axis(images.to(torch.float32), sy, 1),
                         sx, 2)
    if not images.dtype.is_floating_point:
        return torch.round(out).to(images.dtype)
    return out.to(images.dtype)


def _box(h: int, w: int, top, left, bh, bw, device) -> torch.Tensor:
    """(N, H, W) mask of the per-sample boxes [top, top + bh) x [left,
    left + bw)."""
    yy = torch.arange(h, dtype=torch.float32, device=device)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, None, :]
    return ((yy >= top[:, None, None]) & (yy < (top + bh)[:, None, None])
            & (xx >= left[:, None, None]) & (xx < (left + bw)[:, None, None]))


def erase_batch(images: torch.Tensor, gate: torch.Tensor,
                u_area: torch.Tensor, u_ratio: torch.Tensor,
                u_top: torch.Tensor, u_left: torch.Tensor,
                scale=(0.02, 0.33), ratio=(0.3, 3.3),
                value: float = 0.0) -> torch.Tensor:
    """torchvision's RandomErasing per sample: where *gate*, a rectangle
    of the drawn area fraction and aspect ratio, clamped to the image, is
    filled with *value*."""
    n, h, w, _ = images.shape
    area = h * w * _between(u_area, *scale)
    aspect = torch.exp(_between(u_ratio, math.log(ratio[0]),
                                math.log(ratio[1])))
    eh = torch.clamp(torch.sqrt(area / aspect), 1.0, h)
    ew = torch.clamp(torch.sqrt(area * aspect), 1.0, w)
    top = u_top * (h - eh)
    left = u_left * (w - ew)
    hit = (_box(h, w, top, left, eh, ew, images.device)
           & gate[:, None, None])[..., None]
    return torch.where(hit, images.new_full((), value), images)


def mixup_or_cutmix_batch(x: torch.Tensor, labels: torch.Tensor,
                          perm: torch.Tensor, use_mixup: torch.Tensor,
                          lam_mixup: torch.Tensor, cut_gate: torch.Tensor,
                          lam_cutmix: torch.Tensor, u_ry: torch.Tensor,
                          u_rx: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch MixupOrCutMix over the partners ``x[perm]``.  Where
    *use_mixup*: ``(1 - lam) x + lam x2`` with *lam_mixup* (zero where
    the mixup gate was closed); elsewhere, where *cut_gate*, the box of
    half-side ``sqrt(1 - lam_cutmix) / 2`` at the drawn corner takes the
    partner's pixels, and the label mixes by the box's exact area.
    Returns float32 images and the soft labels."""
    n, h, w, _ = x.shape
    x2, y2 = x[perm], labels[perm]
    half = torch.sqrt(1 - lam_cutmix) / 2
    bh = torch.round(torch.clamp(2 * half * h, 0, h))
    bw = torch.round(torch.clamp(2 * half * w, 0, w))
    ry = torch.floor(u_ry * (h - bh + 1))
    rx = torch.floor(u_rx * (w - bw + 1))
    in_box = _box(h, w, ry, rx, bh, bw, x.device) & cut_gate[:, None, None]
    mixed = (in_box.sum(dim=(1, 2)) / (h * w)).to(torch.float32)
    xf, x2f = x.to(torch.float32), x2.to(torch.float32)
    lam4 = lam_mixup[:, None, None, None]
    x_mix = (1 - lam4) * xf + lam4 * x2f
    x_cut = torch.where(in_box[..., None], x2f, xf)
    x_out = torch.where(use_mixup[:, None, None, None], x_mix, x_cut)
    lam_label = torch.where(use_mixup, lam_mixup, mixed)[:, None]
    return x_out, (1 - lam_label) * labels + lam_label * y2


def make_classification_device_augment(
        out_size: int, n_classes: int,
        crop_scale=(0.08, 1.0), crop_ratio=(3 / 4, 4 / 3),
        flip_probability: float = 0.5,
        mixup_switch_probability: float = 0.5,
        mixup_probability: float = 0.8,
        mixup_maximum: float = 1.0,
        cutmix_probability: float = 1.0,
        erasing_probability: float = 0.25) -> Callable:
    """The pretraining train chain as one ``(generator, fragment) ->
    fragment`` for the train step's ``device_augment``: RandomResizedCrop
    -> horizontal flip -> one-hot -> MixupOrCutMix -> RandomErasing on the
    dequantised batch.  Labels come in as class indices (or already
    one-hot) and leave as (N, n_classes) soft labels.  The CutMix area is
    Beta(1, 1), a uniform draw, as in the JAX chain."""

    def augment(generator: Optional[torch.Generator],
                batch: Dict[str, torch.Tensor]):
        batch = dict(batch)
        x = batch["x"]
        n, device = x.shape[0], x.device

        def uniform():
            return torch.rand((n,), generator=generator, device=device)

        x = random_resized_crop_batch(x, out_size, uniform(), uniform(),
                                      uniform(), uniform(),
                                      scale=crop_scale, ratio=crop_ratio)
        no_flip = torch.zeros((n,), dtype=torch.bool, device=device)
        x = flip_batch(x, no_flip, uniform() < flip_probability)
        label = batch["label"]
        if label.ndim == 1:
            # a scatter, not F.one_hot, which reads the labels' range back
            label = torch.zeros((n, n_classes), dtype=torch.float32,
                                device=device).scatter_(
                                    1, label.long()[:, None], 1.0)
        perm = torch.randperm(n, generator=generator, device=device)
        use_mixup = uniform() < mixup_switch_probability
        lam_mixup = (_between(uniform(), 0.0, mixup_maximum)
                     * (uniform() < mixup_probability))
        cut_gate = uniform() < cutmix_probability
        x, label = mixup_or_cutmix_batch(
            x, label.to(torch.float32), perm, use_mixup, lam_mixup,
            cut_gate, uniform(), uniform(), uniform())
        x = erase_batch(x, uniform() < erasing_probability, uniform(),
                        uniform(), uniform(), uniform())
        batch["x"] = x
        batch["label"] = label
        return batch

    return augment
