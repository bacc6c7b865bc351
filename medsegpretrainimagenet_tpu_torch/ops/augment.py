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
  flip, channel repeat) as one ``(generator, fragment) -> fragment``.

The draws come from the step's ``torch.Generator`` on the fragment's device,
so they queue no host sync.  JAX draws with threefry and torch with Philox:
the same seed gives other angles in the two packages, the same angles give
the same images.  The classification chain
(``make_classification_device_augment``) is ROADMAP queue M9.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

__all__ = ["rotate_batch", "flip_batch", "repeat_channels",
           "make_device_augment"]


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
