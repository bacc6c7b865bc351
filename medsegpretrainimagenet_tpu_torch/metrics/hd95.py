"""HD95 (95th-percentile symmetric surface distance) as tensor operations.

The port of ``metrics/hd95.py`` (the reference's ``metrics.py:304-369`` and
its vendored medpy surface distances): borders by a cross-shaped binary
erosion, an exact Euclidean distance transform, the 95th percentile (linear
interpolation) of the symmetric surface distances, samples skipped when
either mask is empty.

Everything runs on the device the masks are on, with no host sync: the EDT
is the exact two-pass separable transform of the JAX package (cumulative
minima along the last axis, a broadcast parabola minimisation along every
other), and the masked percentile is a sort and a gather.  Where JAX maps
one sample at a time (``lax.map``), this module takes a batch of masks at
once and runs every parabola pass over column chunks of at most
``PASS_BUDGET`` bytes: the pass materialises an (n, n, columns) float32
tensor, 64 MiB per 256 x 256 sample and axis.  All arithmetic is the JAX
package's, in float32, so the distances are equal (they are square roots of
integer sums).
"""
from __future__ import annotations

import itertools
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import span
from .base import MetricSpec, threshold_tag

__all__ = ["edt", "edt_batch", "border", "object_border", "hd95_single",
           "hd95_batch", "HD95Spec", "PASS_BUDGET"]

_BIG = 1.0e9

#: bytes of the largest temporary one parabola-pass chunk materialises
PASS_BUDGET = 1 << 28


def _steps(nd: int, spacing) -> tuple:
    if spacing is None:
        return (1.0,) * nd
    return tuple(float(s) for s in np.broadcast_to(
        np.asarray(spacing, dtype=np.float64), (nd,)))


def _last_axis_pass(mask: torch.Tensor, step: float = 1.0) -> torch.Tensor:
    """1-D distance (``step * |Δindex|``) to the nearest True element along
    the last axis, any rank: two cumulative minima, O(n)."""
    n = mask.shape[-1]
    d0 = torch.where(mask, 0.0, _BIG)
    pos = torch.arange(n, dtype=torch.float32, device=mask.device) * step
    fwd = torch.cummin(d0 - pos, dim=-1).values + pos
    bwd = torch.cummin((d0 + pos).flip(-1), dim=-1).values.flip(-1) - pos
    return torch.minimum(fwd, bwd)


def _parabola_pass(d2: torch.Tensor, axis: int, step: float) -> torch.Tensor:
    """Exact 1-D squared-distance transform along *axis* given the squared
    distances of the earlier passes: the lower envelope of the parabolas
    ``d2[k] + (step * (i - k))^2``, a broadcast minimum over column chunks
    of at most PASS_BUDGET bytes."""
    moved = torch.movedim(d2, axis, 0)
    n = moved.shape[0]
    flat = moved.reshape(n, -1)
    pos = torch.arange(n, dtype=torch.float32, device=d2.device) * step
    dk2 = (pos[:, None] - pos[None, :]) ** 2                 # (i, k)
    cols = max(1, PASS_BUDGET // (4 * n * n))
    out = torch.cat([torch.amin(dk2[:, :, None] + flat[None, :, c:c + cols],
                                dim=1)
                     for c in range(0, flat.shape[1], cols)], dim=1)
    return torch.movedim(out.reshape(moved.shape), 0, axis)


def edt_batch(masks: torch.Tensor, nd: int, spacing=None) -> torch.Tensor:
    """:func:`edt` of every mask of a batch: the last *nd* axes of *masks*
    are the spatial ones, the leading axes index the masks."""
    steps = _steps(nd, spacing)
    masks = masks.bool()
    g = _last_axis_pass(masks, steps[-1])
    d2 = torch.clamp(g, max=_BIG) ** 2
    lead = masks.ndim - nd
    for axis in range(nd - 2, -1, -1):
        d2 = _parabola_pass(d2, lead + axis, steps[axis])
    return torch.sqrt(d2)


def edt(mask: torch.Tensor, spacing=None) -> torch.Tensor:
    """Exact Euclidean distance from every element to the nearest True one.

    Boolean tensor of any rank -> float32 distances (an empty mask gives
    huge values).  ``spacing`` is the per-axis element spacing (a scalar or
    one per axis; medpy's ``voxelspacing``), unit by default."""
    return edt_batch(mask[None], mask.ndim, spacing)[0]


def _structure_offsets(nd: int, connectivity: int):
    """Offsets of scipy's ``generate_binary_structure(nd, connectivity)``:
    neighbours within L1 distance <= connectivity (the centre excluded)."""
    return [off for off in itertools.product((-1, 0, 1), repeat=nd)
            if any(off) and sum(abs(o) for o in off) <= connectivity]


def object_border(mask: torch.Tensor, connectivity: int = 1,
                  nd: Optional[int] = None) -> torch.Tensor:
    """1-element border line of the binary objects: ``mask ^ erosion(mask)``
    with scipy's connectivity-*c* structure and a zero boundary
    (medpy_metrics.py:1222-1224).  The last *nd* axes (all by default) are
    spatial; leading ones index masks."""
    mask = mask.bool()
    nd = mask.ndim if nd is None else nd
    padded = F.pad(mask.to(torch.uint8), (1, 1) * nd).bool()
    eroded = mask
    lead = (slice(None),) * (mask.ndim - nd)
    for off in _structure_offsets(nd, connectivity):
        shifted = lead + tuple(slice(1 + o, (-1 + o) or None) for o in off)
        eroded = eroded & padded[shifted]
    return mask & ~eroded


def border(mask: torch.Tensor) -> torch.Tensor:
    """Object border: pixels that do not survive a cross-shaped erosion.
    :func:`object_border` at connectivity 1."""
    return object_border(mask, 1)


def _masked_percentile(values: torch.Tensor, valid: torch.Tensor,
                       q: float) -> torch.Tensor:
    """q-th percentile (linear interpolation) of ``values[valid]`` per row
    of (rows, n) tensors: a sort with +inf padding and a gather, so no
    count reaches the host."""
    flat = torch.where(valid, values, torch.inf)
    ordered = torch.sort(flat, dim=-1).values
    n = valid.sum(dim=-1)
    pos = q / 100.0 * torch.clamp(n - 1, min=0).to(torch.float32)
    lo = torch.floor(pos).long()
    hi = torch.ceil(pos).long()
    frac = pos - lo.to(torch.float32)
    last = flat.shape[-1] - 1
    v_lo = torch.gather(ordered, -1, torch.clamp(lo, 0, last)[..., None])
    v_hi = torch.gather(ordered, -1, torch.clamp(hi, 0, last)[..., None])
    v_lo, v_hi = v_lo[..., 0], v_hi[..., 0]
    return v_lo * (1.0 - frac) + v_hi * frac


def hd95_batch(pred_masks: torch.Tensor, true_masks: torch.Tensor):
    """(hd95, valid) per sample of (B, H, W) binary masks; hd95 is 0 where
    either mask is empty.  Under a profiler the transform runs inside the
    span ``medseg.hd95.edt`` and the percentile inside
    ``medseg.hd95.percentile``."""
    pred_masks, true_masks = pred_masks.bool(), true_masks.bool()
    b = pred_masks.shape[0]
    pb = object_border(pred_masks, 1, nd=2)
    tb = object_border(true_masks, 1, nd=2)
    borders = torch.cat([tb, pb])
    with span("medseg.hd95.edt"):
        dt_true, dt_pred = edt_batch(borders, 2).split(b)
    values = torch.cat([dt_true.reshape(b, -1), dt_pred.reshape(b, -1)], 1)
    valid = torch.cat([pb.reshape(b, -1), tb.reshape(b, -1)], 1)
    with span("medseg.hd95.percentile"):
        value = _masked_percentile(values, valid, 95.0)
    is_valid = true_masks.reshape(b, -1).any(1) & pred_masks.reshape(
        b, -1).any(1)
    return torch.where(is_valid, value, 0.0), is_valid


def hd95_single(pred_mask: torch.Tensor, true_mask: torch.Tensor):
    """(hd95, valid) for one sample of binary (H, W) masks."""
    value, valid = hd95_batch(pred_mask[None], true_mask[None])
    return value[0], valid[0]


def batch_mean_of_valid(values: torch.Tensor, valids: torch.Tensor,
                        dim: int = -1) -> torch.Tensor:
    """Mean of *values* over the valid samples along *dim*, 0 where none
    is valid."""
    num_valid = valids.sum(dim=dim)
    return torch.where(num_valid > 0, values.sum(dim=dim)
                       / torch.clamp(num_valid, min=1), 0.0)


class HD95Spec(MetricSpec):
    """Average HD95 over valid samples (reference
    ``ModifiedHausdorffDistance``): per batch, samples where either mask is
    empty are skipped; the epoch value averages the nonzero batch values."""

    def __init__(self, threshold: float = 0.5, label_type: str = "mask"):
        self.threshold = threshold
        self.label_type = label_type
        tag = threshold_tag(threshold)
        self.name = f"modified_hausdorff_distance_threshold_{tag}"
        self.key = self.name

    def init_state(self, device):
        return {"sum": torch.zeros((), dtype=torch.float32, device=device),
                "count": torch.zeros((), dtype=torch.float32, device=device)}

    def update(self, state, prediction, batch):
        target = batch[self.label_type]
        if prediction.ndim and prediction.shape[-1] == 1:
            prediction = prediction[..., 0]
        target = target.reshape(prediction.shape)
        values, valids = hd95_batch(prediction >= self.threshold,
                                    target.bool())
        batch_value = batch_mean_of_valid(values, valids)
        new_state = {"sum": state["sum"] + batch_value,
                     "count": state["count"] + (batch_value != 0).float()}
        return new_state, {self.name: batch_value}

    def finalize(self, host_state) -> Dict[str, float]:
        count = float(host_state["count"])
        if count == 0:
            return {self.name: 0.0}
        return {self.name: float(host_state["sum"]) / count}
