"""Surface-distance and overlap metrics with medpy's API (host-side).

The port of ``metrics/surface.py`` (the reference's vendored medpy code,
``metrics/medpy_metrics.py``): ``dc``, ``jc``, ``precision``, ``recall``,
``sensitivity``, ``specificity``, ``true_negative_rate``,
``true_positive_rate``, ``positive_predictive_value``, ``hd``, ``hd95``,
``assd``, ``asd``, ``ravd``, ``volume_correlation``,
``volume_change_correlation`` and the object-correspondence family
``obj_assd`` / ``obj_asd`` / ``obj_fpr`` / ``obj_tpr``.  Only ``hd95`` is
on the training path (as ``metrics/hd95.py``'s spec); these are the
analysis API, arrays in and floats out.

The distance transform and the borders are the port's own
(:func:`.hd95.edt`, :func:`.hd95.object_border`), run on CPU tensors,
anisotropic ``voxelspacing`` included; the rest is numpy with medpy's
semantics (``numpy.percentile``'s linear interpolation).  The Pearson
p-value and the connected-component labelling use scipy, imported when
called (a numpy flood fill stands in for the labelling without it).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .hd95 import _structure_offsets, edt, object_border

__all__ = [
    "dc", "jc", "precision", "recall", "sensitivity", "specificity",
    "true_negative_rate", "true_positive_rate", "positive_predictive_value",
    "hd", "hd95", "assd", "asd", "ravd",
    "volume_correlation", "volume_change_correlation",
    "obj_assd", "obj_asd", "obj_fpr", "obj_tpr",
    "object_border", "surface_distances", "connected_components",
]


def _binary(x) -> np.ndarray:
    return np.atleast_1d(np.asarray(x)).astype(bool)


# ---------------------------------------------------------------------------
# overlap metrics (medpy_metrics.py:38-309)
# ---------------------------------------------------------------------------

def _counts(result, reference) -> Tuple[float, ...]:
    r = _binary(result).reshape(-1)
    g = _binary(reference).reshape(-1)
    return tuple(float(np.count_nonzero(v))
                 for v in (r & g, r, g, r | g, ~r & ~g))


def dc(result, reference) -> float:
    """Dice coefficient 2|A∩B| / (|A|+|B|) (medpy_metrics.py:38); both
    empty gives 0.0 (the reference catches the zero division)."""
    tp, n_r, n_g, _, _ = _counts(result, reference)
    return 2.0 * tp / (n_r + n_g) if n_r + n_g else 0.0


def jc(result, reference) -> float:
    """Jaccard coefficient |A∩B| / |A∪B| (medpy_metrics.py:87); an empty
    union raises ZeroDivisionError like the reference."""
    tp, _, _, union, _ = _counts(result, reference)
    return tp / union


def precision(result, reference) -> float:
    """TP / (TP + FP), empty result -> 0.0 (medpy_metrics.py:122)."""
    tp, n_r, _, _, _ = _counts(result, reference)
    return tp / n_r if n_r else 0.0


def recall(result, reference) -> float:
    """TP / (TP + FN), empty reference -> 0.0 (medpy_metrics.py:169)."""
    tp, _, n_g, _, _ = _counts(result, reference)
    return tp / n_g if n_g else 0.0


def sensitivity(result, reference) -> float:
    """Alias of :func:`recall` (medpy_metrics.py:216)."""
    return recall(result, reference)


def specificity(result, reference) -> float:
    """TN / (TN + FP), no negatives -> 0.0 (medpy_metrics.py:227)."""
    _, n_r, n_g, union, tn = _counts(result, reference)
    total = tn + (n_r - (n_r + n_g - union))  # TN + FP
    return tn / total if total else 0.0


def true_negative_rate(result, reference) -> float:
    """Alias of :func:`specificity` (medpy_metrics.py:274)."""
    return specificity(result, reference)


def true_positive_rate(result, reference) -> float:
    """Alias of :func:`recall` (medpy_metrics.py:286)."""
    return recall(result, reference)


def positive_predictive_value(result, reference) -> float:
    """Alias of :func:`precision` (medpy_metrics.py:298)."""
    return precision(result, reference)


def ravd(result, reference) -> float:
    """Relative absolute volume difference (|R|-|G|)/|G|
    (medpy_metrics.py:569); an empty reference raises RuntimeError."""
    _, n_r, n_g, _, _ = _counts(result, reference)
    if n_g == 0:
        raise RuntimeError(
            "The second supplied array does not contain any binary object.")
    return (n_r - n_g) / n_g


# ---------------------------------------------------------------------------
# surface distances (medpy_metrics.py:310-568, 1199-1231)
# ---------------------------------------------------------------------------

def surface_distances(result, reference, voxelspacing=None,
                      connectivity: int = 1) -> np.ndarray:
    """Distances from every surface voxel of ``result`` to the nearest
    surface voxel of ``reference`` (medpy_metrics.py:1199, the directed
    building block of hd, hd95, asd and assd).  Raises RuntimeError when
    either input is empty, like the reference."""
    result, reference = _binary(result), _binary(reference)
    if not result.any():
        raise RuntimeError(
            "The first supplied array does not contain any binary object.")
    if not reference.any():
        raise RuntimeError(
            "The second supplied array does not contain any binary object.")
    rb = object_border(torch.from_numpy(result), connectivity).numpy()
    gb = object_border(torch.from_numpy(reference), connectivity)
    dt = edt(gb, voxelspacing).numpy()
    return dt[rb]


def hd(result, reference, voxelspacing=None, connectivity: int = 1) -> float:
    """Symmetric Hausdorff distance: the larger of the two directed
    maxima (medpy_metrics.py:310)."""
    d1 = surface_distances(result, reference, voxelspacing, connectivity)
    d2 = surface_distances(reference, result, voxelspacing, connectivity)
    return float(max(d1.max(), d2.max()))


def hd95(result, reference, voxelspacing=None,
         connectivity: int = 1) -> float:
    """95th percentile of the symmetric surface distances
    (medpy_metrics.py:358); the training step's version is
    :class:`.hd95.HD95Spec`."""
    d1 = surface_distances(result, reference, voxelspacing, connectivity)
    d2 = surface_distances(reference, result, voxelspacing, connectivity)
    return float(np.percentile(np.hstack((d1, d2)), 95))


def asd(result, reference, voxelspacing=None,
        connectivity: int = 1) -> float:
    """Directed average surface distance (medpy_metrics.py:460)."""
    return float(surface_distances(result, reference, voxelspacing,
                                   connectivity).mean())


def assd(result, reference, voxelspacing=None,
         connectivity: int = 1) -> float:
    """Average symmetric surface distance: the mean of the two directed
    ``asd`` values (medpy_metrics.py:406)."""
    return float(np.mean((asd(result, reference, voxelspacing, connectivity),
                          asd(reference, result, voxelspacing,
                              connectivity))))


# ---------------------------------------------------------------------------
# volume correlations (medpy_metrics.py:656-726)
# ---------------------------------------------------------------------------

def _pearson(x: np.ndarray, y: np.ndarray) -> Tuple[float, float]:
    """(r, two-sided p) of Pearson's correlation, the
    ``scipy.stats.pearsonr`` contract: p from the t distribution through
    the regularised incomplete beta function."""
    from scipy.special import betainc
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    xm, ym = x - x.mean(), y - y.mean()
    r = float(np.clip(np.sum(xm * ym)
                      / np.sqrt(np.sum(xm ** 2) * np.sum(ym ** 2)),
                      -1.0, 1.0))
    df = x.shape[0] - 2
    if df <= 0:
        # with two points r is +-1 by construction and p is 1
        return r, 1.0
    if abs(r) >= 1.0:
        return r, 0.0
    # p = I_{df/(df+t^2)}(df/2, 1/2), and df/(df+t^2) = 1 - r^2
    return r, float(betainc(df / 2.0, 0.5, min(max(1.0 - r * r, 0.0), 1.0)))


def _volumes(arrays) -> np.ndarray:
    stack = np.atleast_2d(np.array(arrays).astype(bool))
    return np.asarray([np.count_nonzero(a) for a in stack], np.float64)


def volume_correlation(results, references) -> Tuple[float, float]:
    """Pearson (r, p) between per-image binary volumes
    (medpy_metrics.py:656)."""
    return _pearson(_volumes(results), _volumes(references))


def volume_change_correlation(results, references) -> Tuple[float, float]:
    """Pearson (r, p) between successive volume changes
    (medpy_metrics.py:690)."""
    return _pearson(np.diff(_volumes(results)), np.diff(_volumes(references)))


# ---------------------------------------------------------------------------
# object-correspondence family (medpy_metrics.py:727-1198)
# ---------------------------------------------------------------------------

def _ndimage():
    try:
        from scipy import ndimage
    except ImportError:
        return None
    return ndimage


def connected_components(mask, connectivity: int = 1
                         ) -> Tuple[np.ndarray, int]:
    """Label the distinct binary objects (scipy ``label`` with the
    connectivity-*c* structure; a flood fill in C-scan order, which labels
    the same way, where scipy is missing)."""
    mask = _binary(mask)
    ndi = _ndimage()
    if ndi is not None:
        structure = ndi.generate_binary_structure(mask.ndim, connectivity)
        labels, n = ndi.label(mask, structure=structure)
        return labels.astype(np.int32, copy=False), int(n)
    offsets = _structure_offsets(mask.ndim, connectivity)
    labels = np.zeros(mask.shape, np.int32)
    current = 0
    for seed in zip(*np.nonzero(mask)):
        if labels[seed]:
            continue
        current += 1
        labels[seed] = current
        stack = [seed]
        while stack:
            p = stack.pop()
            for off in offsets:
                q = tuple(pi + oi for pi, oi in zip(p, off))
                if all(0 <= qi < s for qi, s in zip(q, mask.shape)) \
                        and mask[q] and not labels[q]:
                    labels[q] = current
                    stack.append(q)
    return labels, current


def _bounding_windows(labels: np.ndarray, n: int):
    """scipy ``find_objects``: per label, the tuple of bounding slices."""
    ndi = _ndimage()
    if ndi is not None:
        return ndi.find_objects(labels, max_label=n)
    out = []
    for lid in range(1, n + 1):
        pos = np.nonzero(labels == lid)
        out.append(tuple(slice(int(p.min()), int(p.max()) + 1)
                         for p in pos))
    return out


def _object_correspondences(reference, result, connectivity: int = 1):
    """``__distinct_binary_object_correspondences`` (medpy_metrics.py:1145):
    labels the objects of both inputs and maps labels of ``reference`` one
    to one onto overlapping labels of ``result`` (one voxel suffices),
    unambiguous overlaps first, then the one-to-many cases greedily,
    shortest candidate set first with a set-order pick.  Returns
    ``(labels(result), labels(reference), n_result, n_reference,
    mapping)``; the callers' argument swaps are the reference's."""
    labels1, n1 = connected_components(result, connectivity)
    labels2, n2 = connected_components(reference, connectivity)
    windows = _bounding_windows(labels2, n2)
    mapping: dict = {}
    used: set = set()
    ambiguous = []
    for ref_id, window in enumerate(windows, start=1):
        inside = labels2[window] == ref_id
        res_ids = np.unique(labels1[window][inside])
        res_ids = res_ids[res_ids != 0]
        if len(res_ids) == 1:
            res_id = int(res_ids[0])
            if res_id not in used:
                mapping[ref_id] = res_id
                used.add(res_id)
        elif len(res_ids) > 1:
            ambiguous.append((ref_id, set(int(i) for i in res_ids)))
    while True:
        ambiguous = [(rid, cands - used) for rid, cands in ambiguous]
        ambiguous = sorted((a for a in ambiguous if a[1]),
                           key=lambda a: len(a[1]))
        if not ambiguous:
            break
        ref_id, cands = ambiguous[0]
        res_id = cands.pop()   # set-order pick, like the reference
        mapping[ref_id] = res_id
        used.add(res_id)
        ambiguous = ambiguous[1:]
    return labels1, labels2, n1, n2, mapping


def _merge_windows(w1, w2):
    return tuple(slice(min(a.start, b.start), max(a.stop, b.stop))
                 for a, b in zip(w1, w2))


def obj_asd(result, reference, voxelspacing=None,
            connectivity: int = 1) -> float:
    """Directed average surface distance over corresponding object pairs
    only (medpy_metrics.py:782): unmatched objects are left out, and the
    distances pool over all matched pairs before the mean.  The argument
    plumbing (which side is labelled as the reference in the
    correspondence, and which object of a pair the distances start from)
    is the reference's, medpy_metrics.py:913-921."""
    labels1, labels2, _, _, mapping = _object_correspondences(
        result, reference, connectivity)
    windows1 = _bounding_windows(labels1, int(labels1.max()))
    windows2 = _bounding_windows(labels2, int(labels2.max()))
    pooled = []
    for lid2, lid1 in mapping.items():
        window = _merge_windows(windows1[lid1 - 1], windows2[lid2 - 1])
        object1 = labels1[window] == lid1
        object2 = labels2[window] == lid2
        pooled.extend(surface_distances(object1, object2, voxelspacing,
                                        connectivity))
    return float(np.mean(pooled))


def obj_assd(result, reference, voxelspacing=None,
             connectivity: int = 1) -> float:
    """Symmetric :func:`obj_asd` (medpy_metrics.py:727)."""
    return float(np.mean((obj_asd(result, reference, voxelspacing,
                                  connectivity),
                          obj_asd(reference, result, voxelspacing,
                                  connectivity))))


def obj_fpr(result, reference, connectivity: int = 1) -> float:
    """Share of unmatched ('false positive') objects
    (medpy_metrics.py:924, call wiring at :1032)."""
    _, _, _, n_obj_reference, mapping = _object_correspondences(
        reference, result, connectivity)
    return (n_obj_reference - len(mapping)) / float(n_obj_reference)


def obj_tpr(result, reference, connectivity: int = 1) -> float:
    """Share of matched ('true positive') objects
    (medpy_metrics.py:1035, call wiring at :1142)."""
    _, _, n_obj_result, _, mapping = _object_correspondences(
        reference, result, connectivity)
    return len(mapping) / float(n_obj_result)
