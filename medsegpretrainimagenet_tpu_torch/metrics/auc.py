"""AUROC and average precision as exact, sort-based tensor operations.

The port of ``metrics/auc.py`` (the reference's ``metrics.py:372-450``):
per-batch values from one sort per batch, AUROC from tie-averaged ranks
(Mann-Whitney U, sklearn's trapezoid value) and AP from tie-grouped
cumulative precision (sklearn's step-wise sum).  The epoch column is the
reference's mean of the per-batch values over batches with both classes;
the extra ``<name>_pooled`` column is the whole epoch's score from score
histograms of ``N_BINS`` exact integer bins, kept on the device as two int32
words per bin.

No host sync and no segment sum: a tie group's bounds come from binary
searches of the sorted scores for themselves, its average rank is their
mean and its positive count a difference of cumulative counts, so the
values do not depend on the order within a tie and every operation has a
deterministic CUDA path.  Rank and precision sums run in float64 (the JAX
package sums in float32; a rank sum over 16 x 256 x 256 pixels reaches
5e11, where float32 rounding would make the card and the CPU disagree);
the values are float32.
Labels are 0/1 targets.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .base import MetricSpec

__all__ = ["auroc", "average_precision", "auroc_rows",
           "average_precision_rows", "AUCSpec", "score_histogram",
           "auroc_from_counts", "average_precision_from_counts", "N_BINS"]

N_BINS = 65536


def score_histogram(scores: torch.Tensor, labels: torch.Tensor,
                    n_bins: int = N_BINS, squash: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Positive and negative score-count histograms over [0, 1], int32.

    ``squash`` maps unbounded scores (logits) through a sigmoid first:
    AUROC and AP depend only on the ranking, which a monotone map keeps.
    The counts are one fixed-length ``scatter_add_`` (no ``bincount``,
    which reads its input's extent back to the host)."""
    s = scores.reshape(-1).float()
    if squash:
        s = torch.sigmoid(s)
    y = torch.round(labels.reshape(-1).float()).to(torch.int64)
    idx = torch.clamp((s * n_bins).to(torch.int32), 0, n_bins - 1).long()
    counts = torch.zeros(2 * n_bins, dtype=torch.int64, device=s.device)
    counts.scatter_add_(0, torch.cat([idx, idx + n_bins]),
                        torch.cat([y, 1 - y]))
    return counts[:n_bins].to(torch.int32), counts[n_bins:].to(torch.int32)


def auroc_from_counts(pos: np.ndarray, neg: np.ndarray):
    """Tie-averaged rank AUROC from score histograms (host, numpy)."""
    pos = np.asarray(pos, np.float64)
    neg = np.asarray(neg, np.float64)
    p, n = pos.sum(), neg.sum()
    if p == 0 or n == 0:
        return 0.0, False
    cum_neg_below = np.cumsum(neg) - neg
    u = np.sum(pos * (cum_neg_below + 0.5 * neg))
    return float(u / (p * n)), True


def average_precision_from_counts(pos: np.ndarray, neg: np.ndarray):
    """Tie-grouped AP from score histograms (each bin = one tie group)."""
    pos = np.asarray(pos, np.float64)
    neg = np.asarray(neg, np.float64)
    p, total = pos.sum(), pos.sum() + neg.sum()
    if p == 0 or p == total:
        return 0.0, False
    pos_desc, neg_desc = pos[::-1], neg[::-1]
    tps = np.cumsum(pos_desc)
    fps = np.cumsum(neg_desc)
    precision = tps / np.maximum(tps + fps, 1.0)
    return float(np.sum(pos_desc / p * precision)), True


def _tie_bounds(ascending: torch.Tensor):
    """First and last index of each element's run of equal values, per row
    of an ascending (rows, n) tensor: two binary searches of the row for
    its own values."""
    ascending = ascending.contiguous()
    first = torch.searchsorted(ascending, ascending, side="left")
    last = torch.searchsorted(ascending, ascending, side="right") - 1
    return first, last


def auroc_rows(scores: torch.Tensor, labels: torch.Tensor):
    """Tie-corrected rank AUROC (sklearn's ``roc_auc_score``) of each row of
    (rows, n) scores and 0/1 labels.  Returns (value, valid): valid is
    False where a row's labels are all one class."""
    s = scores.float()
    s_sorted, order = torch.sort(s, dim=-1, stable=True)
    y_sorted = torch.gather(labels, -1, order).double()
    n = s.shape[-1]
    first, last = _tie_bounds(s_sorted)
    avg_rank = (first + last).double() / 2.0 + 1.0
    p = y_sorted.sum(dim=-1)
    neg = n - p
    rank_sum_pos = (avg_rank * y_sorted).sum(dim=-1)
    value = (rank_sum_pos - p * (p + 1) / 2.0) / torch.clamp(p * neg, min=1.0)
    valid = (p > 0) & (neg > 0)
    return torch.where(valid, value, 0.0).float(), valid


def average_precision_rows(scores: torch.Tensor, labels: torch.Tensor):
    """Tie-grouped AP (sklearn's ``average_precision_score``) of each row of
    (rows, n) scores and 0/1 labels."""
    s = scores.float()
    s_sorted, order = torch.sort(s, dim=-1, descending=True, stable=True)
    y_sorted = torch.gather(labels, -1, order).long()
    n = s.shape[-1]
    tps = torch.cumsum(y_sorted, dim=-1)
    first, last = _tie_bounds(-s_sorted)
    rank = torch.arange(1, n + 1, device=s.device)
    is_end = last == rank - 1
    before = torch.where(first > 0, torch.gather(
        tps, -1, torch.clamp(first - 1, min=0)), 0)
    p = tps[..., -1:].double()
    precision = tps.double() / rank
    contrib = torch.where(is_end, (tps - before).double()
                          / torch.clamp(p, min=1.0) * precision, 0.0)
    value = contrib.sum(dim=-1)
    p = p[..., 0]
    valid = (p > 0) & (p < n)
    return torch.where(valid, value, 0.0).float(), valid


def auroc(scores: torch.Tensor, labels: torch.Tensor):
    """AUROC of all of *scores* against *labels*: (value, valid)."""
    value, valid = auroc_rows(scores.reshape(1, -1), labels.reshape(1, -1))
    return value[0], valid[0]


def average_precision(scores: torch.Tensor, labels: torch.Tensor):
    """AP of all of *scores* against *labels*: (value, valid)."""
    value, valid = average_precision_rows(scores.reshape(1, -1),
                                          labels.reshape(1, -1))
    return value[0], valid[0]


class AUCSpec(MetricSpec):
    """Binary AUROC / AP: exact per-batch values; the epoch column is the
    reference's mean over valid batches (``AUC.evaluate_epoch``,
    ``metrics.py:424-432``), plus an extra ``<name>_pooled`` column with
    the epoch's pooled score from the device-side histograms."""

    KINDS = {"area_under_roc": auroc,
             "average_precision_score": average_precision}
    FROM_COUNTS = {"area_under_roc": auroc_from_counts,
                   "average_precision_score": average_precision_from_counts}

    #: carry base of the two-word int32 bin accumulators: one batch adds
    #: less than 2^24 to a bin, so the low word never wraps before its
    #: carry moves to the high word; about 2^60 counts per bin in all
    CARRY = 1 << 30

    def __init__(self, kind: str = "area_under_roc",
                 label_type: str = "mask"):
        if kind not in self.KINDS:
            raise ValueError(f"unknown AUC kind {kind!r}")
        self.name = kind
        self.key = kind
        self.label_type = label_type
        self._fn = self.KINDS[kind]
        self._from_counts = self.FROM_COUNTS[kind]

    def init_state(self, device):
        def zeros():
            return torch.zeros(N_BINS, dtype=torch.int32, device=device)
        return {"pos": zeros(), "pos_hi": zeros(),
                "neg": zeros(), "neg_hi": zeros(),
                "sum": torch.zeros((), dtype=torch.float32, device=device),
                "count": torch.zeros((), dtype=torch.float32, device=device)}

    def _carry_add(self, lo, hi, add):
        lo = lo + add
        carry = torch.div(lo, self.CARRY, rounding_mode="floor")
        return lo - carry * self.CARRY, hi + carry

    def update(self, state, prediction, batch):
        target = batch[self.label_type]
        value, valid = self._fn(prediction, target)
        # squash: the prediction may be logits (final_activation null); the
        # sigmoid keeps the ranking, and N_BINS keeps [0, 1] probabilities
        # (in sigma's [0.5, 0.73] band) finely resolved
        pos, neg = score_histogram(prediction, target, squash=True)
        pos_lo, pos_hi = self._carry_add(state["pos"], state["pos_hi"], pos)
        neg_lo, neg_hi = self._carry_add(state["neg"], state["neg_hi"], neg)
        new_state = {"pos": pos_lo, "pos_hi": pos_hi,
                     "neg": neg_lo, "neg_hi": neg_hi,
                     "sum": state["sum"] + torch.where(valid, value, 0.0),
                     "count": state["count"] + valid.float()}
        return new_state, {self.name: value}

    def finalize(self, host_state) -> Dict[str, float]:
        count = float(host_state["count"])
        epoch = float(host_state["sum"]) / count if count else 0.0

        def rebuild(lo, hi):
            return (np.asarray(hi, np.float64) * self.CARRY
                    + np.asarray(lo, np.float64))
        pooled, _ = self._from_counts(
            rebuild(host_state["pos"], host_state["pos_hi"]),
            rebuild(host_state["neg"], host_state["neg_hi"]))
        return {self.name: epoch, self.name + "_pooled": pooled}
