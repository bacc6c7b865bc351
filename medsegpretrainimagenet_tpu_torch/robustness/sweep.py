"""The robustness sweep: the port of ``robustness/sweep.py``.

The reference publishes ``results/robustness_scores.csv`` (dataset x metric
x margin x encoder x scheme x pooled x level x pretraining_length ->
robustness) but ships no code that writes it.  ``run_sweep`` walks the
cartesian product of probe settings for a set of encoders and emits rows
with the same columns, in the JAX package's order;
``write_scores_csv`` serialises them.

Every encoder of a dataset sees the same two jittered views: the draws
depend only on (seed, dataset index).  The activations of an (encoder,
dataset) stay on the encoder's device; its cells' means are gathered there
and read back once.
"""
from __future__ import annotations

import csv
import itertools
import warnings
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np
import torch

from .distances import DISTANCES
from .eval import (JitterDraws, Robustness, apply_color_jitter,
                   collect_levels, jitter_draws, pool_spatial)

__all__ = ["run_sweep", "write_scores_csv", "adapt_channels",
           "dataset_draws", "CSV_COLUMNS"]

CSV_COLUMNS = ("dataset", "metric", "margin", "encoder",
               "pretraining_scheme", "pooled", "level",
               "pretraining_length", "robustness")


def dataset_draws(seed: int, ds_index: int) -> Sequence[JitterDraws]:
    """The two views' jitter draws of dataset number *ds_index*: a
    generator seeded from (seed, ds_index) alone."""
    state = np.random.SeedSequence([seed, ds_index]).generate_state(1)
    generator = torch.Generator().manual_seed(int(state[0]))
    return jitter_draws(generator), jitter_draws(generator)


def run_sweep(encoders: Sequence[Dict[str, Any]],
              datasets: Dict[str, Any],
              metrics: Iterable[str] = ("cosine_distance", "l2",
                                        "inv_pearson"),
              margins: Iterable[float] = (0.0, 0.5),
              levels: Iterable[int] = (1, 2, 3, 4),
              pooled: Iterable[bool] = (False, True),
              batch_size: int = 32, seed: int = 0,
              draws: Optional[Mapping[str, Sequence[JitterDraws]]] = None
              ) -> List[Dict[str, Any]]:
    """Score every (encoder, dataset, metric, margin, level, pooled) cell.

    ``encoders``: dicts with ``module`` (on the device the sweep runs on)
    and the metadata keys ``name`` / ``pretraining_scheme`` /
    ``pretraining_length``, optionally ``method`` (a forward returning
    ``(final, skips)``) and ``in_channels`` to adapt the shared probe
    images to the encoder's input channel count.
    ``datasets``: name -> NHWC array of probe images in [0, 1].
    ``draws``: name -> the two views' :class:`JitterDraws`, in place of
    :func:`dataset_draws` (the tests inject the JAX package's).
    Returns one row dict per cell with the mean margin score.
    """
    metrics, margins, levels, pooled = (list(metrics), list(margins),
                                        list(levels), list(pooled))
    rows: List[Dict[str, Any]] = []
    device = next(encoders[0]["module"].parameters()).device \
        if encoders else torch.device("cpu")
    for ds_index, (ds_name, imgs) in enumerate(datasets.items()):
        views_draws = draws[ds_name] if draws is not None \
            else dataset_draws(seed, ds_index)
        imgs_f = torch.as_tensor(np.asarray(imgs, np.float32), device=device)
        jittered = [apply_color_jitter(imgs_f, d) for d in views_draws]
        for encoder in encoders:
            # the activations depend on none of the (metric, margin, level,
            # pool) axes: run the two views once per (encoder, dataset).
            # The channel count is adapted per encoder after the shared
            # jitter, so 1- and 3-channel encoders see the same content
            views = [
                collect_levels(encoder["module"],
                               adapt_channels(v, encoder.get("in_channels")),
                               batch_size=batch_size,
                               method=encoder.get("method"))
                for v in jittered]
            _score_cells(rows, ds_name, encoder, views, metrics, margins,
                         levels, pooled)
    return rows


def adapt_channels(imgs: torch.Tensor, want: Optional[int]) -> torch.Tensor:
    """Match probe images to an encoder's input channel count.

    Grayscale probes repeat up to ``want`` channels (the readers'
    ``RepeatChannels``); multi-channel probes collapse to grayscale by mean
    for 1-channel encoders.  ``want=None`` leaves the images unchanged."""
    have = imgs.shape[-1]
    if not want or have == want:
        return imgs
    if have == 1:
        return imgs.repeat_interleave(int(want), dim=-1)
    if want == 1:
        return imgs.mean(dim=-1, keepdim=True)
    raise ValueError(f"cannot adapt {have}-channel probe images to a "
                     f"{want}-channel encoder")


def _score_cells(rows, ds_name, encoder, views, metrics, margins, levels,
                 pooled) -> None:
    # encoders differ in depth (the reference CSV has 4 swin levels vs 5
    # for resnet50/u-net): levels beyond this encoder's [*skips, final]
    # list are skipped for it, not an error
    n_levels = len(views[0])
    available = [lv for lv in levels if -n_levels <= lv < n_levels]
    dropped = [lv for lv in levels if lv not in available]
    if dropped:
        warnings.warn(
            f"encoder {encoder.get('name', 'encoder')!r} has {n_levels} "
            f"activation levels; skipping requested levels {dropped}",
            stacklevel=3)
    # pos - neg depends on (metric, level, pool), not on the margin
    differences = {}
    means = []
    cells = list(itertools.product(metrics, margins, available, pooled))
    for metric, margin, level, pool in cells:
        key = (metric, level, pool)
        if key not in differences:
            p0, p1 = (pool_spatial(v[level]) if pool else v[level]
                      for v in views)
            differences[key] = Robustness(DISTANCES[metric]).difference(
                p0, p1)
        means.append(torch.clamp(differences[key] + margin, min=0.0).mean())
    if not cells:
        return
    # one read of the card for all of this (encoder, dataset)'s cells
    values = torch.stack(means).double().cpu().tolist()
    for (metric, margin, level, pool), value in zip(cells, values):
        rows.append({
            "dataset": ds_name,
            "metric": metric,
            "margin": margin,
            "encoder": encoder.get("name", "encoder"),
            "pretraining_scheme": encoder.get("pretraining_scheme", "none"),
            "pooled": pool,
            "level": level,
            "pretraining_length": encoder.get("pretraining_length", 0),
            "robustness": value,
        })


def write_scores_csv(path: str, rows: Iterable[Dict[str, Any]]) -> None:
    with open(path, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=CSV_COLUMNS)
        writer.writeheader()
        for row in rows:
            writer.writerow(row)
