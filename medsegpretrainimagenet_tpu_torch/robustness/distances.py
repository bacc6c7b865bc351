"""Distance functions over batched representations: the port of
``robustness/distances.py``.  Each takes two (N, D) tensors and returns the
(N,) per-sample distances as plain reductions over the feature axis."""
from __future__ import annotations

import torch

__all__ = ["l2_loss", "inv_pearson_corr", "cosine_distance", "DISTANCES"]


def l2_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return ((x - y) ** 2).mean(dim=1)


def inv_pearson_corr(xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    xc = xs - xs.mean(dim=1, keepdim=True)
    yc = ys - ys.mean(dim=1, keepdim=True)
    num = (xc * yc).sum(dim=1)
    den = torch.sqrt((xc ** 2).sum(dim=1) * (yc ** 2).sum(dim=1))
    return 1 - num / den


def cosine_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return 1 - (x * y).sum(dim=1) / torch.sqrt(
        (x ** 2).sum(dim=1) * (y ** 2).sum(dim=1))


DISTANCES = {"cosine_distance": cosine_distance,
             "l2": l2_loss,
             "l2_loss": l2_loss,
             "inv_pearson": inv_pearson_corr,
             "inv_pearson_corr": inv_pearson_corr}
