"""The reference's training steps and evaluation, in float32.

Three steps of SGD with momentum on the Dice loss from the benchmark's
weights and batches, as the published training does them, and the
COVID-QU metric set of one evaluated batch on the host (numpy, and scipy's
distance transform, imported when the check runs).  The model is the
configuration's architecture module (``portbench/archs/<arch>.py``), which
the caller hands in: its ``shape_of``, ``forward`` and ``drop_rates``.
The stochastic-depth masks are drawn again from the seed the way the
training step's contract fixes them: one generator a step, seeded from
(seed, step, fragment), one (B, 1, 1) uniform draw for each branch of each
block whose rate is above 0, in forward order.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from .ops import Ops

__all__ = ["dice_loss", "step_generator", "draw_keeps", "train_reference",
           "eval_reference", "metric_values", "binary_metrics", "hd95_batch",
           "auroc"]


def dice_loss(prob: torch.Tensor, mask: torch.Tensor, eps: float = 1e-5,
              low: bool = False) -> torch.Tensor:
    """1 - the mean soft Dice of background and foreground over the whole
    batch, with a squared-prediction denominator; its sums rounded to
    bfloat16 (*low*)."""
    p = prob[..., 0]
    y = mask.to(p.dtype)

    def total(t):
        t = t.sum()
        return t.to(torch.bfloat16).to(t.dtype) if low else t
    scores = []
    for pred, target in ((1 - p, 1 - y), (p, y)):
        scores.append((2 * total(pred * target) + eps)
                      / (total(target) + total(pred * pred) + eps))
    return 1 - torch.stack(scores).mean()


def step_generator(seed: int, step: int, fragment: int,
                   device) -> torch.Generator:
    entropy = [int(seed), int(step), int(fragment)]
    value = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(value))


def draw_keeps(arch, shape, seed: int, step: int, batch: int,
               device) -> list:
    """The keep masks of one training step, per block in forward order."""
    rates = arch.drop_rates(shape)
    if not any(rates):
        return None
    gen = step_generator(seed, step, 0, device)
    keeps = []
    for rate in rates:
        if rate == 0.0:
            keeps.append((None, None))
            continue
        pair = tuple(torch.rand((batch, 1, 1), device=device, generator=gen)
                     < 1.0 - rate for _ in range(2))
        keeps.append(pair)
    return keeps


def _leaves(params: Dict[str, torch.Tensor]) -> List[str]:
    return [k for k, v in params.items() if v.is_floating_point()
            and not k.endswith(("running_mean", "running_var"))]


def train_reference(arch, tree: dict, weights: Dict[str, torch.Tensor],
                    batches: List[Dict[str, torch.Tensor]], seed: int,
                    lr: float, momentum: float, precision: str = "float32",
                    ckpt: bool = False) -> dict:
    """Steps of SGD (buffer = first gradient, then m * buffer + g; p -=
    lr * buffer) on *batches* (uint8 ``x`` (B, H, W, C) and ``mask`` (B,
    H, W) on the device) from *weights*, through the model of *arch* and
    *tree*.

    Returns the loss of every step, the norm of every leaf's first
    gradient, the norm of every leaf's change over the steps, and of every
    BatchNorm running statistic's change."""
    shape = arch.shape_of(tree)
    params = {k: v.detach().float().clone().requires_grad_(True)
              for k, v in weights.items() if k in _leaves(weights)}
    running = {k: v.detach().float().clone() for k, v in weights.items()
               if k.endswith(("running_mean", "running_var"))}
    start = {k: v.detach().clone() for k, v in params.items()}
    start_running = {k: v.clone() for k, v in running.items()}
    buffers: Dict[str, torch.Tensor] = {}
    losses, first_grad = [], {}
    names = list(params)
    for step, batch in enumerate(batches):
        x = batch["x"].float() / 255.0
        ops = Ops(precision)
        keeps = draw_keeps(arch, shape, seed, step, x.shape[0], x.device)
        prob = arch.forward(ops, {**params, **running}, x, shape,
                            train=True, keeps=keeps, running=running,
                            ckpt=ckpt)
        loss = dice_loss(prob, batch["mask"])
        ops.record_stats = False
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for name, grad in zip(names, grads):
                if step == 0:
                    first_grad[name] = float(grad.norm())
                    buffers[name] = grad.clone()
                else:
                    buffers[name].mul_(momentum).add_(grad)
                params[name].sub_(lr * buffers[name])
            for layer, (mean, var) in ops.stats.items():
                running[f"{layer}.running_mean"].lerp_(mean, 0.1)
                running[f"{layer}.running_var"].lerp_(var, 0.1)
        del prob, loss, grads
    with torch.no_grad():
        change = {k: float((params[k] - start[k]).norm()) for k in names}
        stats_change = {k: float((running[k] - start_running[k]).norm())
                        for k in running}
    return {"loss": losses, "grad": first_grad, "change": change,
            "stats": stats_change}


# ---------------------------------------------------------------------------
# evaluation: the prediction, the loss and the COVID-QU metric set
# ---------------------------------------------------------------------------

def eval_reference(arch, tree: dict, weights: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor],
                   precision: str = "float32") -> dict:
    """The eval-mode forward of one batch, its loss and metrics.  The
    control (``precision="fp8"``) computes its metrics in bfloat16, the
    step below the float32 the metrics are stated in."""
    shape = arch.shape_of(tree)
    params = {k: v.float() for k, v in weights.items()
              if v.is_floating_point()}
    with torch.no_grad():
        x = batch["x"].float() / 255.0
        prob = arch.forward(Ops(precision), params, x, shape, train=False,
                            running=params)
    values = metric_values(prob[..., 0].float().cpu().numpy(),
                           batch["mask"].cpu().numpy().astype(bool),
                           low=precision != "float32")
    return {"prediction": prob[..., 0].float(), "values": values}


def _rounded(x, low: bool):
    """*x* (numpy) as bfloat16 rounds it, where *low*."""
    if not low:
        return x
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def metric_values(prob: np.ndarray, mask: np.ndarray,
                  low: bool = False) -> Dict[str, float]:
    """The Dice loss and the COVID-QU metric set of (B, H, W)
    probabilities against boolean masks, in float64, or with sums,
    counts, distances and scores rounded to bfloat16 (*low*)."""
    values = {"loss": float(dice_loss(
        torch.from_numpy(np.asarray(prob, np.float64))[..., None],
        torch.from_numpy(np.asarray(mask)), low=low))}
    pred = prob >= 0.5
    values.update(binary_metrics(pred, mask, low))
    values["hd95"] = hd95_batch(pred, mask, low)
    values["auroc"] = auroc(_rounded(prob, low).reshape(-1),
                            mask.reshape(-1), low)
    return values


def binary_metrics(pred: np.ndarray, mask: np.ndarray,
                   low: bool = False) -> Dict[str, float]:
    """Dice and Jaccard (smoothing 1) and MCC of the pooled confusion
    matrix; an undefined value takes the neutral one (1, 1, 0)."""
    counts = _rounded([np.sum(pred & mask), np.sum(pred & ~mask),
                       np.sum(~pred & mask), np.sum(~pred & ~mask)], low)
    tp, fp, fn, tn = (float(c) for c in counts)
    dice = (2 * tp + 1) / (2 * tp + fp + fn + 1) if tp + fp + fn else 1.0
    jaccard = (tp + 1) / (tp + fp + fn + 1) if tp + fp + fn else 1.0
    denom = (tp + fn) * (tp + fp) * (tn + fp) * (tn + fn)
    mcc = (tp * tn - fp * fn) / math.sqrt(denom) if denom else 0.0
    return {"dice": dice, "jaccard": jaccard, "mcc": mcc}


def _border(mask: np.ndarray) -> np.ndarray:
    from scipy import ndimage
    cross = ndimage.generate_binary_structure(2, 1)
    return mask & ~ndimage.binary_erosion(mask, cross, border_value=0)


def hd95_batch(pred: np.ndarray, mask: np.ndarray, low: bool = False) -> float:
    """Mean over the samples where both masks have pixels of the 95th
    percentile (linear) of the symmetric border-to-border distances."""
    from scipy import ndimage
    values = []
    for p, t in zip(pred, mask):
        if not p.any() or not t.any():
            continue
        pb, tb = _border(p), _border(t)
        to_true = _rounded(ndimage.distance_transform_edt(~tb)[pb], low)
        to_pred = _rounded(ndimage.distance_transform_edt(~pb)[tb], low)
        values.append(np.percentile(np.concatenate([to_true, to_pred]), 95))
    return float(np.mean(values)) if values else 0.0


def _average_ranks(values: np.ndarray) -> np.ndarray:
    """1-based ranks, ties taking the mean of the ranks they span."""
    _, inverse, counts = np.unique(values, return_inverse=True,
                                   return_counts=True)
    last = np.cumsum(counts)
    return ((last - counts + 1 + last) / 2.0)[inverse]


def auroc(scores: np.ndarray, labels: np.ndarray, low: bool = False) -> float:
    """Area under the ROC curve from tie-averaged ranks (Mann-Whitney),
    with the counts and the positives' rank sum rounded to bfloat16
    (*low*)."""
    labels = labels.astype(bool)
    pos = float(labels.sum())
    neg = float(labels.size) - pos
    if pos == 0 or neg == 0:
        return 0.0
    ranks = _average_ranks(scores.astype(np.float64))
    pos, neg, rank_sum = (float(v) for v in _rounded(
        [pos, neg, ranks[labels].sum()], low))
    u = rank_sum - pos * (pos + 1) / 2
    return float(u / (pos * neg))
