"""Encoder transferability scoring: the port of ``robustness/eval.py``.

``eval_encoder`` color-jitters the probe images twice, runs the encoder on
both views collecting per-level activations, and scores the selected level
with a shifted-negative margin, ``max(0, d(pos) - d(neg) + margin)``.
Negatives pair each probe of the first view with the second view reversed
and rolled by 2, so that no index of an even batch matches itself.

The color jitter has the semantics of torchvision's ``ColorJitter(0.1,
0.05, 0.1, 0.05)``: one uniform factor per view for the whole batch and a
random order of the four ops.  It is split in two: :func:`jitter_draws`
draws the order and the factors from a ``torch.Generator``, and
:func:`apply_color_jitter` applies given draws on the images' device.  The
JAX package draws with threefry, which no torch generator reproduces, so
the tests feed the second function JAX's own draws.  Images are NHWC, as
the encoders take them; everything after the draws stays on the device.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from .distances import cosine_distance

__all__ = ["Robustness", "predict_w_model", "eval_encoder",
           "apply_color_jitter", "jitter_draws", "JitterDraws",
           "collect_levels", "pool_spatial"]


class Robustness:
    """Margin scorer over two views' representations."""

    def __init__(self, distance_fn: Callable = cosine_distance,
                 margin: float = 0.5):
        self.distance_fn = distance_fn
        self.margin = margin

    def __call__(self, preds0: torch.Tensor,
                 preds1: torch.Tensor) -> torch.Tensor:
        return torch.clamp(self.difference(preds0, preds1) + self.margin,
                           min=0.0)

    def difference(self, preds0: torch.Tensor,
                   preds1: torch.Tensor) -> torch.Tensor:
        """d(pos) - d(neg) per probe, before the margin."""
        qs = preds0.reshape(preds0.shape[0], -1)
        k1 = preds1.reshape(preds1.shape[0], -1)
        # reverse to build negatives, then shift by 2 so the middle pair
        # (which reversal maps onto itself) no longer matches; with an odd
        # N one index still matches itself, as in the reference (the sweep
        # CLI warns on odd probe counts)
        k0 = torch.roll(torch.flip(k1, [0]), 2, 0)
        neg = self.distance_fn(qs, k0)
        pos = self.distance_fn(qs, k1)
        return pos - neg


# ---------------------------------------------------------------------------
# color jitter (torchvision semantics, NHWC)
# ---------------------------------------------------------------------------

class JitterDraws(NamedTuple):
    """One view's jitter: the order of the ops (a permutation of 0
    brightness, 1 contrast, 2 saturation, 3 hue) and their factors."""
    order: Tuple[int, ...]
    brightness: float
    contrast: float
    saturation: float
    hue: float


def jitter_draws(generator: torch.Generator, brightness: float = 0.1,
                 contrast: float = 0.05, saturation: float = 0.1,
                 hue: float = 0.05) -> JitterDraws:
    """Draw one view's order and factors from *generator* (a CPU
    generator: nothing here touches the card): brightness, contrast and
    saturation uniform in [1 - x, 1 + x], hue in [-hue, hue], each rounded
    to float32 as the JAX package draws them."""
    order = tuple(torch.randperm(4, generator=generator).tolist())
    u = torch.rand(4, generator=generator, dtype=torch.float32)
    low = torch.tensor([1 - brightness, 1 - contrast, 1 - saturation, -hue],
                       dtype=torch.float32)
    width = torch.tensor([2 * brightness, 2 * contrast, 2 * saturation,
                          2 * hue], dtype=torch.float32)
    b, c, s, h = (u * width + low).tolist()
    return JitterDraws(order, b, c, s, h)


def _rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb.unbind(-1)
    maxc = rgb.amax(dim=-1)
    minc = rgb.amin(dim=-1)
    v = maxc
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / maxc.clamp_min(1e-12), 0.0)
    safe = delta.clamp_min(1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)      # floor-mod, as jnp's %
    h = torch.where(delta == 0, 0.0, h)
    return torch.stack([h, s, v], dim=-1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    # jnp.choose(i, six planes, mode="clip") with i already in 0..5
    i = torch.remainder(i.to(torch.int32), 6).long().unsqueeze(-1)

    def choose(*planes):
        return torch.stack(planes, dim=-1).gather(-1, i).squeeze(-1)

    return torch.stack([choose(v, q, p, p, t, v), choose(t, v, v, q, p, p),
                        choose(p, p, t, v, v, q)], dim=-1)


def _grayscale(x: torch.Tensor) -> torch.Tensor:
    if x.shape[-1] != 3:
        return x.mean(dim=-1, keepdim=True)
    w = torch.tensor([0.299, 0.587, 0.114], dtype=x.dtype, device=x.device)
    return (x * w).sum(dim=-1, keepdim=True)


def apply_color_jitter(imgs: torch.Tensor,
                       draws: JitterDraws) -> torch.Tensor:
    """One jittered view of an NHWC float batch in [0, 1], from given
    draws.  A 1-channel image has no hue and its saturation op is the
    identity."""
    b, c, s, h = (draws.brightness, draws.contrast, draws.saturation,
                  draws.hue)

    def apply_brightness(x):
        return torch.clamp(x * b, 0.0, 1.0)

    def apply_contrast(x):
        mean = _grayscale(x).mean(dim=(1, 2, 3), keepdim=True)
        return torch.clamp(mean + c * (x - mean), 0.0, 1.0)

    def apply_saturation(x):
        gray = _grayscale(x)
        return torch.clamp(gray + s * (x - gray), 0.0, 1.0)

    def apply_hue(x):
        if x.shape[-1] != 3:
            return x
        hsv = _rgb_to_hsv(x)
        hsv = torch.cat([torch.remainder(hsv[..., :1] + h, 1.0),
                         hsv[..., 1:]], dim=-1)
        return torch.clamp(_hsv_to_rgb(hsv), 0.0, 1.0)

    ops = (apply_brightness, apply_contrast, apply_saturation, apply_hue)
    for idx in draws.order:
        imgs = ops[idx](imgs)
    return imgs


# ---------------------------------------------------------------------------
# encoder forward
# ---------------------------------------------------------------------------

def _device(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def collect_levels(module: torch.nn.Module, imgs: torch.Tensor,
                   batch_size: int = 32, method: Optional[Callable] = None
                   ) -> list:
    """Batched eval-mode encoder forward: every per-level activation at
    once, ``[*skip_levels, final]``, on the encoder's device.  One forward
    computes every level, so a sweep over (level, pool, metric, margin)
    cells scores from these tensors instead of running the encoder per
    cell.  *method*, if given, takes a batch and returns ``(final,
    skips)``."""
    forward = method or functools.partial(module, return_skip_vals=True)
    training = module.training
    module.eval()
    outs = []
    try:
        with torch.no_grad():
            for start in range(0, imgs.shape[0], batch_size):
                y_hat, skips = forward(imgs[start:start + batch_size])
                outs.append([*skips, y_hat])
    finally:
        module.train(training)
    if len(outs) == 1:
        return outs[0]
    return [torch.cat([batch[i] for batch in outs])
            for i in range(len(outs[0]))]


def pool_spatial(pred: torch.Tensor) -> torch.Tensor:
    """NHWC / (B, L, C) -> (N, C) spatial mean."""
    return pred.reshape(pred.shape[0], -1, pred.shape[-1]).mean(dim=1)


def predict_w_model(module: torch.nn.Module, imgs: torch.Tensor,
                    batch_size: int = 32, level: int = -2, pool: bool = True,
                    method: Optional[Callable] = None) -> torch.Tensor:
    """The ``level``-indexed entry of ``[*skip_levels, final]``, optionally
    mean-pooled over the spatial axes."""
    pred = collect_levels(module, imgs, batch_size=batch_size,
                          method=method)[level]
    return pool_spatial(pred) if pool else pred


def eval_encoder(module: torch.nn.Module, imgs, scorer: Robustness,
                 level: int, pool: bool,
                 generator: Optional[torch.Generator] = None,
                 batch_size: int = 32, method: Optional[Callable] = None,
                 draws: Optional[Sequence[JitterDraws]] = None
                 ) -> torch.Tensor:
    """Score one encoder: two jittered views -> margin scores (N,).  The
    two views' *draws* are taken from *generator* (seed 0 if None) unless
    given."""
    if draws is None:
        generator = generator or torch.Generator().manual_seed(0)
        draws = (jitter_draws(generator), jitter_draws(generator))
    imgs = torch.as_tensor(imgs, dtype=torch.float32, device=_device(module))
    preds = [predict_w_model(module, apply_color_jitter(imgs, d),
                             batch_size=batch_size, level=level, pool=pool,
                             method=method) for d in draws]
    return scorer(*preds)
