"""The reference's arithmetic: plain float32 PyTorch layers, NHWC.

Every product goes through :class:`Ops`, which can do three more things
than compute: count multiply-adds from the output shapes (the yardstick's
FLOP count, on the meta device), round the operands of every product to
float8 e4m3 with a per-tensor scale (the lower-precision control that the
benchmark's comparison has to reject), and remember the statistics that
BatchNorm's running averages take.  Nothing here imports the program.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["Ops", "PRECISIONS"]

#: "float32": the reference; "fp8": the control, products on operands
#: rounded to float8 e4m3 (a per-tensor scale to its largest finite value)
PRECISIONS = ("float32", "fp8")
_E4M3_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """*t* rounded through float8 e4m3 at a per-tensor scale, with the
    gradient passed straight through."""
    if t.device.type == "meta":
        return t
    with torch.no_grad():
        amax = t.detach().abs().amax().float().clamp(min=1e-12)
        scale = _E4M3_MAX / amax
        rounded = (t.detach().float() * scale).to(torch.float8_e4m3fn) \
            .float().div(scale).to(t.dtype)
    return t + (rounded - t).detach()


class Ops:
    """Plain layers on NHWC images and (B, L, C) tokens.

    ``macs`` counts the multiply-adds of every product, ``first_macs``
    those of products whose input is the image itself (they need no input
    gradient).  ``stats`` holds ``(mean, unbiased var)`` of each training
    BatchNorm under the layer's name while ``record_stats`` is on."""

    def __init__(self, precision: str = "float32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        self.precision = precision
        self.macs = 0
        self.first_macs = 0
        self.stats: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.record_stats = True

    def _q(self, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        if t is None or self.precision == "float32":
            return t
        return _fp8(t)

    def _count(self, macs: int, first: bool) -> None:
        self.macs += int(macs)
        if first:
            self.first_macs += int(macs)

    def linear(self, x, w, b=None):
        out = F.linear(self._q(x), self._q(w), b)
        self._count(out.numel() * w.shape[1], False)
        return out

    def conv(self, x, w, b=None, stride=1, pads=((0, 0), (0, 0)),
             first=False, groups=1, dilation=1):
        """NHWC conv with (lo, hi) zero padding per spatial axis; the
        weight is torch's (out, in / groups, kh, kw).  A multiply-add a
        weight of one output channel per output element, which counts a
        grouped conv's too."""
        x = x.permute(0, 3, 1, 2).contiguous()
        (top, bottom), (left, right) = pads
        if (top, left) == (bottom, right):
            out = F.conv2d(self._q(x), self._q(w), b, stride=stride,
                           padding=(top, left), dilation=dilation,
                           groups=groups)
        else:
            out = F.conv2d(F.pad(self._q(x), (left, right, top, bottom)),
                           self._q(w), b, stride=stride, dilation=dilation,
                           groups=groups)
        self._count(out.numel() * w[0].numel(), first)
        return out.permute(0, 2, 3, 1)

    def attention(self, q, k, v, bias, mask, scale):
        """Windowed attention of (B_, H, N, D) q, k, v with a (H, N, N)
        bias and an optional (nW, N, N) additive mask over the windows of
        each image."""
        logits = torch.matmul(self._q(q) * scale,
                              self._q(k).transpose(-1, -2)) + bias[None]
        if mask is not None:
            n_w = mask.shape[0]
            b_, h, n, _ = logits.shape
            logits = (logits.reshape(b_ // n_w, n_w, h, n, n)
                      + mask[None, :, None]).reshape(b_, h, n, n)
        out = torch.matmul(self._q(torch.softmax(logits, dim=-1)),
                           self._q(v))
        b_, h, n, d = q.shape
        self._count(2 * b_ * n * n * h * d, False)
        return out

    def output(self, prob):
        """The model's output: in the control, rounded as the products'
        operands are (the program's output has its compute dtype)."""
        return self._q(prob)

    @staticmethod
    def layer_norm(x, w, b, eps=1e-6):
        return F.layer_norm(x, x.shape[-1:], w, b, eps)

    def batch_norm(self, name, x, w, b, running_mean, running_var, train,
                   eps=1e-5):
        """BatchNorm *name* of NHWC *x*: batch statistics in training (the
        biased variance normalises; the unbiased one goes to
        ``stats[name]``), running ones otherwise."""
        if not train:
            return (x - running_mean) * torch.rsqrt(running_var + eps) \
                * w + b
        dims = (0, 1, 2)
        mean = x.mean(dims)
        var = ((x - mean) ** 2).mean(dims)
        if self.record_stats:
            n = x.numel() // x.shape[-1]
            self.stats[name] = (mean.detach(),
                                var.detach() * n / max(n - 1, 1))
        return (x - mean) * torch.rsqrt(var + eps) * w + b


def same_pads(size: int, kernel: int, stride: int = 1) -> Tuple[int, int]:
    """lax's SAME padding of one axis: the odd element at the end."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def drop_path(x, keep_mask, rate):
    """Per-sample stochastic depth with a drawn (B, 1, 1) keep mask."""
    if keep_mask is None:
        return x
    keep = 1.0 - rate
    return torch.where(keep_mask, x / keep, torch.zeros_like(x))


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))
