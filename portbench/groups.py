"""Kernel-name groups: which layer a device kernel belongs to, by
fragments of its name, as the port's bring-up profiles grouped them
(``chip_smoke.py``'s ``_TRAIN_GROUPS``, ``_SWIN_TRAIN_GROUPS``,
``_SWIN_GROUPS``)."""
from __future__ import annotations

from typing import Optional

__all__ = ["K1", "LAYOUT", "NORM", "NCCL", "group_of"]

#: K1's forward and backward kernels, and the backward's dbias sum
K1 = ("window_attention", "sum_partials")
#: copies, permutes, rolls, transposes and concatenations
LAYOUT = ("roll", "copy", "catarray", "index", "transpose",
          "nchwtonhwc", "nhwctonchw", "permute")
#: LayerNorm and BatchNorm, forward and backward
NORM = ("layer_norm", "gammabeta", "batch_norm", "batchnorm", "bn_fw",
        "bn_bw")
#: NCCL's collectives
NCCL = ("nccl",)


def group_of(name: str, fragments) -> Optional[str]:
    """The first fragment of *fragments* in *name* (lower case), or
    None."""
    low = name.lower()
    return next((f for f in fragments if f in low), None)
