"""Translate the reference's PyTorch encoder checkpoints to the port's names.

The port of ``train/torch_mapping.py``, for the U-Net encoder family.  The
reference's released pretraining checkpoints are ``FeedForwardModel``
state dicts whose first layer is the encoder; downstream transfer strips
the ``layers.0.`` prefix (``train.checkpoint.load_encoder_variables``) and
tolerates ``.model.`` wrapper keys.  The U-Net encoder's torch key
families are:

* ``first_block.{weight,bias}``: the stem conv;
* ``down_layers.{i}.conv{j}.block.{m}.*``: the level ConvBlocks (``m % 3
  == 0`` a conv, ``m % 3 == 1`` its BatchNorm; activations hold nothing);
* ``bottom_block.conv{j}.block.{m}.*``: the bottom ConvBlocks.

They map onto the port's ``stem_block.Conv_0``, ``level_convs.{i}.{j}.
Conv_k|BatchNorm_k`` and ``bottom_convs.{j}.*``.  Both sides are torch
tensors in torch's layouts (OIHW kernels), so only the names change.
Residual shortcuts and layer scales (``shortcut{j}``, ``layer_scale{j}``)
are not mapped, as in the JAX package: such keys come back as leftovers for
the caller's strict or warned handling.  The Swin (``norm1``, ``attn``,
``mlp``, PatchEmbed and PatchMerging keys) and ResNet (``stem``,
``levels``) encoders raise NotImplementedError naming their ROADMAP item.
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

import torch

__all__ = ["looks_like_torch_encoder", "translate_reference_encoder"]

_BLOCK_RE = re.compile(
    r"^(?:down_layers\.(?P<level>\d+)|(?P<bottom>bottom_block))"
    r"\.conv(?P<j>\d+)\.block\.(?P<m>\d+)\.(?P<leaf>.+)$")
_STEM_RE = re.compile(r"^first_block\.(?P<leaf>weight|bias)$")
_SWIN_RE = re.compile(
    r"^(?:(?:down_layers\.\d+|bottom_block)\.conv\d+\.(?:norm1|norm2|attn"
    r"|mlp|attn_mask)|first_block\.(?:proj|norm_layer)"
    r"|down_layers\.\d+\.downsampl)\.")
_RESNET_RE = re.compile(r"^(?:stem|levels)(?:\.|$)")

#: the reference's top-level encoder module names
_TOP_LEVEL = {"first_block", "down_layers", "bottom_block", "stem", "levels"}

#: a reference BatchNorm leaf -> the port's (running statistics included)
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var",
              "num_batches_tracked")


def looks_like_torch_encoder(state: Dict[str, torch.Tensor]) -> bool:
    """Whether *state* carries the reference's module names at its top
    level (the port's own checkpoints carry ``stem_block``,
    ``level_convs``, ...)."""
    return any(_strip(key).split(".", 1)[0] in _TOP_LEVEL for key in state)


def _strip(key: str) -> str:
    key = key.replace(".model.", ".")
    return key[len("model."):] if key.startswith("model.") else key


def translate_reference_encoder(state: Dict[str, torch.Tensor]
                                ) -> Tuple[Dict[str, torch.Tensor],
                                           List[str]]:
    """A reference U-Net encoder state dict -> (the port encoder's state
    dict, the reference keys with no mapping)."""
    out: Dict[str, torch.Tensor] = {}
    leftover: List[str] = []
    for key, value in state.items():
        key = _strip(key)
        if _SWIN_RE.match(key):
            raise NotImplementedError(
                f"{key}: Swin encoder checkpoints of the reference are not "
                f"ported yet (ROADMAP.md M8, Swin training)")
        if _RESNET_RE.match(key):
            raise NotImplementedError(
                f"{key}: ResNet encoder checkpoints of the reference are not "
                f"ported yet (ROADMAP.md M9, ResNet-50)")
        stem = _STEM_RE.match(key)
        if stem:
            out[f"stem_block.Conv_0.{stem['leaf']}"] = value
            continue
        block = _BLOCK_RE.match(key)
        if block is None:
            leftover.append(key)
            continue
        module = f"bottom_convs.{block['j']}" if block["bottom"] \
            else f"level_convs.{block['level']}.{block['j']}"
        m, leaf = int(block["m"]), block["leaf"]
        if m % 3 == 0 and leaf in ("weight", "bias"):
            out[f"{module}.Conv_{m // 3}.{leaf}"] = value
        elif m % 3 == 1 and leaf in _BN_LEAVES:
            out[f"{module}.BatchNorm_{m // 3}.{leaf}"] = value
        else:
            leftover.append(key)
    return out, leftover
