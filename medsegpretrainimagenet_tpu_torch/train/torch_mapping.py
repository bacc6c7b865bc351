"""Translate the reference's PyTorch encoder checkpoints to the port's names.

The port of ``train/torch_mapping.py``, for the three encoder families of
the paper.  The reference's released pretraining checkpoints are
``FeedForwardModel`` state dicts whose first layer is the encoder;
downstream transfer strips the ``layers.0.`` prefix
(``train.checkpoint.load_encoder_variables``) and tolerates ``.model.``
wrapper keys.  The torch key families and the port's names they map onto:

* the U-Net encoder: ``first_block.{weight,bias}`` (the stem conv) ->
  ``stem_block.Conv_0``; ``down_layers.{i}.conv{j}.block.{m}.*`` and
  ``bottom_block.conv{j}.block.{m}.*`` (``m % 3 == 0`` a conv, ``m % 3 ==
  1`` its BatchNorm; activations hold nothing) -> ``level_convs.{i}.{j}``
  and ``bottom_convs.{j}`` ``.Conv_k|BatchNorm_k``;
* the Swin encoder: the PatchEmbed stem ``first_block.{proj,norm_layer}``
  -> ``stem_block.{Conv_0,LayerNorm_0}``; the blocks' ``norm1``, ``norm2``,
  ``attn.{qkv,proj}``, ``attn.relative_position_bias_table`` and
  ``mlp.{fc1,fc2}`` -> ``norm1``, ``norm2``, ``attn.*`` and
  ``mlp.{Dense_0,Dense_1}`` of the same modules; PatchMerging's
  ``down_layers.{i}.downsampl.{reduction,norm}`` ->
  ``downsamples.{i}.{Dense_0,LayerNorm_0}``.  The buffers ``attn_mask``
  and ``relative_position_index`` are dropped: the port rebuilds them;
* ``DeepResNet``: the stem ``stem.0``/``stem.1`` (v1: conv and BatchNorm)
  or ``stem`` (v2: a bare conv) -> ``stem_conv``/``stem_bn``;
  ``levels.{i}.{j}.conv{k}|bn{k}.*`` (1-based) ->
  ``levels.{i}.{j}.Conv_{k-1}|BatchNorm_{k-1}``.

Both sides are torch tensors in torch's layouts (OIHW kernels, (out, in)
linear weights, the (entries, heads) bias table), so only the names change.
Residual shortcuts and layer scales (``shortcut{j}``, ``layer_scale{j}``)
are not mapped, as in the JAX package: such keys come back as leftovers for
the caller's strict or warned handling.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import torch

__all__ = ["looks_like_torch_encoder", "translate_reference_encoder"]

_BLOCK_RE = re.compile(
    r"^(?:down_layers\.(?P<level>\d+)|(?P<bottom>bottom_block))"
    r"\.conv(?P<j>\d+)\.block\.(?P<m>\d+)\.(?P<leaf>.+)$")
_STEM_RE = re.compile(r"^first_block\.(?P<leaf>weight|bias)$")
_SWIN_RE = re.compile(
    r"^(?:down_layers\.(?P<level>\d+)|(?P<bottom>bottom_block))"
    r"\.conv(?P<j>\d+)\.(?P<rest>(?:norm1|norm2|attn|mlp|attn_mask).*)$")
_DOWNSAMPL_RE = re.compile(
    r"^down_layers\.(?P<level>\d+)\.downsampl\.(?P<rest>.+)$")
_SWIN_STEM_RE = re.compile(
    r"^first_block\.(?P<child>proj|norm_layer)\.(?P<leaf>weight|bias)$")
_RESNET_STEM_RE = re.compile(
    r"^stem(?:\.(?P<idx>\d+))?\.(?P<leaf>weight|bias|running_mean"
    r"|running_var|num_batches_tracked)$")
_RESNET_BLOCK_RE = re.compile(
    r"^levels\.(?P<level>\d+)\.(?P<j>\d+)"
    r"\.(?P<kind>conv|bn)(?P<k>\d+)\.(?P<leaf>.+)$")

#: the reference's top-level encoder module names
_TOP_LEVEL = {"first_block", "down_layers", "bottom_block", "stem", "levels"}
#: the port's own DeepResNet blocks, which share the top-level ``levels``
_PORT_RESNET_RE = re.compile(r"^levels\.\d+\.\d+\.(?:Conv|BatchNorm)_\d+\.")

#: a reference BatchNorm leaf -> the port's (running statistics included)
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var",
              "num_batches_tracked")
_AFFINE = ("weight", "bias")
_SWIN_MLP = {"fc1": "Dense_0", "fc2": "Dense_1"}
#: buffers the port rebuilds, dropped without a leftover
_DROPPED = object()


def looks_like_torch_encoder(state: Dict[str, torch.Tensor]) -> bool:
    """Whether *state* carries the reference's module names at its top
    level (the port's own checkpoints carry ``stem_block``,
    ``level_convs``, ``stem_conv``, ``levels.{i}.{j}.Conv_k``, ...)."""
    return any(_strip(key).split(".", 1)[0] in _TOP_LEVEL
               and not _PORT_RESNET_RE.match(_strip(key)) for key in state)


def _strip(key: str) -> str:
    key = key.replace(".model.", ".")
    return key[len("model."):] if key.startswith("model.") else key


def _swin_block(match) -> Optional[object]:
    """A Swin block's key -> the port's name, _DROPPED or None."""
    module = f"bottom_convs.{match['j']}" if match["bottom"] \
        else f"level_convs.{match['level']}.{match['j']}"
    parts = match["rest"].split(".")
    if parts[0] == "attn_mask" or parts[1:] == ["relative_position_index"]:
        return _DROPPED
    if parts[0] in ("norm1", "norm2") and parts[1:] in (["weight"],
                                                        ["bias"]):
        return f"{module}.{match['rest']}"
    if parts[0] == "attn" and (parts[1:] == ["relative_position_bias_table"]
                               or (len(parts) == 3
                                   and parts[1] in ("qkv", "proj")
                                   and parts[2] in _AFFINE)):
        return f"{module}.{match['rest']}"
    if parts[0] == "mlp" and len(parts) == 3 and parts[1] in _SWIN_MLP \
            and parts[2] in _AFFINE:
        return f"{module}.mlp.{_SWIN_MLP[parts[1]]}.{parts[2]}"
    return None


def _port_name(key: str) -> Optional[object]:
    """The port's name for one reference key, _DROPPED for a buffer the port
    rebuilds, or None for a key with no mapping."""
    stem = _STEM_RE.match(key)
    if stem:
        return f"stem_block.Conv_0.{stem['leaf']}"
    swin_stem = _SWIN_STEM_RE.match(key)
    if swin_stem:  # PatchEmbed: conv proj + LayerNorm
        child = "Conv_0" if swin_stem["child"] == "proj" else "LayerNorm_0"
        return f"stem_block.{child}.{swin_stem['leaf']}"
    downsampl = _DOWNSAMPL_RE.match(key)
    if downsampl:  # PatchMerging: Linear reduction + LayerNorm
        module = f"downsamples.{downsampl['level']}"
        rest = downsampl["rest"]
        if rest == "reduction.weight":
            return f"{module}.Dense_0.weight"
        if rest in ("norm.weight", "norm.bias"):
            return f"{module}.LayerNorm_0.{rest.split('.')[1]}"
        return None
    resnet_stem = _RESNET_STEM_RE.match(key)
    if resnet_stem:
        leaf = resnet_stem["leaf"]
        is_bn = resnet_stem["idx"] == "1" or leaf not in _AFFINE
        return f"{'stem_bn' if is_bn else 'stem_conv'}.{leaf}"
    resnet_block = _RESNET_BLOCK_RE.match(key)
    if resnet_block:
        module = f"levels.{resnet_block['level']}.{resnet_block['j']}"
        k, leaf = int(resnet_block["k"]) - 1, resnet_block["leaf"]
        if resnet_block["kind"] == "conv" and leaf in _AFFINE:
            return f"{module}.Conv_{k}.{leaf}"
        if resnet_block["kind"] == "bn" and leaf in _BN_LEAVES:
            return f"{module}.BatchNorm_{k}.{leaf}"
        return None
    swin = _SWIN_RE.match(key)
    if swin:
        return _swin_block(swin)
    block = _BLOCK_RE.match(key)
    if block:
        module = f"bottom_convs.{block['j']}" if block["bottom"] \
            else f"level_convs.{block['level']}.{block['j']}"
        m, leaf = int(block["m"]), block["leaf"]
        if m % 3 == 0 and leaf in _AFFINE:
            return f"{module}.Conv_{m // 3}.{leaf}"
        if m % 3 == 1 and leaf in _BN_LEAVES:
            return f"{module}.BatchNorm_{m // 3}.{leaf}"
    return None


def translate_reference_encoder(state: Dict[str, torch.Tensor]
                                ) -> Tuple[Dict[str, torch.Tensor],
                                           List[str]]:
    """A reference encoder state dict (U-Net, Swin or ResNet) -> (the port
    encoder's state dict, the reference keys with no mapping)."""
    out: Dict[str, torch.Tensor] = {}
    leftover: List[str] = []
    for key, value in state.items():
        key = _strip(key)
        name = _port_name(key)
        if name is None:
            leftover.append(key)
        elif name is not _DROPPED:
            out[name] = value
    return out, leftover
