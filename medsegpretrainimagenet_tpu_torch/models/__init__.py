"""Model zoo of the port: the conv U-Net's and the Swin U-Net's blocks, the
generic U-Net, the ResNet encoder, the pretraining ``FeedForwardModel``
and the Model wrapper.  The residual block zoo of the JAX package's
``models/blocks.py`` is ROADMAP queue M9's rest."""
from ..config.registry import register_not_ported
from . import activations  # noqa: F401  (registers activation components)
from . import blocks  # noqa: F401
from .feedforward import CompoundModel, FeedForwardModel  # noqa: F401
from .swin import (DoubleSwinTransformerBlock, FinalPatchExpand_X4,  # noqa: F401
                   PatchEmbed, PatchExpand, PatchMerging,
                   SwinTransformerBlock, WindowAttention)
from .resnet import DeepResNet  # noqa: F401
from .unet import UNet, UNetDecoder, UNetEncoder  # noqa: F401
from .wrapper import Model  # noqa: F401

for _name, _alias in (("AttentionBlock", "attention_block"),
                      ("ResNeXtBlock", "resnext_block"),
                      ("InvertedBottleneckBlock", "inverted_bottleneck_block"),
                      ("ConvNeXtBlock", "convnext_block"),
                      ("LayerScale", "layer_scale"),
                      ("ChannelwiseLayerNorm", "channelwise_layer_norm")):
    register_not_ported(f"segmentation.models.blocks.{_name}", _alias,
                        item=f"M9 (models/blocks.py {_name})")

__all__ = ["Model", "UNet", "UNetEncoder", "UNetDecoder", "DeepResNet",
           "FeedForwardModel",
           "CompoundModel", "PatchEmbed",
           "PatchMerging", "PatchExpand", "FinalPatchExpand_X4",
           "SwinTransformerBlock", "DoubleSwinTransformerBlock",
           "WindowAttention"]
