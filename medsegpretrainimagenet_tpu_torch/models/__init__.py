"""Model zoo of the port: the conv U-Net's and the Swin U-Net's blocks, the
attention gate, the residual block zoo (ResNeXt, inverted bottleneck,
ConvNeXt, layer scale, channel-wise LayerNorm), the generic U-Net (with
residual shortcuts, layer scaling and an external encoder such as
``DeepResNet``), the ResNet encoder, the pretraining ``FeedForwardModel``
and the Model wrapper."""
from . import activations  # noqa: F401  (registers activation components)
from . import blocks  # noqa: F401
from .feedforward import CompoundModel, FeedForwardModel  # noqa: F401
from .swin import (DoubleSwinTransformerBlock, FinalPatchExpand_X4,  # noqa: F401
                   PatchEmbed, PatchExpand, PatchMerging,
                   SwinTransformerBlock, WindowAttention)
from .resnet import DeepResNet  # noqa: F401
from .unet import UNet, UNetDecoder, UNetEncoder  # noqa: F401
from .wrapper import Model  # noqa: F401

__all__ = ["Model", "UNet", "UNetEncoder", "UNetDecoder", "DeepResNet",
           "FeedForwardModel",
           "CompoundModel", "PatchEmbed",
           "PatchMerging", "PatchExpand", "FinalPatchExpand_X4",
           "SwinTransformerBlock", "DoubleSwinTransformerBlock",
           "WindowAttention"]
