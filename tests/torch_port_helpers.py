"""Shared pieces of the tests that hold the PyTorch port against the JAX
package: a small Swin U-Net and a small conv U-Net configuration, built by
either package, and weight transplanting from a flax module into its torch
counterpart."""
import jax
import numpy as np
import torch

from medsegpretrainimagenet_tpu_torch.transfer import state_dict_from_jax


def swin_unet_architecture(img=64, embed=8, channels=(8, 16, 32),
                           heads=(1, 2, 4), window=4):
    """The ``architecture`` section of a small Swin U-Net config (the
    shape of ``config/downstream/covidqu/swin_unet.yaml``, cut to size)."""
    return {
        "in_channel_size": 3, "out_channel_size": 1,
        "depth": len(channels) - 1, "width": 2, "channels": tuple(channels),
        "change_channels_in_block": False, "trainable_downsampling": True,
        "stochastic depth rate": 0.2,
        "basic_block": {"segmentation.models.blocks.SwinTransformerBlock": {
            "img_size": img, "patch_size": 4, "embed_dim": embed,
            "num_heads_layers": tuple(heads), "window_size": window}},
        "mixing_block": {"segmentation.models.blocks.ConcatLinearBlock": {
            "halve_channels": True, "pass_all_input": True}},
        "stem": {"segmentation.models.blocks.PatchEmbed": {"patch_size": 4}},
        "downsampling": {"segmentation.models.blocks.PatchMerging": {}},
        "upsampling": {"segmentation.models.blocks.PatchExpand": {
            "dim_scale": 2}},
        "final_block": {"segmentation.models.blocks.FinalPatchExpand_X4": {
            "dim_scale": 4}},
        "activation function": {"final": "sigmoid"},
    }


def model_config(**kwargs):
    """A whole ``model`` config section, as a plain dict."""
    return {"model": {"segmentation.models.UNet": {
        "architecture": swin_unet_architecture(**kwargs)}}}


def unet_config(channels=(4, 8, 16), in_channels=3, **architecture):
    """A whole ``model`` config section of the default conv U-Net
    (ConvBlock, BatchNorm, max pooling, UpConvBlock, concatenation), as a
    plain dict; ``depth`` follows the channel ladder."""
    arch = {"in_channel_size": in_channels, "out_channel_size": 1,
            "depth": len(channels) - 1, "channels": tuple(channels)}
    arch.update(architecture)
    return {"model": {"segmentation.models.UNet": {"architecture": arch}}}


def build_model(package_config, registry, model_cls, cfg):
    """Build the ``Model`` wrapper of either package from a plain config."""
    cd = package_config(cfg)
    cd.expand()
    registry.fill_spec(cd, "model")
    return registry.build(cd, key="model", wrapper=model_cls)


def transplant(variables, module: torch.nn.Module) -> torch.nn.Module:
    """Load flax *variables* into the torch *module* and return it."""
    host = jax.tree_util.tree_map(np.asarray, variables)
    module.load_state_dict(state_dict_from_jax(host, module))
    return module.eval()
