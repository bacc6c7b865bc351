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


def reference_state(state, family: str, version: str = "v1"):
    """A port encoder state dict under the reference's torch module names
    (the inverse of ``train.torch_mapping``), prefixed ``layers.0.`` as a
    released pretraining checkpoint holds them.  *family*: "unet", "swin"
    or "resnet" (of *version*).  The Swin family also gets the reference's
    buffers, which the translation drops: ``attn.relative_position_index``
    in every block and ``attn_mask`` in each shifted one."""
    out = {}
    for name, value in state.items():
        parts = name.split(".")
        if family == "resnet":
            if parts[0] == "stem_conv":
                key = ("stem.0." if version == "v1" else "stem.") + parts[1]
            elif parts[0] == "stem_bn":
                key = "stem.1." + parts[1]
            else:
                kind, k = parts[3].split("_")
                key = (f"levels.{parts[1]}.{parts[2]}."
                       f"{'conv' if kind == 'Conv' else 'bn'}{int(k) + 1}."
                       f"{parts[4]}")
        elif parts[0] == "stem_block":
            child = {"Conv_0": "proj", "LayerNorm_0": "norm_layer"}[parts[1]]
            key = f"first_block.{parts[-1]}" if family == "unet" \
                else f"first_block.{child}.{parts[2]}"
        elif parts[0] == "downsamples":
            child = {"Dense_0": "reduction", "LayerNorm_0": "norm"}[parts[2]]
            key = f"down_layers.{parts[1]}.downsampl.{child}.{parts[3]}"
        else:
            if parts[0] == "level_convs":
                module, rest = f"down_layers.{parts[1]}.conv{parts[2]}", \
                    parts[3:]
            else:
                module, rest = f"bottom_block.conv{parts[1]}", parts[2:]
            if family == "unet":
                kind, k = rest[0].split("_")
                rest = ["block", str(3 * int(k) + (kind != "Conv")), rest[1]]
            elif rest[0] == "mlp":
                rest = ["mlp", {"Dense_0": "fc1", "Dense_1": "fc2"}[rest[1]],
                        rest[2]]
            key = f"{module}.{'.'.join(rest)}"
            if family == "swin" and rest[-1] == "relative_position_bias_table":
                tokens = int(round(np.sqrt(value.shape[0]))) // 2 + 1
                out[f"layers.0.{module}.attn.relative_position_index"] = \
                    torch.arange(tokens ** 4).reshape(tokens ** 2, tokens ** 2)
                if module[-1] in "13579":
                    out[f"layers.0.{module}.attn_mask"] = torch.zeros(
                        4, tokens ** 2, tokens ** 2)
        out[f"layers.0.{key}"] = value
    return out
