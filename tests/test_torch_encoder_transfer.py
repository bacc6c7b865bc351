"""Encoder transfer from a pretraining checkpoint into the downstream U-Net,
the port against the JAX package, on the CPU.

* ``train.checkpoint.load_encoder_variables`` reads a port pretraining
  checkpoint's ``layers.0.`` subtree, the prefix stripped, its BatchNorm
  statistics apart from its parameters.
* ``Model.init_weight`` with ``weight_init/encoder`` grafts it into the
  U-Net's encoder: equal to the checkpoint, the decoder untouched, and
  equal to what the JAX wrapper makes of the JAX checkpoint of the same
  weights.
* ``train.torch_mapping`` translates a reference-format state dict (torch
  module names, written here) as JAX's ``translate_reference_encoder``
  does on the same arrays, and the wrapper loads it through that path.
* Missing and unexpected keys warn without ``strict``; with it the load
  fails and leaves the encoder as it was, with the JAX package's message.
* Reference Swin and ResNet encoder checkpoints translate as JAX's
  ``translate_reference_encoder`` followed by ``state_dict_from_jax``
  translates them, bit for bit, with the same leftover keys."""
import warnings

import jax
import numpy as np
import pytest
import torch

from medsegpretrainimagenet_tpu.config import ConfigDict as JaxConfigDict
from medsegpretrainimagenet_tpu.config import registry as jax_registry
from medsegpretrainimagenet_tpu.models import Model as JaxModel
from medsegpretrainimagenet_tpu.train import checkpoint as jax_ckpt
from medsegpretrainimagenet_tpu.train import torch_mapping as jax_mapping
from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
from medsegpretrainimagenet_tpu_torch.models import Model
from medsegpretrainimagenet_tpu_torch.train import checkpoint as ckpt
from medsegpretrainimagenet_tpu_torch.train import torch_mapping
from medsegpretrainimagenet_tpu_torch.transfer import state_dict_from_jax

from test_torch_feedforward import pretrain_model_config
from torch_port_helpers import (build_model, reference_state, transplant,
                                unet_config)

CHANNELS = (4, 8, 16)


def _stats_marked(variables, value=0.123):
    """The variables with recognisable BatchNorm statistics."""
    out = dict(variables)
    out["batch_stats"] = jax.tree_util.tree_map(
        lambda v: np.full_like(np.asarray(v), value), variables["batch_stats"])
    return out


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """One pretraining model's weights as a JAX msgpack file and as the
    port's ``.pt`` translation of it, and a U-Net's starting weights."""
    root = tmp_path_factory.mktemp("enc")
    pretrain = build_model(JaxConfigDict, jax_registry, JaxModel,
                           pretrain_model_config(CHANNELS))
    variables = pretrain.init(jax.random.key(3), {
        "x": np.zeros((1, 16, 16, 3), np.float32)})
    variables = _stats_marked(jax.tree_util.tree_map(np.asarray, variables))
    jax_path = root / "model_state_dict_epoch_1.msgpack"
    jax_ckpt.save_params_file(str(jax_path), variables)
    module = build_model(ConfigDict, registry, Model,
                         pretrain_model_config(CHANNELS)).module
    port_state = state_dict_from_jax(variables, module)
    port_path = root / "model_state_dict_epoch_1.pt"
    ckpt.save_params_file(str(port_path), port_state)

    unet = build_model(JaxConfigDict, jax_registry, JaxModel,
                       unet_config(CHANNELS))
    unet_vars = jax.tree_util.tree_map(np.asarray, unet.init(
        jax.random.key(4), {"x": np.zeros((1, 16, 16, 3), np.float32)}))
    return root, str(jax_path), str(port_path), port_state, unet_vars


def _port_unet(unet_vars):
    model = build_model(ConfigDict, registry, Model, unet_config(CHANNELS))
    transplant(unet_vars, model.module)
    return model


def test_load_encoder_variables_strips_the_prefix(checkpoints):
    _, _, port_path, port_state, _ = checkpoints
    params, stats = ckpt.load_encoder_variables(port_path)
    encoder = {k[len("layers.0."):]: v for k, v in port_state.items()
               if k.startswith("layers.0.")}
    assert set(params) | set(stats) == set(encoder)
    assert "stem_block.Conv_0.weight" in params
    assert all(k.rsplit(".", 1)[-1] in ckpt.STAT_LEAVES for k in stats)
    assert not any(k.rsplit(".", 1)[-1] in ckpt.STAT_LEAVES for k in params)
    for name, value in {**params, **stats}.items():
        assert torch.equal(value, encoder[name]), name
    assert torch.all(stats["level_convs.0.0.BatchNorm_0.running_mean"]
                     == 0.123)
    assert set(ckpt.load_encoder_params(port_path)) == set(params)
    # the JAX reader sees the same encoder in the same file
    jax_tree = jax_ckpt.load_encoder_params(port_path)
    assert "stem_block" in jax_tree


@pytest.mark.parametrize("strict", [True, False])
def test_wrapper_transfer_matches_the_checkpoint_and_jax(checkpoints,
                                                         strict, capsys):
    _, jax_path, port_path, port_state, unet_vars = checkpoints
    model = _port_unet(unet_vars)
    before = {k: v.clone() for k, v in model.module.state_dict().items()}
    enc = {"weights": port_path, "strict": strict,
           "pretrained_encoder": True}
    model.init_weight(ConfigDict({"weight_init": {"encoder": enc}}),
                      torch.Generator().manual_seed(0))
    assert "Successfully initialised encoder" in capsys.readouterr().out
    got = model.module.state_dict()
    for name, value in got.items():
        if name.startswith("enc.") and "num_batches" not in name:
            assert torch.equal(value, port_state[f"layers.0.{name[4:]}"]), \
                name
        elif name.startswith("dec."):
            assert torch.equal(value, before[name]), name

    jmodel = build_model(JaxConfigDict, jax_registry, JaxModel,
                         unet_config(CHANNELS))
    jvars = jmodel._encoder_transfer(JaxConfigDict({"weight_init": {
        "encoder": {**enc, "weights": jax_path}}}), unet_vars)
    want = transplant(jvars, _port_unet(unet_vars).module).state_dict()
    for name, value in got.items():
        if "num_batches" not in name:
            assert torch.equal(value, want[name]), name


@pytest.fixture(scope="module")
def reference_checkpoint(checkpoints):
    root, _, _, port_state, _ = checkpoints
    rng = np.random.default_rng(5)
    encoder = {k[len("layers.0."):]: (
        torch.from_numpy(rng.random(tuple(v.shape)).astype(np.float32))
        if v.is_floating_point() else v)
        for k, v in port_state.items() if k.startswith("layers.0.")}
    state = reference_state(encoder, "unet")
    state["layers.3.weight"] = torch.zeros(5, CHANNELS[-1])  # the head
    path = root / "reference_encoder.pt"
    torch.save(state, path)
    return str(path), encoder


def test_torch_mapping_matches_jax(reference_checkpoint, checkpoints):
    path, encoder = reference_checkpoint
    params, stats = ckpt.load_encoder_variables(path)
    assert torch_mapping.looks_like_torch_encoder(params)
    assert not torch_mapping.looks_like_torch_encoder(
        ckpt.load_encoder_params(checkpoints[2]))
    got, leftover = torch_mapping.translate_reference_encoder(
        {**params, **stats})
    assert leftover == []
    for name, value in encoder.items():
        assert torch.equal(got[name], value), name

    jax_tree = jax_ckpt.load_encoder_params(path)
    assert jax_mapping.looks_like_torch_encoder(jax_tree)
    translated, jax_leftover = jax_mapping.translate_reference_encoder(
        jax_tree)
    assert jax_leftover == []
    unet = build_model(ConfigDict, registry, Model, unet_config(CHANNELS))
    want = state_dict_from_jax(
        {"params": {"enc": translated["params"]},
         "batch_stats": {"enc": translated["batch_stats"]}},
        _EncoderOnly(unet.module.enc))
    for name, value in want.items():
        if "num_batches" not in name:
            assert torch.equal(got[name[len("enc."):]], value), name


class _EncoderOnly(torch.nn.Module):
    def __init__(self, enc):
        super().__init__()
        self.enc = enc


def test_wrapper_loads_a_reference_checkpoint_as_jax_does(
        reference_checkpoint, checkpoints):
    path, encoder = reference_checkpoint
    unet_vars = checkpoints[4]
    model = _port_unet(unet_vars)
    model.init_weight(ConfigDict({"weight_init": {"encoder": {
        "weights": path}}}))
    jmodel = build_model(JaxConfigDict, jax_registry, JaxModel,
                         unet_config(CHANNELS))
    jvars = jmodel._encoder_transfer(JaxConfigDict({"weight_init": {
        "encoder": {"weights": path}}}), unet_vars)
    want = transplant(jvars, _port_unet(unet_vars).module).state_dict()
    for name, value in model.module.state_dict().items():
        if "num_batches" not in name:
            assert torch.equal(value, want[name]), name
        if name.startswith("enc.") and "num_batches" not in name:
            assert torch.equal(value, encoder[name[len("enc."):]]), name


def test_non_strict_warns_and_strict_leaves_the_encoder(checkpoints,
                                                        capsys):
    root, _, _, port_state, unet_vars = checkpoints
    state = dict(port_state)
    state.pop("layers.0.bottom_convs.0.Conv_1.weight")
    state["layers.0.extra_block.weight"] = torch.zeros(3)
    path = str(root / "partial.pt")
    ckpt.save_params_file(path, state)

    model = _port_unet(unet_vars)
    before = {k: v.clone() for k, v in model.module.state_dict().items()}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        model.init_weight(ConfigDict({"weight_init": {"encoder": {
            "weights": path, "strict": False}}}))
    text = " ".join(str(w.message) for w in caught)
    assert "Missing keys in encoder checkpoint" in text
    assert "bottom_convs.0.Conv_1.weight" in text
    assert "Unexpected keys in encoder checkpoint" in text
    after = model.module.state_dict()
    assert torch.equal(after["enc.bottom_convs.0.Conv_1.weight"],
                       before["enc.bottom_convs.0.Conv_1.weight"])
    assert torch.equal(after["enc.stem_block.Conv_0.weight"],
                       port_state["layers.0.stem_block.Conv_0.weight"])

    model = _port_unet(unet_vars)
    capsys.readouterr()
    model.init_weight(ConfigDict({"weight_init": {"encoder": {
        "weights": path, "strict": True}}}))
    assert "Could not load encoder weights" in capsys.readouterr().err
    for name, value in model.module.state_dict().items():
        assert torch.equal(value, before[name]), name


@pytest.mark.parametrize("key, item", [
    ("down_layers.0.conv0.attn.qkv.weight", "level_convs.0.0.attn.qkv.weight"),
    ("first_block.proj.weight", "stem_block.Conv_0.weight"),
    ("down_layers.1.downsampl.reduction.weight",
     "downsamples.1.Dense_0.weight"),
    ("stem.0.weight", "stem_conv.weight"),
    ("levels.0.1.conv2.weight", "levels.0.1.Conv_1.weight")])
def test_other_encoder_families_are_refused(key, item):
    """The Swin and ResNet keys that were refused before their families
    were ported now translate to the port's names."""
    got, leftover = torch_mapping.translate_reference_encoder(
        {key: torch.zeros(2)})
    assert list(got) == [item] and leftover == []


#: reference keys no family maps, in both packages a leftover (in the
#: order of the module tree, which is the order both packages report)
UNMAPPED = {"swin": ("down_layers.0.downsampl.extra.weight",
                     "down_layers.0.shortcut0.weight"),
            "resnet": ("levels.0.0.shortcut.weight", "fc.weight")}


@pytest.mark.parametrize("family, version", [("swin", "v1"),
                                             ("resnet", "v1"),
                                             ("resnet", "v2")])
def test_swin_and_resnet_mappings_match_jax(tmp_path, family, version):
    """A reference-named encoder state dict written from a seed: the port's
    translation equals JAX's followed by ``state_dict_from_jax`` bit for
    bit, both equal the weights it was written from, the buffers
    (``attn_mask``, ``relative_position_index``) are dropped and the
    leftover lists are equal."""
    from test_torch_robustness import encoder_configs

    (cfg,) = [c for c in encoder_configs() if c["name"] == {
        "swin": "swin_transformer", "resnet": "resnet50"}[family]]
    model_cfg = ConfigDict(cfg["model"])
    if family == "resnet":
        model_cfg["classification.models.DeepResNet/version"] = version
    model = registry.build(model_cfg, wrapper=Model)
    model.init(11)
    rng = np.random.default_rng(12)
    state = {k: (torch.from_numpy(rng.random(tuple(v.shape)).astype(
        np.float32)) if v.is_floating_point() else v)
        for k, v in model.module.state_dict().items()}
    reference = reference_state(state, family, version)
    for key in UNMAPPED[family]:
        reference[f"layers.0.{key}"] = torch.ones(3)
    path = tmp_path / "reference.pt"
    torch.save(reference, path)

    params, stats = ckpt.load_encoder_variables(str(path))
    assert torch_mapping.looks_like_torch_encoder(params)
    got, leftover = torch_mapping.translate_reference_encoder(
        {**params, **(stats or {})})
    jax_tree = jax_ckpt.load_encoder_params(str(path))
    translated, jax_leftover = jax_mapping.translate_reference_encoder(
        jax_tree)
    assert leftover == jax_leftover == list(UNMAPPED[family])
    want = state_dict_from_jax(translated, model.module)
    counts = [k for k in want if k.endswith("num_batches_tracked")]
    assert set(got) == set(want) - (set() if family == "resnet"
                                    else set(counts))
    for name, value in want.items():
        if name not in counts:
            assert torch.equal(got[name], value), name
            assert torch.equal(got[name], state[name]), name
