"""The ResNet attention U-Net of the port against the JAX package's, on the
CPU in float32: ``AttentionBlock`` (the attention-U-Net gate) on its own,
then the whole U-Net with a ``DeepResNet`` v1 bottleneck as its external
encoder (``tests/test_model_families_e2e.py``'s toy shape), both from the
same weights carried across with ``transfer.state_dict_from_jax``.  In
eval mode (running statistics drawn from a seed) and in train mode (batch
statistics, running statistics updated) the outputs, the Dice loss, every
parameter's gradient and the updated running statistics agree within
``TOL`` relative: max |port - JAX| over the largest |JAX| of the tensor.
The full-width configuration (ResNet-50, the five-entry decoder of
chip_smoke.py's ``[resnet train]``) builds in both packages with the same
parameter count and gives 256 x 256 logits for a 256 x 256 input."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medsegpretrainimagenet_tpu.config import ConfigDict as JaxConfigDict
from medsegpretrainimagenet_tpu.config import registry as jax_registry
from medsegpretrainimagenet_tpu.losses import DiceLoss as JaxDiceLoss
from medsegpretrainimagenet_tpu.losses import Loss as JaxLoss
from medsegpretrainimagenet_tpu.models import Model as JaxModel
from medsegpretrainimagenet_tpu.models.blocks import \
    AttentionBlock as JaxAttentionBlock
from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
from medsegpretrainimagenet_tpu_torch.losses import DiceLoss, Loss
from medsegpretrainimagenet_tpu_torch.models import Model, blocks
from medsegpretrainimagenet_tpu_torch.transfer import state_dict_from_jax

from torch_port_helpers import (attention_unet_config, build_model,
                                hold_model, relative_error, transplant)

#: relative bars (max |port - JAX| over max |JAX| of each tensor).  In
#: float32 both packages round, the JAX package more: against a float64 run
#: its outputs read 1.2e-5 in train mode (flax takes the batch variance in
#: one pass, E[x^2] - E[x]^2; the port, as torch, in two) and its
#: gradients 3.0e-5 to 3.4e-5 (XLA's float32 sums over the 4 x 32 x 32
#: pixels), the port's 9.6e-6 and 0.5e-5 to 1.3e-5; port against JAX read
#: 1.2e-7 / 7.3e-6 in the outputs (eval / train) and up to 6.4e-5 in the
#: gradients.  In float64 (JAX's x64 on, the port in double) every value
#: agrees to 1e-13
TOL = {"float32": {"eval": 1e-5, "train": 3e-5, "gradients": 1e-4},
       "float64": {"eval": 1e-12, "train": 1e-12, "gradients": 1e-12}}
#: the bar on the Dice loss and its end-to-end ``jax.grad`` in float32 (the
#: repo's bar on losses in steps, ``tests/test_torch_train_step.py``): the
#: JAX package's float32 Dice sums read 3.9e-5 off float64 here, the
#: port's 1e-9
LOSS_TOL = 1e-4
SIZE, IMAGES = 32, 4


def _perturbed_stats(variables, seed):
    """*variables* with every running mean and variance drawn from a seed,
    so eval mode normalises with statistics that are not 0 and 1."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        leaf = np.asarray(leaf)
        if path[-1].key == "mean":
            return rng.normal(0, 0.2, leaf.shape).astype(np.float32)
        return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
    stats = jax.tree_util.tree_map_with_path(draw, variables["batch_stats"])
    return {"params": variables["params"], "batch_stats": stats}


def _stats_of(module):
    return {k: v for k, v in module.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _hold_stats(port_module, jax_batch_stats, jax_params, tol):
    want = state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, {"params": jax_params,
                                            "batch_stats": jax_batch_stats}),
        port_module)
    for name, value in _stats_of(port_module).items():
        assert relative_error(value.numpy(), want[name]) < tol, name


# ---------------------------------------------------------------------------
# AttentionBlock
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["eval", "train"])
def test_attention_block_matches_jax(mode):
    """The gate alone: x (the coarse path, 4 x 4 x 8), x_up (8 x 8 x 4) and
    the skip (8 x 8 x 6); out = [x_up, skip * p] of 8 x 8 x 10."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 4, 4, 8)).astype(np.float32)
    x_up = rng.normal(size=(3, 8, 8, 4)).astype(np.float32)
    skip = rng.normal(size=(3, 8, 8, 6)).astype(np.float32)
    kwargs = dict(x_channels=8, x_up_channels=4, skip_channels=6,
                  level_out_channels=4)
    jblock = JaxAttentionBlock(**kwargs)
    variables = _perturbed_stats(jblock.init(jax.random.key(2), x, x_up,
                                             skip), seed=3)
    block = blocks.AttentionBlock(**kwargs)
    transplant(variables, block)
    train = mode == "train"
    block.train(train)
    got = block(*(torch.from_numpy(a) for a in (x, x_up, skip)))
    if train:
        want, updated = jblock.apply(variables, x, x_up, skip, train=True,
                                     mutable=["batch_stats"])
        _hold_stats(block, updated["batch_stats"], variables["params"],
                    TOL["float32"][mode])
    else:
        want = jblock.apply(variables, x, x_up, skip)
    assert got.shape == (3, 8, 8, 10)
    assert relative_error(got.detach().numpy(), want) < TOL["float32"][mode]
    assert blocks.AttentionBlock.get_out_ch(8, 4, 6, 4) == 10


def test_attention_block_config_names_its_gating_block():
    """The gating block from the config (its default filled in, as in JAX),
    and the JAX flax names of every parameter."""
    cd = ConfigDict({"segmentation.models.blocks.AttentionBlock": {}})
    registry.fill_spec(cd)
    jcd = JaxConfigDict({"segmentation.models.blocks.AttentionBlock": {}})
    jax_registry.fill_spec(jcd)
    assert cd.to_dict() == jcd.to_dict()
    block = registry.resolve(cd.key())(
        **registry.get_kwargs(blocks.AttentionBlock, cd.value()),
        x_channels=4, x_up_channels=2, skip_channels=2, level_out_channels=2)
    assert isinstance(block.ConvBlock_0, blocks.ConvBlock)
    assert block.ConvBlock_0.size == 1
    assert tuple(block.ConvBlock_0.Conv_0.weight.shape) == (4, 4, 1, 1)


# ---------------------------------------------------------------------------
# the attention U-Net with a DeepResNet encoder
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    cfg = attention_unet_config()
    jmodel = build_model(JaxConfigDict, jax_registry, JaxModel, cfg)
    variables = jmodel.init(jax.random.key(0), {
        "x": np.zeros((1, SIZE, SIZE, 3), np.float32)})
    return jmodel, _perturbed_stats(variables, seed=4)


def _batch(seed=5):
    rng = np.random.default_rng(seed)
    x = rng.random((IMAGES, SIZE, SIZE, 3)).astype(np.float32)
    mask = np.zeros((IMAGES, SIZE, SIZE), np.int32)
    mask[:, 8:20, 10:24] = 1
    return x, mask


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_attention_unet_forward_and_gradients_match_jax(pair, mode, dtype):
    """The output, the gradient of every parameter (the pull-back of one
    cotangent through ``jax.vjp``, what ``jax.grad`` is made of, and
    through autograd) and, in train mode, the running statistics after the
    forward, in float32 and in float64.  The biases of the convolutions in
    front of a BatchNorm are held through the outputs only in train mode:
    the batch mean takes them out, so their gradient is rounding noise (as
    in ``tests/test_torch_train_step.py``)."""
    jmodel, variables = pair
    x, _ = _batch()
    model = build_model(ConfigDict, registry, Model, attention_unet_config())
    transplant(variables, model.module)
    cotangent = np.random.default_rng(6).normal(
        size=(IMAGES, SIZE, SIZE, 1)).astype(np.float32)
    errors = hold_model(
        jmodel, variables, model.module, x, cotangent, mode == "train",
        dtype, skip=lambda name: mode == "train"
        and _feeds_batch_norm(model.module, name))
    bars = TOL[dtype]
    for name, err in errors.items():
        bar = bars[mode] if name == "output" or "running" in name \
            else bars["gradients"]
        assert err < bar, (name, err)


def test_attention_unet_dice_loss_and_its_gradient_match_jax(pair):
    """The Dice loss of the train-mode forward and ``jax.grad`` of it, end
    to end in float32, within LOSS_TOL."""
    jmodel, variables = pair
    x, mask = _batch()
    jloss = JaxLoss(JaxDiceLoss, JaxConfigDict({"label type": "mask"}))

    def loss_of(params):
        out, _ = jmodel.apply({**variables, "params": params}, x, train=True,
                              mutable=["batch_stats"])
        return jloss(out, {"mask": jnp.asarray(mask)})
    want, grads = jax.value_and_grad(loss_of)(variables["params"])

    model = build_model(ConfigDict, registry, Model, attention_unet_config())
    transplant(variables, model.module)
    model.module.train()
    loss = Loss(DiceLoss, ConfigDict({"label type": "mask"}))
    value = loss(model.module(torch.from_numpy(x)),
                 {"mask": torch.from_numpy(mask)})
    value.backward()
    assert relative_error(value.item(), want) < LOSS_TOL
    want_grads = state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, {**variables, "params": grads}), model.module)
    for name, p in model.module.named_parameters():
        if not _feeds_batch_norm(model.module, name):
            assert relative_error(p.grad.numpy(),
                                  want_grads[name]) < LOSS_TOL, name


def _feeds_batch_norm(module, name: str) -> bool:
    """Whether parameter *name* is the bias of a conv whose output goes
    straight into a BatchNorm of the same parent: ``Conv_k`` beside
    ``BatchNorm_k`` (ConvBlock, the ResNet blocks, AttentionBlock), or the
    ResNet's stem."""
    if not name.endswith(".bias"):
        return False
    if name == "enc.stem_conv.bias":
        return True
    parent, conv, _ = name.rsplit(".", 2)
    if not conv.startswith("Conv_"):
        return False
    sub = module.get_submodule(parent)
    return hasattr(sub, "BatchNorm_" + conv.split("_")[1])


def test_state_dict_from_jax_maps_every_key_and_refuses_strays(pair):
    """Every parameter and running statistic of the attention U-Net (the
    ``AttentionBlock``'s and the ``DeepResNet`` encoder's included) comes
    from the JAX tree; a stray leaf, a missing one or a wrong shape fails."""
    jmodel, variables = pair
    module = build_model(ConfigDict, registry, Model,
                         attention_unet_config()).module
    host = jax.tree_util.tree_map(np.asarray, variables)
    state = state_dict_from_jax(host, module)
    assert set(state) == set(module.state_dict())
    assert any(k.startswith("dec.mixings.0.ConvBlock_0.") for k in state)
    assert "enc.levels.1.0.BatchNorm_2.running_var" in state
    stray = jax.tree_util.tree_map(lambda a: a, host)
    stray["params"]["dec"]["mixings_0"]["Conv_9"] = {
        "kernel": np.zeros((1, 1, 1, 1), np.float32)}
    with pytest.raises(KeyError, match="Conv_9"):
        state_dict_from_jax(stray, module)
    missing = jax.tree_util.tree_map(lambda a: a, host)
    del missing["batch_stats"]["enc"]["stem_bn"]
    with pytest.raises(KeyError, match="stem_bn"):
        state_dict_from_jax(missing, module)
    wrong = jax.tree_util.tree_map(lambda a: a, host)
    wrong["params"]["dec"]["mixings_0"]["Conv_1"]["kernel"] = np.zeros(
        (3, 3, 8, 16), np.float32)
    with pytest.raises(ValueError, match="Conv_1"):
        state_dict_from_jax(wrong, module)


#: chip_smoke.py's [resnet train]: ResNet-50 v1 (3-4-6-3 bottleneck
#: blocks, 256 -> 2048, base 64) under the five-entry decoder
FULL_DECODER = (1024, 512, 256, 64, 32)


def test_full_width_config_builds_alike_and_keeps_the_size():
    """The ResNet-50 attention U-Net at 256 x 256: the JAX UNet returns
    256 x 256 logits (shapes only, no arithmetic), and both packages have
    the same parameters (the port's built on the meta device)."""
    cfg = attention_unet_config(
        channel_sizes=(256, 512, 1024, 2048), widths=(3, 4, 6, 3), base=64,
        decoder=FULL_DECODER)
    jmodel = build_model(JaxConfigDict, jax_registry, JaxModel, cfg)
    x = jax.ShapeDtypeStruct((1, 256, 256, 3), jnp.float32)
    variables = jax.eval_shape(
        lambda x: jmodel.init(jax.random.key(0), {"x": x}), x)
    out = jax.eval_shape(lambda v, x: jmodel.apply(v, x), variables, x)
    assert out.shape == (1, 256, 256, 1)
    jax_count = sum(int(np.prod(leaf.shape)) for leaf in
                    jax.tree_util.tree_leaves(variables["params"]))
    with torch.device("meta"):
        module = build_model(ConfigDict, registry, Model, cfg).module
    assert sum(p.numel() for p in module.parameters()) == jax_count


@pytest.mark.parametrize("arch", [{"residual_connections": "identity"},
                                  {"layer_scaling": 0.1}])
def test_residual_connections_and_layer_scaling_stay_refused(arch):
    """Residual connections and layer scaling, refused until the residual
    block zoo was ported, now build on the attention U-Net (the decoder's
    side: the external encoder takes none) and give the JAX package's
    output from the same weights, in eval mode."""
    cfg = attention_unet_config()
    cfg["model"]["segmentation.models.UNet"]["architecture"].update(arch)
    jmodel = build_model(JaxConfigDict, jax_registry, JaxModel, cfg)
    variables = _perturbed_stats(jmodel.init(jax.random.key(2), {
        "x": np.zeros((1, SIZE, SIZE, 3), np.float32)}), 3)
    model = build_model(ConfigDict, registry, Model, cfg)
    transplant(variables, model.module)
    names = [n for n, _ in model.module.named_modules()]
    kind = "level_shortcuts" if "residual_connections" in arch \
        else "level_scales"
    assert any(n.startswith(f"dec.{kind}.") for n in names)
    assert not any(n.startswith(("enc.level_shortcuts", "enc.level_scales"))
                   for n in names)
    x, _ = _batch()
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = model.apply(torch.from_numpy(x)).numpy()
    assert relative_error(got, want) <= TOL["float32"]["eval"]
