"""Training the Swin U-Net in the port, on the CPU.

* Every draw of a training forward (dropout in PatchEmbed, Mlp and
  WindowAttention, attention dropout, stochastic depth, the classification
  drop path of ``DeepResNet``) comes from the generator the train step
  sets: a Swin U-Net step at stochastic depth 0.2 from one ``TrainState``
  repeats bit for bit under another global torch seed, and a state with
  another seed steps elsewhere.
* ``train=True`` reaches the attention dispatch (``window_attention_core``,
  ``fused_image_window_attention``); on a CPU tensor it is the plain
  version.
* The small Swin U-Net of ``tests/test_model_families_e2e.py`` (32 x 32,
  embed 8, heads (2, 4), window 4, depth 1, width 2: level 0 runs masked
  SW-MSA) in train mode against the JAX package's: the output and the
  gradient of every parameter (the pull-back of one cotangent through
  ``jax.vjp`` and autograd), with the attention on its plain autograd
  path, through K1's autograd Function (the kernel's forward, here its
  plain version, and the recompute backward ``window_attention_backward``)
  and through K2's under ``set_fused_image_mode("on")``; and the Dice loss
  and ``jax.grad`` of it end to end."""
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
from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
from medsegpretrainimagenet_tpu_torch.losses import DiceLoss, Loss
from medsegpretrainimagenet_tpu_torch.models import Model, blocks, resnet, swin
from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa
from medsegpretrainimagenet_tpu_torch.optim import Optimizer
from medsegpretrainimagenet_tpu_torch.train import TrainState, make_train_step
from medsegpretrainimagenet_tpu_torch.transfer import state_dict_from_jax

from torch_port_helpers import (build_model, hold_model, model_config,
                                relative_error, transplant)

#: relative bar (max |port - JAX| over max |JAX|) on the output, the Dice
#: loss and every parameter's gradient in float32 (they read at most 2.3e-6)
TOL = 1e-5
SIZE, IMAGES = 32, 4
#: tests/test_model_families_e2e.py's Swin U-Net
SMALL = dict(img=SIZE, embed=8, channels=(8, 16), heads=(2, 4), window=4)


def _config(rate=0.0):
    cfg = model_config(**SMALL)
    arch = cfg["model"]["segmentation.models.UNet"]["architecture"]
    arch["stochastic depth rate"] = rate
    return cfg


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((IMAGES, SIZE, SIZE, 3)).astype(np.float32)
    mask = np.zeros((IMAGES, SIZE, SIZE), np.int32)
    mask[:, 6:20, 12:26] = 1
    return x, mask


# ---------------------------------------------------------------------------
# the generator fault, repaired
# ---------------------------------------------------------------------------

def _one_step(state_seed, global_seed):
    """One SGD step of the small Swin U-Net at stochastic depth 0.2 from
    the same initial weights; its parameters after the step."""
    model = build_model(ConfigDict, registry, Model, _config(0.2))
    model.init(7)
    optimizer = Optimizer(ConfigDict({"sgd": {"learning_rate": {
        "constant": {"base": 0.5}}}}), num_epochs=1, batches_per_epoch=1)
    state = TrainState.create(model.module, optimizer.init(model.module),
                              seed=state_seed)
    step = make_train_step(model, Loss(DiceLoss, ConfigDict(
        {"label type": "mask"})), None, optimizer)
    x, mask = _batch()
    torch.manual_seed(global_seed)
    step(state, None, {"x": torch.from_numpy(x)[None],
                       "mask": torch.from_numpy(mask)[None]})
    return {k: v.clone() for k, v in model.module.state_dict().items()}


def test_swin_step_draws_only_from_the_state_generator():
    """The drop-path masks of a Swin U-Net step come from the state's
    generator: another global torch seed gives the same parameters bit for
    bit, another state seed other ones."""
    first = _one_step(state_seed=3, global_seed=0)
    again = _one_step(state_seed=3, global_seed=1)
    other = _one_step(state_seed=4, global_seed=0)
    assert all(torch.equal(first[k], again[k]) for k in first)
    assert any(not torch.equal(first[k], other[k]) for k in first)


def _stochastic_modules():
    """(module in train mode, input) per kind of draw of the port."""
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.normal(size=(4, 16, 8)).astype(np.float32))
    image = torch.from_numpy(rng.normal(size=(4, 8, 8, 8)).astype(np.float32))
    return {
        "patch_embed": (swin.PatchEmbed(8, 8, patch_size=2, drop_rate=0.5),
                        image),
        "mlp": (swin.Mlp(in_features=8, hidden_features=16, drop=0.5),
                tokens),
        "attention_dropout": (swin.WindowAttention(
            dim=8, window_size=(4, 4), num_heads=2, attn_drop=0.5), tokens),
        "projection_dropout": (swin.WindowAttention(
            dim=8, window_size=(4, 4), num_heads=2, proj_drop=0.5), tokens),
        "stochastic_depth": (swin.SwinTransformerBlock(
            in_channels=8, img_size=16, patch_size=4, embed_dim=8,
            num_heads_layers=(2,), window_size=4,
            stochastic_depth_rate=0.5), tokens),
        "conv_block_dropout": (blocks.ConvBlock(8, 8, dropout={"rate": 0.5}),
                               image),
        "resnet_drop_path": (resnet.DeepResNet(
            channel_sizes=(8, 16), widths=(2, 2), in_channels=8,
            base_channel_size=8, stochastic_depth_rate=0.9), image),
    }


@pytest.mark.parametrize("kind", list(_stochastic_modules()))
def test_every_draw_takes_the_step_generator(kind):
    """Each drawing module repeats under its generator whatever the global
    seed, differs under another generator seed, and says that it draws
    (``blocks.draws``, what the train step's ``uses_rng`` reads)."""
    module, x = _stochastic_modules()[kind]
    module.train()
    assert blocks.draws(module)

    def run(seed, global_seed):
        blocks.set_dropout_generator(module,
                                     torch.Generator().manual_seed(seed))
        torch.manual_seed(global_seed)
        with torch.no_grad():
            out = module(x)
        return out[0] if isinstance(out, tuple) else out
    first = run(5, 0)
    assert torch.equal(first, run(5, 1))
    assert not torch.equal(first, run(6, 0))


def test_a_model_without_rates_does_not_draw():
    model = build_model(ConfigDict, registry, Model, _config(0.0))
    assert not blocks.draws(model.module)
    assert blocks.draws(build_model(ConfigDict, registry, Model,
                                    _config(0.1)).module)


# ---------------------------------------------------------------------------
# the train flag at the attention dispatch
# ---------------------------------------------------------------------------

def test_train_flag_reaches_the_dispatch(monkeypatch):
    """``train=True`` on a CPU tensor is the plain version; a CUDA tensor
    takes the kernel in training as in inference, the plain version only
    under ``force="torch"``; ``force`` is checked."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert wa._impl(None, cpu) == wa._impl("torch", cpu) == "torch"
    assert wa._impl(None, cuda) == "kernel"
    assert wa._impl("torch", cuda) == "torch"
    with pytest.raises(ValueError, match="force"):
        wa._impl("pallas", cpu)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 2, 16, 4),
                                                    np.float32))
               for _ in range(3))
    bias = torch.from_numpy(rng.standard_normal((2, 16, 16), np.float32))
    plain = wa.window_attention_torch(q, k, v, bias, None, 0.5)
    for train in (True, False):
        assert torch.equal(wa.window_attention_core(q, k, v, bias, None, 0.5,
                                                    train=train), plain)
    calls = []
    monkeypatch.setattr(swin, "window_attention_core",
                        lambda *a, **k: calls.append(k) or
                        wa.window_attention_torch(*a))
    attention = swin.WindowAttention(dim=8, window_size=(4, 4), num_heads=2)
    tokens = torch.zeros(2, 16, 8)
    attention.train()(tokens)
    attention.eval()(tokens)
    assert calls == [{"train": True}, {"train": False}]


# ---------------------------------------------------------------------------
# the small Swin U-Net against jax.grad
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    jmodel = build_model(JaxConfigDict, jax_registry, JaxModel, _config())
    variables = jmodel.init(jax.random.key(0), {
        "x": np.zeros((1, SIZE, SIZE, 3), np.float32)})
    return jmodel, variables


def _kernel_routes(monkeypatch, route, counts):
    """Send the Swin blocks' attention through K1's or K2's autograd
    Function (forward: the kernel's wrapper, here its plain version on the
    CPU tensor; backward: the recompute), counting the forwards."""
    def plain_k1(q, k, v, bias, mask, scale):
        counts["k1"] += 1
        return wa.window_attention_torch(q, k, v, bias, mask, scale)

    def plain_k2(qkv, bias, mask, scale, window):
        counts["k2"] += 1
        return wa.image_attention_torch(qkv, bias, mask, scale, window)
    monkeypatch.setattr(wa, "window_attention_cuda", plain_k1)
    monkeypatch.setattr(wa, "image_attention_cuda", plain_k2)
    if route == "k1_recompute":
        monkeypatch.setattr(
            swin, "window_attention_core",
            lambda q, k, v, bias, mask, scale, train:
            wa._WindowAttentionKernel.apply(q, k, v, bias, mask, scale))
    else:
        wa.set_fused_image_mode("on")
        monkeypatch.setattr(
            swin, "fused_image_window_attention",
            lambda qkv, bias, mask, scale, window, train:
            wa._ImageAttentionKernel.apply(qkv, bias, mask, scale, window))


@pytest.mark.parametrize("route", ["plain", "k1_recompute", "k2_recompute"])
def test_swin_unet_gradients_match_jax(pair, monkeypatch, route):
    """Train mode at rate 0: the output and every parameter's gradient
    (the bias table's through the gather of the relative-position index)
    within TOL; on the kernel routes every one of the 6 blocks' forwards
    went through the autograd Function."""
    jmodel, variables = pair
    counts = {"k1": 0, "k2": 0}
    if route != "plain":
        _kernel_routes(monkeypatch, route, counts)
    try:
        model = build_model(ConfigDict, registry, Model, _config())
        transplant(variables, model.module)
        x, _ = _batch()
        cotangent = np.random.default_rng(2).normal(
            size=(IMAGES, SIZE, SIZE, 1)).astype(np.float32)
        errors = hold_model(jmodel, variables, model.module, x, cotangent,
                            True, "float32")
    finally:
        wa.set_fused_image_mode("off")
    assert any("relative_position_bias_table" in k for k in errors)
    worst = max(errors, key=errors.get)
    assert errors[worst] < TOL, (worst, errors[worst])
    assert counts == {"plain": {"k1": 0, "k2": 0},
                      "k1_recompute": {"k1": 6, "k2": 0},
                      "k2_recompute": {"k1": 0, "k2": 6}}[route]


def test_swin_unet_dice_loss_and_its_gradient_match_jax(pair):
    """The Dice loss of the train-mode forward and ``jax.grad`` of it, end
    to end, within TOL."""
    jmodel, variables = pair
    x, mask = _batch()
    jloss = JaxLoss(JaxDiceLoss, JaxConfigDict({"label type": "mask"}))
    want, grads = jax.value_and_grad(lambda p: jloss(
        jmodel.apply({"params": p}, x, train=True),
        {"mask": jnp.asarray(mask)}))(variables["params"])

    model = build_model(ConfigDict, registry, Model, _config())
    transplant(variables, model.module)
    model.module.train()
    value = Loss(DiceLoss, ConfigDict({"label type": "mask"}))(
        model.module(torch.from_numpy(x)), {"mask": torch.from_numpy(mask)})
    value.backward()
    assert relative_error(value.item(), want) < TOL
    want_grads = state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": grads}), model.module)
    for name, p in model.module.named_parameters():
        assert relative_error(p.grad.numpy(), want_grads[name]) < TOL, name
