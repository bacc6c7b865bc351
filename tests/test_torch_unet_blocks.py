"""The port's conv U-Net pieces against the JAX package's, on the CPU in
float32 with transplanted weights: the ``torch.nn.*`` aliases (Conv2d with
every padding form, MaxPool2d, Upsample), the activations, ConvBlock and
UpConvBlock with their BatchNorm, the small U-Net's eval- and train-mode
forward and running statistics, the full-width parameter count, the weight
map with ``batch_stats``, and the wrapper's weight-init schemes and weight
loading.  Module tolerance 1e-5 unless a test says otherwise."""
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medsegpretrainimagenet_tpu.config import ConfigDict as JaxConfigDict
from medsegpretrainimagenet_tpu.config import registry as jax_registry
from medsegpretrainimagenet_tpu.models import Model as JaxModel
from medsegpretrainimagenet_tpu.models import activations as jax_act
from medsegpretrainimagenet_tpu.models import blocks as jax_blocks
from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
from medsegpretrainimagenet_tpu_torch.models import Model, activations, blocks
from medsegpretrainimagenet_tpu_torch.train.checkpoint import save_params_file
from medsegpretrainimagenet_tpu_torch.transfer import state_dict_from_jax

from torch_port_helpers import build_model, transplant, unet_config

TOL = 1e-5


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _pair(jax_module, port_module, x, train=False):
    """Init the flax module on *x*, transplant into the port's module and
    return (flax variables, flax output, port output)."""
    variables = jax_module.init(jax.random.key(0), jnp.asarray(x))
    if variables:
        transplant(variables, port_module)
    port_module.train(train)
    if train:
        ref, _ = jax_module.apply(variables, jnp.asarray(x), train=True,
                                  mutable=["batch_stats"])
    else:
        ref = jax_module.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        out = port_module(torch.from_numpy(x))
    return variables, np.asarray(ref), out.numpy()


@pytest.mark.parametrize("kernel,stride,padding", [
    (3, 1, "same"), (2, 1, "same"), (4, 1, "same"), (3, 1, 1), (3, 1, 0),
    (3, 2, 1), (2, 2, "same"), (3, 2, "same"), ((3, 1), 1, (1, 0)),
    (3, 1, "valid")],
    ids=["3same", "2same", "4same", "3pad1", "3pad0", "3s2pad1", "2s2same",
         "3s2same", "3x1pad", "valid"])
def test_conv2d_matches_jax(kernel, stride, padding):
    """lax SAME with even kernels pads (k/2 - 1, k/2), which the port
    takes as an explicit padding of the input."""
    x = _x(0, (2, 9, 10, 3))
    jax_conv = jax_blocks.Conv2d(in_channels=3, out_channels=5,
                                 kernel_size=kernel, stride=stride,
                                 padding=padding)
    port = blocks.Conv2d(3, 5, kernel, stride=stride, padding=padding)
    _, ref, out = _pair(jax_conv, port, x)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kernel,stride,padding",
                         [(2, None, 0), (3, 2, 1), (3, 1, 1), (2, 1, "same")])
def test_max_pool_and_upsample_match_jax(kernel, stride, padding):
    x = _x(1, (2, 8, 8, 4))
    _, ref, out = _pair(jax_blocks.MaxPool2d(kernel_size=kernel,
                                             stride=stride, padding=padding),
                        blocks.MaxPool2d(kernel, stride, padding), x)
    np.testing.assert_array_equal(out, ref)
    _, ref, out = _pair(jax_blocks.Upsample(scale_factor=2),
                        blocks.Upsample(2), x)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("name", sorted(jax_act.ACTIVATIONS))
def test_activations_match_jax(name):
    x = _x(2, (2, 3, 3, 4))
    _, ref, out = _pair(jax_act.make_activation(name),
                        activations.make_activation(name), x)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_conv_block_matches_jax(train):
    """conv -> BN -> relu twice; in train mode the batch statistics
    normalise and the running averages take the unbiased variance."""
    x = _x(3, (4, 8, 8, 3))
    jax_block = jax_blocks.ConvBlock(in_channels=3, out_channels=6)
    port = blocks.ConvBlock(3, 6)
    variables, ref, out = _pair(jax_block, port, x, train=train)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    if train:
        _, updates = jax_block.apply(variables, jnp.asarray(x), train=True,
                                     mutable=["batch_stats"])
        for i in range(2):
            stats = updates["batch_stats"][f"BatchNorm_{i}"]
            bn = getattr(port, f"BatchNorm_{i}")
            np.testing.assert_allclose(bn.running_mean.numpy(),
                                       np.asarray(stats["mean"]),
                                       rtol=TOL, atol=TOL)
            np.testing.assert_allclose(bn.running_var.numpy(),
                                       np.asarray(stats["var"]),
                                       rtol=TOL, atol=TOL)
            assert int(bn.num_batches_tracked) == 1


def test_up_conv_block_matches_jax():
    """nearest x2, then a 2 x 2 conv with SAME padding (0, 1) per axis."""
    x = _x(4, (2, 5, 6, 8))
    _, ref, out = _pair(jax_blocks.UpConvBlock(in_channels=8,
                                               out_channels=4),
                        blocks.UpConvBlock(8, 4), x)
    assert out.shape == (2, 10, 12, 4)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_dropout2d_drops_whole_channels_per_sample():
    """Dropout2d on NHWC: the mask is (B, 1, 1, C), the kept maps scaled
    by 1 / keep; a generator seeded alike gives the same mask; eval mode
    drops nothing."""
    block = blocks.ConvBlock(3, 16, dropout={"rate": 0.5}).train()
    x = torch.from_numpy(_x(5, (4, 6, 6, 3)))

    def run(seed, rate=0.5):
        block.dropout_rate = rate
        blocks.set_dropout_generator(block,
                                     torch.Generator().manual_seed(seed))
        with torch.no_grad():
            return block(x)

    full = run(0, rate=0.0)
    first, again, other = run(7), run(7), run(8)
    live = full.abs().amax(dim=(1, 2)) > 0     # (B, C) maps relu left
    kept = first.abs().amax(dim=(1, 2)) > 0
    assert torch.equal(kept, kept & live)
    assert kept.any() and (live & ~kept).any()
    torch.testing.assert_close(first, torch.where(
        kept[:, None, None, :], 2 * full, torch.zeros_like(full)))
    assert torch.equal(first, again) and not torch.equal(first, other)
    block.eval()
    with torch.no_grad():
        assert torch.equal(block(x), block(x))


@pytest.fixture(scope="module")
def unet_pair():
    jax_model = build_model(JaxConfigDict, jax_registry, JaxModel,
                            unet_config())
    variables = jax_model.init(jax.random.key(0),
                               {"x": np.zeros((1, 16, 16, 3), np.float32)})
    port = build_model(ConfigDict, registry, Model, unet_config())
    transplant(variables, port.module)
    return jax_model, variables, port


def test_unet_eval_forward_matches_jax(unet_pair):
    jax_model, variables, port = unet_pair
    x = _x(6, (2, 16, 16, 3))
    ref = np.asarray(jax_model.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        out = port.apply(torch.from_numpy(x)).numpy()
    assert out.shape == (2, 16, 16, 1)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_unet_train_forward_and_running_stats_match_jax(unet_pair):
    jax_model, variables, port = unet_pair
    x = _x(7, (3, 16, 16, 3))
    ref, updates = jax_model.apply(variables, jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
    saved = {k: v.clone() for k, v in port.module.state_dict().items()}
    try:
        with torch.no_grad():
            out = port.apply(torch.from_numpy(x), train=True).numpy()
        np.testing.assert_allclose(out, np.asarray(ref), rtol=TOL, atol=TOL)
        want = state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray,
                                   {"params": variables["params"],
                                    "batch_stats": updates["batch_stats"]}),
            port.module)
        got = port.module.state_dict()
        stats = [k for k in got if k.endswith(("running_mean",
                                               "running_var"))]
        assert len(stats) == 2 * 10  # 10 BatchNorms at depth 2
        for k in stats:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=TOL, atol=TOL, err_msg=k)
    finally:
        port.module.load_state_dict(saved)


def test_unet_bf16_forward_matches_jax_bf16(unet_pair):
    """bf16 convs and BatchNorm (float32 statistics and parameters) in both
    packages: bf16 sigmoid outputs, within a few bf16 steps."""
    jax_model, variables, port = unet_pair
    x = _x(8, (2, 16, 16, 3))
    jax_blocks.set_compute_dtype(jnp.bfloat16)
    blocks.set_compute_dtype(torch.bfloat16)
    try:
        ref = jax_model.apply(variables, jnp.asarray(x))
        with torch.no_grad():
            out = port.apply(torch.from_numpy(x))
    finally:
        jax_blocks.set_compute_dtype(None)
        blocks.set_compute_dtype(None)
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=0, atol=2e-2)


@pytest.mark.parametrize("channels", [(4, 8, 16), None],
                         ids=["small", "full_width"])
def test_param_count_matches_jax(channels):
    """The full-width default U-Net (64 -> 1024, depth 4) on the JAX side
    through ``jax.eval_shape`` only."""
    cfg = unet_config(channels) if channels else {"model": {
        "segmentation.models.UNet": {"architecture": {
            "in_channel_size": 3, "out_channel_size": 1, "depth": 4}}}}
    jax_model = build_model(JaxConfigDict, jax_registry, JaxModel, cfg)
    shapes = jax.eval_shape(lambda: jax_model.module.init(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False))
    want = sum(int(np.prod(s.shape))
               for s in jax.tree_util.tree_leaves(shapes["params"]))
    port = build_model(ConfigDict, registry, Model, cfg)
    assert port.get_num_params() == want
    if channels is None:
        assert want == 31_080_449  # unet_256_train


def test_state_dict_from_jax_carries_batch_stats(unet_pair):
    """params and batch_stats into a strict load: mean/var to the running
    buffers, num_batches_tracked filled with 0."""
    jax_model, variables, port = unet_pair
    host = jax.tree_util.tree_map(np.asarray, variables)
    host["batch_stats"]["enc"]["level_convs_0_0"]["BatchNorm_1"]["var"] = \
        np.full(4, 2.5, np.float32)
    mapped = state_dict_from_jax(host, port.module)
    assert set(mapped) == set(port.module.state_dict())
    np.testing.assert_array_equal(
        mapped["enc.level_convs.0.0.BatchNorm_1.running_var"].numpy(),
        np.full(4, 2.5, np.float32))
    assert mapped["enc.level_convs.0.0.BatchNorm_1.num_batches_tracked"] \
        .dtype == torch.long
    fresh = build_model(ConfigDict, registry, Model, unet_config())
    fresh.module.load_state_dict(mapped, strict=True)
    stray = {"params": host["params"], "batch_stats": dict(
        host["batch_stats"], stray={"BatchNorm_0": {"mean": np.zeros(4)}})}
    with pytest.raises(KeyError, match="stray"):
        state_dict_from_jax(stray, port.module)


def _kernels(module):
    return {name: p for name, p in module.named_parameters()
            if name.endswith("weight") and p.ndim == 4}


def test_init_weight_kaiming_normal_default():
    """The U-Net's default ``weight_init`` (kaiming normal, relu): every
    kernel of at least 2048 values has a std within 5 % of sqrt(2 /
    fan_in) with fan_in from the (out, in, kh, kw) layout, the biases of
    those layers are 0, BatchNorm scales keep 1."""
    cfg = ConfigDict(unet_config((16, 32, 64)))
    cfg.expand()
    registry.fill_spec(cfg, "model")
    Model.fill_weight_init_kwargs(cfg["model"].value())
    model = registry.build(cfg, key="model", wrapper=Model)
    model.init(0)
    model.init_weight(cfg["model"].value(), torch.Generator().manual_seed(1))
    checked = 0
    for name, w in _kernels(model.module).items():
        fan_in = w.shape[1] * w.shape[2] * w.shape[3]
        if w.numel() >= 2048:
            assert abs(w.std().item() / math.sqrt(2.0 / fan_in) - 1) < 0.05, \
                name
            checked += 1
        assert torch.equal(model.module.get_parameter(name[:-6] + "bias"),
                           torch.zeros(w.shape[0]))
    assert checked >= 10
    state = model.module.state_dict()
    assert torch.equal(state["enc.level_convs.0.0.BatchNorm_0.weight"],
                       torch.ones(16))


@pytest.mark.parametrize("scheme,check", [
    ({"glorot uniform": {"gain": 1.0}},
     lambda w, fi, fo: w.abs().max() <= math.sqrt(6 / (fi + fo))),
    ({"constant": {"value": 0.25, "bias_init": 0.5}},
     lambda w, fi, fo: bool((w == 0.25).all())),
    ({"torch default": {}}, None)],
    ids=["glorot_uniform", "constant_bias", "torch_default"])
def test_init_weight_schemes(scheme, check):
    model = build_model(ConfigDict, registry, Model, unet_config())
    before = {k: v.clone() for k, v in model.init(0).items()}
    cfg = ConfigDict({"weight_init": scheme})
    Model.fill_weight_init_kwargs(cfg)
    model.init_weight(cfg, torch.Generator().manual_seed(2))
    for name, w in _kernels(model.module).items():
        bias = model.module.get_parameter(name[:-6] + "bias")
        if check is None:
            assert torch.equal(w, before[name])
            continue
        fan_in = w.shape[1] * w.shape[2] * w.shape[3]
        fan_out = w.shape[0] * w.shape[2] * w.shape[3]
        assert check(w, fan_in, fan_out), name
        fill = 0.5 if "constant" in scheme else 0.0
        assert bool((bias == fill).all()), name


def test_load_weights_strict_and_warned(tmp_path):
    """A framework checkpoint loads params and BN statistics; a strict
    load with a stray or missing parameter raises and writes nothing; a
    non-strict one warns; missing BN statistics only warn."""
    source = build_model(ConfigDict, registry, Model, unet_config())
    state = {k: v.clone() for k, v in source.init(3).items()}
    state["enc.level_convs.0.0.BatchNorm_0.running_var"].fill_(3.0)
    path = str(tmp_path / "w.pt")
    save_params_file(path, state)
    model = build_model(ConfigDict, registry, Model, unet_config())
    model.init(4)
    model.load_weights(path)
    for k, v in model.module.state_dict().items():
        assert torch.equal(v, state[k]), k

    bad = dict(state, stray=torch.zeros(2))
    bad.pop("dec.final.Conv_0.bias")
    save_params_file(str(tmp_path / "bad.pt"), bad)
    fresh = build_model(ConfigDict, registry, Model, unet_config())
    before = {k: v.clone() for k, v in fresh.init(5).items()}
    with pytest.raises(KeyError, match="stray"):
        fresh.load_weights(str(tmp_path / "bad.pt"))
    for k, v in fresh.module.state_dict().items():
        assert torch.equal(v, before[k]), k
    with pytest.warns(UserWarning) as record:
        fresh.load_weights(str(tmp_path / "bad.pt"), strict=False)
    messages = " ".join(str(w.message) for w in record)
    assert "Missing keys" in messages and "Unexpected keys" in messages
    assert torch.equal(fresh.module.state_dict()["dec.final.Conv_0.weight"],
                       state["dec.final.Conv_0.weight"])

    no_stats = {k: v for k, v in state.items() if "running" not in k}
    save_params_file(str(tmp_path / "params_only.pt"), no_stats)
    with pytest.warns(UserWarning, match="BN running stats missing"):
        fresh.load_weights(str(tmp_path / "params_only.pt"))

    sub = {k[len("enc."):]: v for k, v in state.items()
           if k.startswith("enc.")}
    save_params_file(str(tmp_path / "enc.pt"), sub)
    cfg = ConfigDict({"weight_init": {"weights": {
        "enc": str(tmp_path / "enc.pt")}}})
    other = build_model(ConfigDict, registry, Model, unet_config())
    other.init(6)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        other.init_weight(cfg)
    assert torch.equal(other.module.state_dict()[
        "enc.level_convs.0.0.Conv_0.weight"],
        state["enc.level_convs.0.0.Conv_0.weight"])


def test_init_weight_path_form_and_encoder_transfer(tmp_path):
    """A bare checkpoint path as ``weight_init`` loads it strictly; encoder
    transfer grafts a pretraining checkpoint's ``layers.0.`` subtree into
    the U-Net's encoder and leaves the decoder as it was."""
    source = build_model(ConfigDict, registry, Model, unet_config())
    state = {k: v.clone() for k, v in source.init(7).items()}
    path = str(tmp_path / "w.pt")
    save_params_file(path, state)
    model = build_model(ConfigDict, registry, Model, unet_config())
    model.init(8)
    model.init_weight(ConfigDict({"weight_init": path}))
    for k, v in model.module.state_dict().items():
        assert torch.equal(v, state[k]), k
    pretrain = str(tmp_path / "pretrain.pt")
    save_params_file(pretrain, {f"layers.0.{k[len('enc.'):]}": v
                                for k, v in state.items()
                                if k.startswith("enc.")})
    model.init(9)
    model.init_weight(ConfigDict({"weight_init": {
        "random": "he normal", "encoder": {"weights": pretrain}}}))
    for k, v in model.module.state_dict().items():
        if k.startswith("enc.") and not k.endswith("num_batches_tracked"):
            assert torch.equal(v, state[k]), k
        elif k.startswith("dec.") and ".Conv_0.weight" in k:
            assert not torch.equal(v, state[k]), k


def test_freeze_and_unfreeze_mask():
    """``freeze_weights: encoder`` freezes every ``enc.`` parameter; the
    mask feeds the optimizer and the trainable count."""
    model = build_model(ConfigDict, registry, Model, unet_config())
    model.freeze_and_unfreeze(ConfigDict({"weight_init": {
        "freeze_weights": ("encoder", "dec.final")}}))
    mask = model.trainable_mask()
    assert set(mask) == {n for n, _ in model.module.named_parameters()}
    assert all(mask[n] == (not n.startswith(("enc.", "dec.final.")))
               for n in mask)
    frozen = sum(p.numel() for n, p in model.module.named_parameters()
                 if not mask[n])
    assert model.get_num_params(trainable_only=True) \
        == model.get_num_params() - frozen
    model.freeze_and_unfreeze(ConfigDict({"weight_init": {
        "freeze_weights": "all", "unfreeze_weights": "all"}}))
    assert all(model.trainable_mask().values())
