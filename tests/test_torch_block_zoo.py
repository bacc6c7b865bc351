"""The port's residual block zoo against the JAX package's, on the CPU in
float32 with transplanted weights.

* Each block in float64 (``ResNeXtBlock``, ``InvertedBottleneckBlock``,
  ``ConvNeXtBlock`` with each channel-change index, the full norm and
  activation count and another registered norm, ``LayerScale``,
  ``ChannelwiseLayerNorm``) and each ``ResConnection`` mode (identity as it
  is, ``fill_with_zeros``, ``repeat``, ``add``, ``cut_off``; the 1 x 1
  projection with BatchNorm, a 3 x 3 one with ReLU and stride 2): the
  train-mode output, every parameter's gradient (the pull-back of one
  cotangent) and the running statistics within 1e-5.  ``add`` sums the
  channel groups ``c, c + cout, ...`` (12 -> 4).
* The U-Net with ``residual_connections`` and ``layer_scaling`` per block
  kind: three SGD steps against the JAX step within 1e-4, the drop paths
  of the residual branches fed in alike to both (a fixed per-sample mask
  per rate); the parameter count equal, the port's built on the meta
  device; the weight-init schemes reach the grouped kernels and the layer
  scales as the JAX package's do; the drop paths draw from the step's
  generator.
Module tolerance 1e-5 (in float64), steps 1e-4 (in float32)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medsegpretrainimagenet_tpu.config import ConfigDict as JaxConfigDict
from medsegpretrainimagenet_tpu.config import registry as jax_registry
from medsegpretrainimagenet_tpu.losses import DiceLoss as JaxDiceLoss
from medsegpretrainimagenet_tpu.losses import Loss as JaxLoss
from medsegpretrainimagenet_tpu.metrics import \
    MetricsCalculator as JaxCalculator
from medsegpretrainimagenet_tpu.models import Model as JaxModel
from medsegpretrainimagenet_tpu.models import blocks as jax_blocks
from medsegpretrainimagenet_tpu.models import init as jax_init
from medsegpretrainimagenet_tpu.optim import Optimizer as JaxOptimizer
from medsegpretrainimagenet_tpu.train import TrainState as JaxTrainState
from medsegpretrainimagenet_tpu.train import \
    make_train_step as jax_train_step
from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
from medsegpretrainimagenet_tpu_torch.losses import DiceLoss, Loss
from medsegpretrainimagenet_tpu_torch.metrics import MetricsCalculator
from medsegpretrainimagenet_tpu_torch.models import Model, blocks
from medsegpretrainimagenet_tpu_torch.models.init import apply_init
from medsegpretrainimagenet_tpu_torch.optim import Optimizer
from medsegpretrainimagenet_tpu_torch.train import TrainState, make_train_step
from medsegpretrainimagenet_tpu_torch.transfer import state_dict_from_jax

from torch_port_helpers import (build_model, hold_model, relative_error,
                                transplant, unet_config)

TOL, STEP_TOL = 1e-5, 1e-4
#: the modules are held in float64 (JAX's x64 and the port's module in
#: double): flax's one-pass batch variance rounds in float32 to about the
#: bar itself (1.2e-5 on a BatchNorm scale's gradient in ResNeXt)
DTYPE = "float64"
B = "segmentation.models.blocks."


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _pre_norm_bias(state, name: str) -> bool:
    """The bias of a conv whose output a BatchNorm normalises: its
    gradient is zero up to rounding."""
    parent, _, leaf = name.rpartition(".")
    if leaf != "bias" or ".Conv_" not in f".{parent}":
        return False
    module, _, conv = parent.rpartition(".")
    bn = f"{module}.BatchNorm_{conv.split('_')[1]}.weight".lstrip(".")
    return bn in state


def _identity(**params):
    return {"identity": params}


MODULES = {
    "resnext": (12, 8, lambda c: c.ResNeXtBlock(
        in_channels=12, out_channels=8)),
    "inverted_bottleneck": (12, 8, lambda c: c.InvertedBottleneckBlock(
        in_channels=12, out_channels=8, kernel_size=5)),
    "convnext": (12, 24, lambda c: c.ConvNeXtBlock(
        in_channels=12, out_channels=24)),
    "convnext_full_index2": (12, 24, lambda c: c.ConvNeXtBlock(
        in_channels=12, out_channels=24, reduce_number_of_activations=False,
        reduce_number_of_norm_layers=False, channel_change_index=2)),
    "convnext_index3_torch_layer_norm": (12, 6, lambda c: c.ConvNeXtBlock(
        in_channels=12, out_channels=6, channel_change_index=3,
        reduce_number_of_norm_layers=False,
        normalisation="torch.nn.LayerNorm")),
    "layer_scale": (12, 12, lambda c: c.LayerScale(n_channels=12,
                                                   init_value=0.1)),
    "channelwise_layer_norm": (12, 12, lambda c: c.ChannelwiseLayerNorm(
        num_features=12)),
}
SHORTCUTS = {
    "identity": (8, 8, "identity", False),
    "fill_with_zeros": (4, 12, _identity(expand_method="fill_with_zeros"),
                        False),
    "repeat": (4, 12, _identity(expand_method="repeat"), False),
    "add": (12, 4, _identity(contract_method="add"), False),
    "cut_off": (12, 4, _identity(contract_method="cut_off"), False),
    "projection": (6, 8, {"convolution": {"kernel_size": 1,
                                          "batch_norm": True,
                                          "activation": False}}, False),
    "projection_3x3_relu_downsampling": (
        6, 8, {"conv": {"kernel_size": 3, "batch_norm": False,
                        "activation": True}}, True),
}


def _shortcut(package, name):
    cin, cout, cfg, down = SHORTCUTS[name]
    cd = JaxConfigDict if package is jax_blocks else ConfigDict
    return cin, cout, package.ResConnection(
        in_channels=cin, out_channels=cout, downsampling=down,
        type_config=cfg if isinstance(cfg, str) else cd(cfg))


def _hold(jax_module, port_module, cin, cout, seed):
    """{name: relative error} of the output and the gradients (of the
    parameters, or of the input for a module without any)."""
    x = _x(seed, (3, 8, 8, cin))
    variables = jax_module.init(jax.random.key(seed), jnp.asarray(x))
    out_shape = jax.eval_shape(lambda v: jax_module.apply(
        v, jnp.asarray(x)), variables).shape
    cotangent = _x(seed + 1, out_shape)
    if not variables:
        with jax.enable_x64(True):
            want, pull = jax.vjp(lambda a: jax_module.apply({}, a),
                                 jnp.asarray(x, DTYPE))
            grad = pull(jnp.asarray(cotangent, DTYPE))[0]
        inputs = torch.from_numpy(x.astype(DTYPE)).requires_grad_()
        out = port_module(inputs)
        out.backward(torch.from_numpy(cotangent.astype(DTYPE)))
        return {"output": relative_error(out.detach(), want),
                "input": relative_error(inputs.grad, grad)}, out_shape
    # parameters away from their constant initial values: a zero
    # BatchNorm bias before a ReLU and a per-channel conv would leave
    # the output invariant to the BatchNorm's scale
    rng = np.random.default_rng(seed)
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.2 * rng.standard_normal(a.shape).astype(
            np.float32), jax.tree_util.tree_map(np.asarray, variables))
    variables["batch_stats"] = jax.tree_util.tree_map(
        np.abs, variables.get("batch_stats", {}))
    transplant(variables, port_module)
    errors = hold_model(jax_module, variables, port_module, x, cotangent,
                        train=True, dtype=DTYPE,
                        skip=lambda n: _pre_norm_bias(
                            port_module.state_dict(), n))
    return errors, out_shape


@pytest.mark.parametrize("name", list(MODULES))
def test_block_matches_jax(name):
    cin, cout, make = MODULES[name]
    errors, shape = _hold(make(jax_blocks), make(blocks), cin, cout, 0)
    assert shape[-1] == cout
    worst = max(errors, key=errors.get)
    assert errors[worst] <= TOL, (worst, errors[worst])


@pytest.mark.parametrize("name", list(SHORTCUTS))
def test_res_connection_matches_jax(name):
    cin, cout, jax_module = _shortcut(jax_blocks, name)
    _, _, port_module = _shortcut(blocks, name)
    errors, shape = _hold(jax_module, port_module, cin, cout, 1)
    assert shape[-1] == cout
    worst = max(errors, key=errors.get)
    assert errors[worst] <= TOL, (worst, errors[worst])


def test_add_sums_the_channel_groups():
    """12 -> 4 by ``add``: output channel c is x[c] + x[c + 4] + x[c + 8],
    not the sum of four neighbours, which has the same shape."""
    _, _, port_module = _shortcut(blocks, "add")
    x = torch.from_numpy(_x(2, (2, 3, 3, 12)))
    out = port_module(x)
    torch.testing.assert_close(out, x[..., 0:4] + x[..., 4:8] + x[..., 8:12])
    assert not torch.allclose(out, x.reshape(2, 3, 3, 4, 3).sum(-1))


@pytest.mark.parametrize("cfg, down, error", [
    ("identity", True, NotImplementedError),
    ({"identity": {"expand_method": "other"}}, False, ValueError),
    ({"identity": {"contract_method": "add"}}, False, ValueError),
    ({"pooling": {}}, False, ValueError)])
def test_res_connection_refusals_match_jax(cfg, down, error):
    """Identity under downsampling, unknown methods, ``add`` from channels
    that do not divide, an unknown kind: both packages refuse."""
    cin, cout = (4, 12) if "expand" in str(cfg) else (10, 4)
    with pytest.raises(error):
        jax_blocks.ResConnection(
            in_channels=cin, out_channels=cout, downsampling=down,
            type_config=cfg if isinstance(cfg, str) else JaxConfigDict(cfg)
        ).init(jax.random.key(0), jnp.zeros((1, 4, 4, cin)))
    with pytest.raises(error):
        blocks.ResConnection(cin, cout, down, cfg if isinstance(cfg, str)
                             else ConfigDict(cfg))


def test_layer_scale_keeps_bf16_and_its_float32_parameter():
    scale = blocks.LayerScale(4, init_value=0.5)
    x = torch.ones(2, 3, 3, 4, dtype=torch.bfloat16)
    out = scale(x)
    assert out.dtype == torch.bfloat16 and scale.weight.dtype == torch.float32
    assert torch.equal(out, torch.full_like(x, 0.5))


# ---------------------------------------------------------------------------
# the U-Net with residual connections and layer scaling
# ---------------------------------------------------------------------------

STEPS, IMAGES, SIZE = 3, 4, 16
UNETS = {
    "resnext_identity": (B + "ResNeXtBlock", "identity"),
    "inverted_bottleneck_convolution": (B + "InvertedBottleneckBlock",
                                        "convolution"),
    "convnext_repeat_and_projection": (B + "ConvNeXtBlock", {
        "down": {"identity": {"expand_method": "repeat"}},
        "up": {"convolution": {"kernel_size": 3}}}),
}
OPTIMIZER = {"sgd": {"momentum": 0.9, "learning_rate": {
    "constant": {"base": 0.05}}}}
METRICS = {"metrics": {"metrics": ("metrics.DiceIndex",),
                       "calculation": {"thresholds": 0.5}}}


def _unet(kind, rate=0.1):
    block, residual = UNETS[kind]
    return unet_config((8, 16, 32), basic_block=block, width=2,
                       residual_connections=residual, layer_scaling=0.1,
                       **{"stochastic depth rate": rate})


def _keep(batch: int, rate: float) -> np.ndarray:
    """The fed-in drop-path mask: which samples keep the branch, a fixed
    pattern per rate."""
    return (np.arange(batch) + round(rate * 1000)) % 3 != 0


def _jax_drop_path(module, x, rate, train):
    if rate == 0.0 or not train:
        return x
    keep = _keep(x.shape[0], rate).reshape((-1,) + (1,) * (x.ndim - 1))
    return jnp.where(keep, x / (1.0 - rate), jnp.zeros_like(x))


def _port_drop_path(x, rate, training, generator):
    if rate == 0.0 or not training:
        return x
    keep = torch.from_numpy(_keep(x.shape[0], rate)).reshape(
        (-1,) + (1,) * (x.ndim - 1))
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        x = (rng.random((IMAGES, SIZE, SIZE, 3)) * 90).astype(np.uint8)
        mask = np.zeros((IMAGES, SIZE, SIZE), np.uint8)
        for i in range(IMAGES):
            r, c = rng.integers(2, SIZE - 8, 2)
            x[i, r:r + 6, c:c + 6] += 150
            mask[i, r:r + 6, c:c + 6] = 1
        out.append({"x": x[None], "mask": mask[None]})
    return out


@pytest.mark.parametrize("kind", list(UNETS))
def test_three_steps_match_jax(kind, monkeypatch):
    monkeypatch.setattr(jax_blocks, "drop_path", _jax_drop_path)
    monkeypatch.setattr(blocks, "drop_path", _port_drop_path)
    cfg = _unet(kind)
    jmodel = build_model(JaxConfigDict, jax_registry, JaxModel, cfg)
    variables = jmodel.init(jax.random.key(0), {
        "x": np.zeros((1, SIZE, SIZE, 3), np.float32)})
    batches = _batches()

    optimizer = JaxOptimizer(JaxConfigDict(OPTIMIZER), num_epochs=1,
                             batches_per_epoch=STEPS)
    jstate = JaxTrainState.create(
        variables, optimizer.tx.init(variables["params"]), jax.random.key(1))
    jloss = JaxLoss(JaxDiceLoss, JaxConfigDict({"label type": "mask"}))
    jcalc = JaxCalculator(JaxConfigDict(METRICS), loss=jloss)
    jstep = jax_train_step(jmodel, jloss, jcalc, optimizer, donate=False)
    jmetrics, jlogs = jcalc.init_state(), []
    for batch in batches:
        jstate, jmetrics, per_batch = jstep(jstate, jmetrics, batch)
        jlogs.append(jax.device_get(per_batch))

    model = build_model(ConfigDict, registry, Model, cfg)
    transplant(variables, model.module)
    assert blocks.draws(model.module)
    port_opt = Optimizer(ConfigDict(OPTIMIZER), num_epochs=1,
                         batches_per_epoch=STEPS)
    state = TrainState.create(model.module, port_opt.init(model.module),
                              seed=1)
    loss = Loss(DiceLoss, ConfigDict({"label type": "mask"}))
    calc = MetricsCalculator(ConfigDict(METRICS), loss=loss)
    step = make_train_step(model, loss, calc, port_opt)
    metrics, logs = calc.init_state("cpu"), []
    for batch in batches:
        state, metrics, per_batch = step(
            state, metrics, {k: torch.from_numpy(v) for k, v in batch.items()})
        logs.append(per_batch)

    for k, (got, want) in enumerate(zip(logs, jlogs)):
        for key in ("dice_loss", "gradient_magnitude"):
            np.testing.assert_allclose(got[key].item(), float(want[key]),
                                       rtol=STEP_TOL, atol=STEP_TOL,
                                       err_msg=f"{kind} step {k} {key}")
    want = transplant({"params": jstate.params,
                       "batch_stats": jstate.batch_stats},
                      build_model(ConfigDict, registry, Model,
                                  cfg).module).state_dict()
    got = model.module.state_dict()
    compared = 0
    for name, value in got.items():
        if _pre_norm_bias(got, name) or name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                   rtol=STEP_TOL, atol=STEP_TOL,
                                   err_msg=f"{kind} {name}")
        compared += 1
    assert compared > 60
    assert any("level_scales" in n for n in got)
    assert any("shortcuts" in n for n in got) \
        == (kind != "resnext_identity")


@pytest.mark.parametrize("kind", list(UNETS))
def test_parameter_count_matches_jax(kind):
    """At full width: the default ladder 64 -> 1024 at depth 4, width 2,
    the JAX side through ``jax.eval_shape`` only, the port's module on
    the meta device."""
    block, residual = UNETS[kind]
    cfg = {"model": {"segmentation.models.UNet": {"architecture": {
        "in_channel_size": 3, "out_channel_size": 1, "depth": 4, "width": 2,
        "basic_block": block, "residual_connections": residual,
        "layer_scaling": 1e-6}}}}
    jmodel = build_model(JaxConfigDict, jax_registry, JaxModel, cfg)
    shapes = jax.eval_shape(lambda: jmodel.module.init(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False))
    want = sum(int(np.prod(s.shape))
               for s in jax.tree_util.tree_leaves(shapes["params"]))
    with torch.device("meta"):
        module = build_model(ConfigDict, registry, Model, cfg).module
    assert sum(p.numel() for p in module.parameters()) == want


def test_state_dict_carries_the_new_leaves():
    """Shortcut convs and BatchNorms, layer scales, grouped kernels (kh, kw,
    cin / groups, cout) -> (cout, cin / groups, kh, kw) and the LayerNorms
    of ConvNeXt's channel-wise norms map key by key."""
    cfg = _unet("convnext_repeat_and_projection")
    jmodel = build_model(JaxConfigDict, jax_registry, JaxModel, cfg)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.key(3), {"x": np.zeros((1, SIZE, SIZE, 3), np.float32)}))
    module = build_model(ConfigDict, registry, Model, cfg).module
    mapped = state_dict_from_jax(variables, module)
    assert set(mapped) == set(module.state_dict())
    params = variables["params"]
    np.testing.assert_array_equal(
        mapped["dec.level_scales.0.1.weight"].numpy(),
        params["dec"]["level_scales_0_1"]["scale"])
    depthwise = params["enc"]["level_convs_1_0"]["Conv_0"]["kernel"]
    assert depthwise.shape == (3, 3, 1, 16)
    np.testing.assert_array_equal(
        mapped["enc.level_convs.1.0.Conv_0.weight"].numpy(),
        depthwise.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        mapped["enc.level_convs.0.0.ChannelwiseLayerNorm_0.LayerNorm_0"
               ".weight"].numpy(),
        params["enc"]["level_convs_0_0"]["ChannelwiseLayerNorm_0"][
            "LayerNorm_0"]["scale"])
    np.testing.assert_array_equal(
        mapped["dec.level_shortcuts.1.0.BatchNorm_0.running_var"].numpy(),
        variables["batch_stats"]["dec"]["level_shortcuts_1_0"][
            "BatchNorm_0"]["var"])


def test_init_schemes_reach_grouped_kernels_and_layer_scales():
    """A constant scheme per layer type sets the same parameters in both
    packages (the grouped kernels with the convs, the layer scales with
    the LayerNorm scales, as the JAX package matches leaves); a kaiming
    normal draw gives the depthwise kernels the std of their own fan-in,
    in (out, in / groups, kh, kw) and ``Model.init`` the scales their
    constant."""
    cfg = _unet("resnext_identity")
    scheme = {"torch.nn.Conv2d": {"constant": {"value": 0.25,
                                               "bias_init": 0.5}},
              "torch.nn.LayerNorm": {"constant": {"value": 0.75}}}
    jmodel = build_model(JaxConfigDict, jax_registry, JaxModel, cfg)
    variables = jmodel.init(jax.random.key(0), {
        "x": np.zeros((1, SIZE, SIZE, 3), np.float32)})
    jparams = jax_init.apply_init(variables["params"], JaxConfigDict(scheme),
                                  jax.random.key(1))
    model = build_model(ConfigDict, registry, Model, cfg)
    transplant(variables, model.module)
    apply_init(model.module, ConfigDict(scheme),
               torch.Generator().manual_seed(1))
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, {
        "params": jparams, "batch_stats": variables["batch_stats"]}),
        model.module)
    for name, value in model.module.state_dict().items():
        assert torch.equal(value, want[name]), name
    assert torch.equal(model.module.state_dict()[
        "enc.level_scales.0.0.weight"], torch.full((8,), 0.75))

    wide = build_model(ConfigDict, registry, Model, unet_config(
        (64, 256), basic_block=B + "InvertedBottleneckBlock",
        layer_scaling=0.1))
    wide.init(0)
    state = wide.module.state_dict()
    assert torch.equal(state["enc.level_scales.0.0.weight"],
                       torch.full((64,), 0.1))
    apply_init(wide.module, ConfigDict({"torch.nn.init.kaiming_normal_": {
        "nonlinearity": "relu"}}), torch.Generator().manual_seed(2))
    kernel = wide.module.state_dict()["enc.bottom_convs.0.Conv_1.weight"]
    assert kernel.shape == (1024, 1, 3, 3)
    assert abs(kernel.std().item() / math.sqrt(2.0 / 9) - 1) < 0.05


def test_residual_drop_paths_draw_from_the_step_generator():
    """The encoder's and decoder's residual branches draw their drop paths
    from the generator the train step sets: the same generator seed gives
    the same output whatever the global seed, another seed another one;
    at rate 0 nothing draws."""
    model = build_model(ConfigDict, registry, Model,
                        _unet("resnext_identity", rate=0.5))
    module = model.module.train()
    assert blocks.draws(module.enc) and blocks.draws(module.dec)
    x = torch.from_numpy(_x(4, (4, SIZE, SIZE, 3)))

    def run(seed, global_seed):
        blocks.set_dropout_generator(module,
                                     torch.Generator().manual_seed(seed))
        torch.manual_seed(global_seed)
        with torch.no_grad():
            return module(x)
    first = run(5, 0)
    assert torch.equal(first, run(5, 1))
    assert not torch.equal(first, run(6, 0))
    assert not blocks.draws(build_model(
        ConfigDict, registry, Model, _unet("resnext_identity", 0.0)).module)
