"""The half-output LayerNorm switch of the port (``blocks.set_ln_half_out``,
``HalfOutLayerNorm``, ``make_layer_norm``) against the JAX package's
(``set_ln_half_out``, ``_HalfOutLayerNorm``), on the CPU.

* The LayerNorm on its own, from the same weights and inputs: under a bf16
  compute dtype both packages output bf16 and agree within one bf16 ulp of
  the float32 value; with no compute dtype both output float32, and the
  port's half-out module equals its plain one bit for bit.
* The small Swin U-Net (``tests/test_torch_swin_unet.py``'s) with half-out
  on in both packages: the bf16 eval forward agrees at that file's bar
  (rtol 0, atol 2e-2) on the windows route (K1's plain version) and the
  image-layout route (K2's, ``set_fused_image_mode("on")``), and the
  residual stream between its Swin blocks is bf16.
* A bf16 training step of ``tests/test_model_families_e2e.py``'s Swin
  U-Net (the Dice loss and every parameter's gradient) against the JAX
  step: its worst relative discrepancy with half-out on is at most twice
  the one with half-out off in both packages, the bf16 cross-framework
  discrepancy of today (0.0498 against 0.0574 on either route, the JAX
  step jitted).
* The switch changes no state-dict key: a checkpoint saved with it off
  loads with it on, and a JAX checkpoint of a half-out model maps key by
  key.  It does not reach ``TorchLayerNorm`` and ``ChannelwiseLayerNorm``,
  which output float32 in both packages.
* The defaults, in a fresh process: remat off, half-out off, the fused
  image mode off."""
import subprocess
import sys

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
from medsegpretrainimagenet_tpu.models import blocks as jax_blocks
from medsegpretrainimagenet_tpu.ops import window_attention as jax_wa
from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
from medsegpretrainimagenet_tpu_torch.losses import DiceLoss, Loss
from medsegpretrainimagenet_tpu_torch.models import Model
from medsegpretrainimagenet_tpu_torch.models import blocks as B
from medsegpretrainimagenet_tpu_torch.models import swin
from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa
from medsegpretrainimagenet_tpu_torch.train import checkpoint as ckpt
from medsegpretrainimagenet_tpu_torch.transfer import state_dict_from_jax

from torch_port_helpers import (build_model, model_config, relative_error,
                                torch_switches_kept, transplant)

#: tests/test_torch_swin_unet.py's bar on the bf16 forward (bf16 sigmoid
#: steps of 2^-9 near 0.5, and the two frameworks' rounding points)
FORWARD_ATOL = 2e-2
#: tests/test_model_families_e2e.py's Swin U-Net, for the step
SMALL = dict(img=32, embed=8, channels=(8, 16), heads=(2, 4), window=4)
ROUTES = {"k1": "off", "k2": "on"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One CPU thread for these small tensors; the next file gets the
    thread count back."""
    with torch_switches_kept():
        torch.set_num_threads(1)
        yield


@pytest.fixture(autouse=True)
def switches_off():
    """Every module-level switch set here, off afterwards in both
    packages."""
    try:
        yield
    finally:
        for package in (B, jax_blocks):
            package.set_ln_half_out(False)
            package.set_compute_dtype(None)
            package.set_remat(False)
        wa.set_fused_image_mode("off")
        jax_wa.set_fused_image_mode("off")


def _switches(half_out: bool, bf16: bool = True, route: str = "k1"):
    """Both packages' half-out switch, compute dtype and attention route."""
    for package, dtype in ((B, torch.bfloat16), (jax_blocks, jnp.bfloat16)):
        package.set_ln_half_out(half_out)
        package.set_compute_dtype(dtype if bf16 else None)
    wa.set_fused_image_mode(ROUTES[route])
    jax_wa.set_fused_image_mode(ROUTES[route])


# ---------------------------------------------------------------------------
# the LayerNorm
# ---------------------------------------------------------------------------

def _layer_norm_inputs(dtype):
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal((2, 16, 24)) + 1.0).astype(np.float32)
    scale = (1.0 + 0.5 * rng.standard_normal(24)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(24)).astype(np.float32)
    if dtype == "bfloat16":
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x, scale, bias


def _both_layer_norms(x, scale, bias, in_dtype):
    """(JAX output, port output, port plain LayerNorm's output) from the
    modules that ``make_layer_norm`` builds under the current switches."""
    jax_in = jnp.asarray(x, jnp.bfloat16 if in_dtype == "bfloat16"
                         else jnp.float32)
    jmodule = jax_blocks.make_layer_norm()
    assert type(jmodule).__name__ == "LayerNorm"  # flax's name prefix
    want = jmodule.apply({"params": {"scale": scale, "bias": bias}}, jax_in)
    port = B.make_layer_norm(x.shape[-1])
    plain = B.LayerNorm(x.shape[-1])
    for module in (port, plain):
        with torch.no_grad():
            module.weight.copy_(torch.from_numpy(scale))
            module.bias.copy_(torch.from_numpy(bias))
    port_in = torch.from_numpy(x).to(getattr(torch, in_dtype))
    with torch.no_grad():
        return want, port(port_in), plain(port_in)


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_half_out_layer_norm_is_jaxs_under_bf16(in_dtype):
    _switches(True)
    x, scale, bias = _layer_norm_inputs(in_dtype)
    want, got, plain = _both_layer_norms(x, scale, bias, in_dtype)
    assert isinstance(B.make_layer_norm(4), B.HalfOutLayerNorm)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert plain.dtype == torch.float32
    # one bf16 ulp of the float32 value (8 significant bits)
    exact = plain.numpy().astype(np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(exact), 1e-30))) - 7)
    diff = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32)))
    assert (diff <= ulp).all(), float((diff / ulp).max())
    assert torch.equal(got, plain.to(torch.bfloat16))


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_half_out_layer_norm_without_compute_dtype_is_float32(in_dtype):
    _switches(True, bf16=False)
    x, scale, bias = _layer_norm_inputs(in_dtype)
    want, got, plain = _both_layer_norms(x, scale, bias, in_dtype)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert torch.equal(got, plain)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the Swin U-Net forward and step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    jax_model = build_model(JaxConfigDict, jax_registry, JaxModel,
                            model_config())
    variables = jax.tree_util.tree_map(np.asarray, jax_model.init(
        jax.random.key(0), {"x": np.zeros((1, 64, 64, 3), np.float32)}))
    return jax_model, variables


@pytest.mark.parametrize("route", list(ROUTES))
def test_swin_unet_bf16_forward_with_half_out_matches_jax(pair, route,
                                                           monkeypatch):
    jax_model, variables = pair
    _switches(True, route=route)
    port = transplant(variables, build_model(ConfigDict, registry, Model,
                                             model_config()).module)
    norms = [m for m in port.modules() if isinstance(m, B.LayerNorm)]
    assert norms and all(isinstance(m, B.HalfOutLayerNorm) for m in norms)
    stream, calls = [], []
    for block in port.modules():
        if isinstance(block, swin.SwinTransformerBlock):
            block.register_forward_hook(
                lambda m, args, out: stream.append(out.dtype))
    real = wa.image_attention_torch if route == "k2" \
        else wa.window_attention_torch
    monkeypatch.setattr(wa, real.__name__,
                        lambda *a: calls.append(a[0].dtype) or real(*a))
    x = np.random.default_rng(1).random((2, 64, 64, 3)).astype(np.float32)
    want = jax.jit(jax_model.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert stream and set(stream) == {torch.bfloat16}
    # every block's attention went through the route's plain version, in
    # the compute dtype
    assert calls == [torch.bfloat16] * len(stream)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=FORWARD_ATOL)


def _step_discrepancy(half_out: bool, route: str) -> float:
    """The worst relative discrepancy (max |port - JAX| over max |JAX|)
    of a bf16 training step's Dice loss and parameter gradients, from the
    same weights, with *half_out* in both packages."""
    cfg = model_config(**SMALL)
    cfg["model"]["segmentation.models.UNet"]["architecture"][
        "stochastic depth rate"] = 0.0
    jmodel = build_model(JaxConfigDict, jax_registry, JaxModel, cfg)
    variables = jmodel.init(jax.random.key(0), {
        "x": np.zeros((1, 32, 32, 3), np.float32)})
    rng = np.random.default_rng(0)
    x = rng.random((4, 32, 32, 3)).astype(np.float32)
    mask = np.zeros((4, 32, 32), np.int32)
    mask[:, 6:20, 12:26] = 1
    _switches(half_out, route=route)
    jloss = JaxLoss(JaxDiceLoss, JaxConfigDict({"label type": "mask"}))
    want, grads = jax.jit(jax.value_and_grad(lambda p: jloss(
        jmodel.apply({"params": p}, x, train=True),
        {"mask": jnp.asarray(mask)})))(variables["params"])
    model = build_model(ConfigDict, registry, Model, cfg)
    transplant(variables, model.module).train()
    value = Loss(DiceLoss, ConfigDict({"label type": "mask"}))(
        model.module(torch.from_numpy(x)), {"mask": torch.from_numpy(mask)})
    value.backward()
    want_grads = state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": grads}), model.module)
    errors = [relative_error(value.item(), float(want))]
    errors += [relative_error(p.grad.float().numpy(), want_grads[name])
               for name, p in model.module.named_parameters()]
    return max(errors)


@pytest.mark.parametrize("route", list(ROUTES))
def test_bf16_step_with_half_out_within_twice_the_control(route):
    control = _step_discrepancy(False, route)
    half_out = _step_discrepancy(True, route)
    print(f"{route}: bf16 step against JAX, half-out off {control:.4g}, "
          f"on {half_out:.4g}")
    assert 0 < half_out <= 2 * control, (half_out, control)


# ---------------------------------------------------------------------------
# keys, checkpoints and reach
# ---------------------------------------------------------------------------

def test_half_out_keeps_every_key_and_checkpoint(pair, tmp_path):
    jax_model, variables = pair
    off = build_model(ConfigDict, registry, Model, model_config()).module
    path = tmp_path / "off.pt"
    ckpt.save_params_file(str(path), transplant(variables, off).state_dict())
    _switches(True)
    on = build_model(ConfigDict, registry, Model, model_config()).module
    assert list(on.state_dict()) == list(off.state_dict())
    on.load_state_dict(ckpt.load_params_file(str(path)))
    for key, value in on.state_dict().items():
        assert torch.equal(value, off.state_dict()[key]), key
    # a JAX half-out model's tree is the plain one's
    tree = jax.tree_util.tree_map(np.asarray, jax_model.init(
        jax.random.key(0), {"x": np.zeros((1, 64, 64, 3), np.float32)}))
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(variables)
    assert set(state_dict_from_jax(tree, on)) == set(on.state_dict())


@pytest.mark.parametrize("name", ["TorchLayerNorm", "ChannelwiseLayerNorm"])
def test_half_out_does_not_reach_the_configs_layer_norms(name):
    _switches(True)
    x = np.random.default_rng(2).standard_normal((2, 4, 4, 8)).astype(
        np.float32)
    port = getattr(B, name)(8)
    jax_module = getattr(jax_blocks, name.replace("Torch", ""))(8)
    want = jax_module.apply(jax_module.init(jax.random.key(0), x), x)
    with torch.no_grad():
        got = port(torch.from_numpy(x).to(torch.bfloat16))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert type(port.LayerNorm_0) is B.LayerNorm


def test_the_switches_default_off():
    """In a fresh process: remat off, half-out off (``make_layer_norm``
    builds the plain LayerNorm), and the fused image mode off (a bf16
    no-grad forward on the card would take the windows route)."""
    code = (
        "import torch\n"
        "from medsegpretrainimagenet_tpu_torch.models import blocks as B\n"
        "from medsegpretrainimagenet_tpu_torch.ops import use_fused_image\n"
        "print(B.remat_enabled(), type(B.make_layer_norm(4)).__name__,\n"
        "      use_fused_image(False, torch.bfloat16, torch.device('cuda')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.split()
    assert out == ["False", "LayerNorm", "False"]
