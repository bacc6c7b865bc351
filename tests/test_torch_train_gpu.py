"""The port's train steps on the card: the same small float32 step on the
card and on the CPU agree within 1e-4 (chip_smoke.py's ``[train]`` bar),
for the U-Net, the Swin U-Net (its attention K1, or K2 under
``set_fused_image_mode("on")``, under autograd: the kernel's forward and
the recompute backward) and the ResNet attention U-Net; and a bf16 step
queues no host sync.

Every test here is marked ``gpu`` and skips without a CUDA card.  The file
imports no JAX, so it also runs on a machine that has only PyTorch; there,
skip the JAX-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_train_gpu.py -q
"""
import numpy as np
import pytest
import torch

from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
from medsegpretrainimagenet_tpu_torch.losses import DiceLoss, Loss
from medsegpretrainimagenet_tpu_torch.metrics import MetricsCalculator
from medsegpretrainimagenet_tpu_torch.models import Model, blocks
from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa
from medsegpretrainimagenet_tpu_torch.optim import Optimizer
from medsegpretrainimagenet_tpu_torch.train import TrainState, make_train_step

pytestmark = pytest.mark.gpu

TOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the test holds the card against "
                    "the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


#: the small Swin U-Net of tests/test_torch_swin_train.py (rates 0: the
#: card and the CPU draw differently) and the ResNet attention U-Net of
#: tests/test_torch_attention_unet.py, as architecture sections
FAMILIES = {
    "swin": {
        "in_channel_size": 3, "out_channel_size": 1, "depth": 1, "width": 2,
        "channels": (8, 16), "change_channels_in_block": False,
        "trainable_downsampling": True,
        "basic_block": {"segmentation.models.blocks.SwinTransformerBlock": {
            "img_size": 32, "patch_size": 4, "embed_dim": 8,
            "num_heads_layers": (2, 4), "window_size": 4}},
        "mixing_block": {"segmentation.models.blocks.ConcatLinearBlock": {}},
        "stem": {"segmentation.models.blocks.PatchEmbed": {"patch_size": 4}},
        "downsampling": {"segmentation.models.blocks.PatchMerging": {}},
        "upsampling": {"segmentation.models.blocks.PatchExpand": {
            "dim_scale": 2}},
        "final_block": {"segmentation.models.blocks.FinalPatchExpand_X4": {
            "dim_scale": 4}}},
    "resnet": {
        "out_channel_size": 1, "decoder_channels": (8, 4, 4),
        "encoder": {"classification.models.DeepResNet": {
            "version": "v1", "bottleneck": True, "channel_sizes": (8, 16),
            "widths": (1, 1), "in_channels": 3, "base_channel_size": 4}},
        "mixing_block": {"segmentation.models.blocks.AttentionBlock": {}}},
}


def _trainer(device, channels=(8, 16, 32), architecture=None):
    """The small U-Net trainer (or one of *architecture*), from seeded
    weights, on *device*."""
    cfg = ConfigDict({"model": {"segmentation.models.UNet": {
        "architecture": architecture or {
            "in_channel_size": 3, "out_channel_size": 1,
            "depth": len(channels) - 1, "channels": tuple(channels)}}}})
    cfg.expand()
    registry.fill_spec(cfg, "model")
    Model.fill_weight_init_kwargs(cfg["model"].value())
    model = registry.build(cfg, key="model", wrapper=Model)
    model.init(0)
    model.init_weight(cfg["model"].value(), torch.Generator().manual_seed(1))
    model.module.to(device)
    optimizer = Optimizer(ConfigDict({"sgd": {"learning_rate": {
        "optim.scheduler.PolyLearningRateDecay": {
            "base": 0.01, "exponent": 0.9, "iteration_unit": "batch",
            "number_of_iterations": "auto"}}}}),
        num_epochs=1, batches_per_epoch=10)
    state = TrainState.create(model.module, optimizer.init(model.module), 0)
    loss = Loss(DiceLoss, ConfigDict({"label type": "mask"}))
    calculator = MetricsCalculator(ConfigDict({"metrics": {
        "metrics": ("metrics.DiceIndex",)}}), loss=loss)
    step = make_train_step(model, loss, calculator, optimizer,
                           grad_clip_value=1.0)
    return model, state, calculator, step


def _batch(n_frag, frag_bs, size=32, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.random((n_frag, frag_bs, size, size, 3)) * 255).astype(np.uint8)
    mask = (x[..., 0] > 128).astype(np.uint8)
    return {"x": torch.from_numpy(x), "mask": torch.from_numpy(mask)}


@pytest.mark.parametrize("n_frag", [1, 2], ids=["whole", "two_fragments"])
def test_train_step_card_matches_cpu(cuda_device, n_frag):
    runs = []
    for device in ("cpu", cuda_device):
        model, state, calculator, step = _trainer(device)
        metrics_state = calculator.init_state(device)
        losses = []
        for k in range(3):
            batch = {key: v.to(device)
                     for key, v in _batch(n_frag, 4 // n_frag, seed=k).items()}
            state, metrics_state, per_batch = step(state, metrics_state,
                                                   batch)
            losses.append(per_batch["dice_loss"].item())
        runs.append((losses, {k: v.cpu() for k, v in
                              model.module.state_dict().items()},
                     calculator.finalize_epoch(metrics_state)))
    (cpu_losses, cpu_state, cpu_values), (losses, state, values) = runs
    np.testing.assert_allclose(losses, cpu_losses, rtol=TOL, atol=TOL)
    for name, value in state.items():
        np.testing.assert_allclose(value.double().numpy(),
                                   cpu_state[name].double().numpy(),
                                   rtol=TOL, atol=TOL, err_msg=name)
    for key, value in values.items():
        assert value == pytest.approx(cpu_values[key], rel=TOL, abs=TOL)


def test_bf16_train_step_queues_no_host_sync(cuda_device):
    """After a warm-up step, steps run under sync debug mode "error": any
    synchronising call inside them raises."""
    blocks.set_compute_dtype(torch.bfloat16)
    try:
        model, state, calculator, step = _trainer(cuda_device)
        metrics_state = calculator.init_state(cuda_device)
        batch = {k: v.to(cuda_device) for k, v in _batch(2, 2).items()}
        state, metrics_state, _ = step(state, metrics_state, batch)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                state, metrics_state, per_batch = step(state, metrics_state,
                                                       batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.isfinite(per_batch["dice_loss"]).item()
        assert state.step == 4
    finally:
        blocks.set_compute_dtype(None)


@pytest.mark.parametrize("family, mode", [("swin", "off"), ("swin", "on"),
                                          ("resnet", "off")],
                         ids=["swin_k1", "swin_k2", "resnet"])
def test_family_train_step_card_matches_cpu(cuda_device, family, mode):
    """Three steps of two fragments of 2 on the card and on the CPU; the
    Swin U-Net's 6 blocks launch their kernel once per forward."""
    runs = []
    for device in ("cpu", cuda_device):
        model, state, calculator, step = _trainer(
            device, architecture=FAMILIES[family])
        metrics_state = calculator.init_state(device)
        losses = []
        wa.window_attention_cuda.launches = 0
        wa.image_attention_cuda.launches = 0
        wa.set_fused_image_mode(mode)
        try:
            for k in range(3):
                batch = {key: v.to(device)
                         for key, v in _batch(2, 2, seed=k).items()}
                state, metrics_state, per_batch = step(state, metrics_state,
                                                       batch)
                losses.append(per_batch["dice_loss"].item())
        finally:
            wa.set_fused_image_mode("off")
        runs.append((losses, {k: v.cpu() for k, v in
                              model.module.state_dict().items()}))
    launches = (wa.window_attention_cuda.launches,
                wa.image_attention_cuda.launches)
    (cpu_losses, cpu_state), (losses, state) = runs
    np.testing.assert_allclose(losses, cpu_losses, rtol=TOL, atol=TOL)
    for name, value in state.items():
        np.testing.assert_allclose(value.double().numpy(),
                                   cpu_state[name].double().numpy(),
                                   rtol=TOL, atol=TOL, err_msg=name)
    want = 6 * 2 * 3 if family == "swin" else 0
    assert launches == ((want, 0) if mode == "off" else (0, want))


def test_swin_bf16_train_step_queues_no_host_sync(cuda_device):
    """The Swin U-Net at stochastic depth 0.2 in bf16: after a warm-up
    step, steps run under sync debug mode "error"."""
    architecture = dict(FAMILIES["swin"], **{"stochastic depth rate": 0.2})
    blocks.set_compute_dtype(torch.bfloat16)
    try:
        model, state, calculator, step = _trainer(
            cuda_device, architecture=architecture)
        metrics_state = calculator.init_state(cuda_device)
        batch = {k: v.to(cuda_device) for k, v in _batch(2, 2).items()}
        state, metrics_state, _ = step(state, metrics_state, batch)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                state, metrics_state, per_batch = step(state, metrics_state,
                                                       batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.isfinite(per_batch["dice_loss"]).item()
    finally:
        blocks.set_compute_dtype(None)
