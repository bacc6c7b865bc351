"""The port's U-Net train step on the card: the same small float32 step on
the card and on the CPU agree within 1e-4 (chip_smoke.py's ``[train]``
bar), and a bf16 step queues no host sync.

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


def _trainer(device, channels=(8, 16, 32)):
    """The small U-Net trainer, from seeded weights, on *device*."""
    cfg = ConfigDict({"model": {"segmentation.models.UNet": {
        "architecture": {"in_channel_size": 3, "out_channel_size": 1,
                         "depth": len(channels) - 1,
                         "channels": tuple(channels)}}}})
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
