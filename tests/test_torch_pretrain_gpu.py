"""The pretraining classifier's train step and the on-card classification
chain, card against CPU: a small float32 ``FeedForwardModel`` (encoder
8-16-32, 10 classes) takes three cross-entropy + AdamW steps of one batch
on the card and on the CPU from the same weights, loss, parameters and
running statistics within TOL (chip_smoke.py's ``[pretrain small]`` bar;
AdamW's epsilon at 1e-4, see ``PRETRAIN_SMALL_EPS`` there); the
classification chain gives on the card what it gives on the CPU for the
same draws, and a bf16 step with the chain inside queues no host sync.

Every test here is marked ``gpu`` and skips without a CUDA card.  The file
imports no JAX, so it also runs on a machine that has only PyTorch; there,
skip the JAX-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_pretrain_gpu.py -q
"""
import numpy as np
import pytest
import torch

from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
from medsegpretrainimagenet_tpu_torch.losses import Loss
from medsegpretrainimagenet_tpu_torch.metrics import MetricsCalculator
from medsegpretrainimagenet_tpu_torch.models import Model, blocks
from medsegpretrainimagenet_tpu_torch.ops import augment
from medsegpretrainimagenet_tpu_torch.optim import Optimizer
from medsegpretrainimagenet_tpu_torch.train import TrainState, make_train_step

pytestmark = pytest.mark.gpu

TOL = 1e-4
CLASSES = 10
MODEL = {"model": {"model.FeedForwardModel": {"layers": (
    {"segmentation.models.UNet_encoder": {
        "in_channel_size": 3, "channels": (8, 16, 32), "depth": 2}},
    {"torch.nn.AdaptiveAvgPool2d": {"output_size": 1}},
    "torch.nn.Flatten",
    {"torch.nn.Linear": {"in_features": 32, "out_features": CLASSES}})}},
    "training": {"loss": {"classification.losses.CrossEntropyLoss": {
        "label_smoothing": 0.1, "label_type": "label"}}}}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the test holds the card against "
                    "the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _trainer(device, device_augment=None):
    cfg = ConfigDict(MODEL)
    cfg.expand()
    for key in ("model", "training/loss"):
        registry.fill_spec(cfg, key)
    Model.fill_weight_init_kwargs(cfg["model"].value())
    cfg = cfg.trim()
    model = registry.build(cfg, key="model", wrapper=Model)
    model.init(0)
    model.init_weight(cfg["model"].value(), torch.Generator().manual_seed(1))
    model.module.to(device)
    optimizer = Optimizer(ConfigDict({"torch.optim.AdamW": {
        "betas": (0.9, 0.999), "weight_decay": 0.05, "eps": 1e-4,
        "learning_rate": {"optim.scheduler.LinearWarmupScheduler": {
            "base": 0.004, "warmup_length": 2, "iteration_unit": "batch",
            "main_scheduler": {
                "torch.optim.lr_scheduler.CosineAnnealingLR": {
                    "eta_min": 1e-6, "T_max": "auto"}}}}}}),
        num_epochs=1, batches_per_epoch=10)
    state = TrainState.create(model.module, optimizer.init(model.module), 0)
    loss = registry.build(cfg, key="training/loss", wrapper=Loss)
    calculator = MetricsCalculator(ConfigDict({"metrics": {
        "metrics": ("metrics.multiclass_metrics.Accuracy",
                    "metrics.multiclass_metrics.AUROC"),
        "calculation": {"number_of_classes": CLASSES, "label_type": "label",
                        "apply_softmax": True}}}), loss=loss)
    step = make_train_step(model, loss, calculator, optimizer,
                           device_augment=device_augment)
    return model, state, calculator, step


def _batch(size=32, n=4, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": torch.from_numpy(rng.integers(0, 256, (1, n, size, size, 3),
                                               dtype=np.uint8)),
            "label": torch.from_numpy(rng.integers(0, CLASSES, (1, n))
                                      .astype(np.int32))}


def test_pretraining_step_card_matches_cpu(cuda_device):
    runs = []
    for device in (torch.device("cpu"), cuda_device):
        model, state, calculator, step = _trainer(device)
        metrics_state = calculator.init_state(device)
        losses = []
        for _ in range(3):
            state, metrics_state, per_batch = step(
                state, metrics_state,
                {k: v.to(device) for k, v in _batch().items()})
            losses.append(per_batch["cross_entropy_loss"].item())
        values = calculator.finalize_epoch(metrics_state)
        runs.append((losses, values, {k: v.double().cpu() for k, v in
                                      model.module.state_dict().items()}))
    (cpu_losses, cpu_values, cpu_state), (losses, values, state) = runs
    np.testing.assert_allclose(losses, cpu_losses, rtol=0, atol=TOL)
    for name, value in state.items():
        torch.testing.assert_close(value, cpu_state[name], rtol=0, atol=TOL,
                                   msg=name)
    for key, value in cpu_values.items():
        np.testing.assert_allclose(values[key], value, rtol=0, atol=TOL,
                                   err_msg=key)


def test_classification_chain_card_matches_cpu(cuda_device):
    x = torch.from_numpy(np.random.default_rng(1).random(
        (6, 40, 40, 3)).astype(np.float32))
    label = torch.tensor([0, 1, 2, 3, 4, 5])
    g = torch.Generator().manual_seed(3)
    draws = [torch.rand((6,), generator=g) for _ in range(13)]
    perm = torch.randperm(6, generator=g)

    def run(device):
        d = [t.to(device) for t in draws]
        out = augment.random_resized_crop_batch(x.to(device), 32, *d[:4],
                                                scale=(0.5, 1.0))
        out = augment.flip_batch(out, torch.zeros_like(d[4] < 0),
                                 d[4] < 0.5)
        onehot = torch.eye(CLASSES, device=device)[label.to(device)]
        out, soft = augment.mixup_or_cutmix_batch(
            out, onehot, perm.to(device), d[5] < 0.5, d[6] * (d[7] < 0.8),
            d[8] < 1.0, d[9], d[10], d[11])
        out = augment.erase_batch(out, d[12] < 0.6, *d[:4])
        return out.cpu(), soft.cpu()

    (cpu_x, cpu_y), (got_x, got_y) = run("cpu"), run(cuda_device)
    torch.testing.assert_close(got_x, cpu_x, rtol=0, atol=1e-5)
    torch.testing.assert_close(got_y, cpu_y, rtol=0, atol=1e-6)


def test_bf16_step_with_the_chain_queues_no_host_sync(cuda_device):
    chain = augment.make_classification_device_augment(
        out_size=32, n_classes=CLASSES, crop_scale=(0.8, 1.0))
    blocks.set_compute_dtype(torch.bfloat16)
    try:
        model, state, calculator, step = _trainer(cuda_device, chain)
        metrics_state = calculator.init_state(cuda_device)
        batch = {k: v.to(cuda_device) for k, v in _batch(40, 8).items()}
        state, metrics_state, _ = step(state, metrics_state, batch)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                state, metrics_state, per_batch = step(state, metrics_state,
                                                       batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.isfinite(per_batch["cross_entropy_loss"]).item()
        values = calculator.finalize_epoch(metrics_state)
        assert 0.0 <= values["metrics/accuracy"] <= 1.0
    finally:
        blocks.set_compute_dtype(None)
