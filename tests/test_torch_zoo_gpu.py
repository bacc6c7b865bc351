"""The residual block zoo and IDRiD on the card's machine: the block
zoo's small U-Nets (ResNeXt, inverted bottleneck and ConvNeXt blocks with
their shortcuts, layer scaling and stochastic depth, the drop paths fed in
alike) step on the card as on the CPU within 1e-4 (chip_smoke.py's
``[blocks small]`` bar), and the IDRiD reader gives, on that machine's PIL,
what the JAX package's rule gives with that machine's OpenCV: the image
resized by ``cv2.resize`` in double, the masks in its uint8 fixed point,
the darkness filter on the float32 crops.

Every test here is marked ``gpu`` and skips without a CUDA card.  The file
imports no JAX, so it also runs on a machine that has only PyTorch; there,
skip the JAX-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_zoo_gpu.py -q
"""
import itertools

import numpy as np
import pytest
import torch
from PIL import Image

from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
from medsegpretrainimagenet_tpu_torch.data.readers import IDRiD
from medsegpretrainimagenet_tpu_torch.losses import DiceLoss, Loss
from medsegpretrainimagenet_tpu_torch.metrics import MetricsCalculator
from medsegpretrainimagenet_tpu_torch.models import Model, blocks
from medsegpretrainimagenet_tpu_torch.optim import Optimizer
from medsegpretrainimagenet_tpu_torch.train import TrainState, make_train_step

pytestmark = pytest.mark.gpu

TOL = 1e-4
ZOO = {
    "resnext": ("ResNeXtBlock",
                {"identity": {"expand_method": "fill_with_zeros"}}),
    "inverted_bottleneck": ("InvertedBottleneckBlock", "convolution"),
    "convnext": ("ConvNeXtBlock", {"down": "identity", "up": {
        "convolution": {"kernel_size": 3}}}),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the test holds the card against "
                    "the CPU, on the card's machine")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _fed_drop_path(x, rate, training, generator):
    """A fixed per-sample mask per rate, on the input's device: the card
    and the CPU draw differently."""
    if rate == 0.0 or not training:
        return x
    keep = (torch.arange(x.shape[0]) + round(rate * 1000)) % 3 != 0
    keep = keep.to(x.device).reshape((-1,) + (1,) * (x.ndim - 1))
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _trainer(device, kind):
    block, residual = ZOO[kind]
    cfg = ConfigDict({"model": {"segmentation.models.UNet": {
        "architecture": {
            "in_channel_size": 3, "out_channel_size": 1, "depth": 2,
            "channels": (8, 16, 32), "width": 2,
            "basic_block": f"segmentation.models.blocks.{block}",
            "residual_connections": residual, "layer_scaling": 0.1,
            "stochastic depth rate": 0.1}}}})
    cfg.expand()
    registry.fill_spec(cfg, "model")
    Model.fill_weight_init_kwargs(cfg["model"].value())
    model = registry.build(cfg, key="model", wrapper=Model)
    model.init(0)
    model.init_weight(cfg["model"].value(), torch.Generator().manual_seed(1))
    model.module.to(device)
    optimizer = Optimizer(ConfigDict({"sgd": {"momentum": 0.9,
                                              "learning_rate": {
                                                  "constant": {"base": 0.05}}}}),
                          num_epochs=1, batches_per_epoch=3)
    state = TrainState.create(model.module, optimizer.init(model.module), 0)
    loss = Loss(DiceLoss, ConfigDict({"label type": "mask"}))
    calculator = MetricsCalculator(ConfigDict({"metrics": {
        "metrics": ("metrics.DiceIndex",)}}), loss=loss)
    return model, state, calculator, make_train_step(model, loss,
                                                     calculator, optimizer)


@pytest.mark.parametrize("kind", list(ZOO))
def test_block_zoo_unet_step_card_matches_cpu(cuda_device, kind,
                                              monkeypatch):
    monkeypatch.setattr(blocks, "drop_path", _fed_drop_path)
    runs = []
    for device in ("cpu", cuda_device):
        model, state, calculator, step = _trainer(device, kind)
        metrics_state = calculator.init_state(device)
        losses = []
        for k in range(3):
            rng = np.random.default_rng(k)
            x = (rng.random((2, 2, 32, 32, 3)) * 255).astype(np.uint8)
            batch = {"x": torch.from_numpy(x).to(device),
                     "mask": torch.from_numpy(
                         (x[..., 0] > 128).astype(np.uint8)).to(device)}
            state, metrics_state, per_batch = step(state, metrics_state,
                                                   batch)
            losses.append(per_batch["dice_loss"].item())
        runs.append((losses, {k: v.cpu() for k, v in
                              model.module.state_dict().items()}))
    (cpu_losses, cpu_state), (losses, state) = runs
    np.testing.assert_allclose(losses, cpu_losses, rtol=TOL, atol=TOL)
    for name, value in state.items():
        np.testing.assert_allclose(value.double().numpy(),
                                   cpu_state[name].double().numpy(),
                                   rtol=TOL, atol=TOL, err_msg=name)


def _write_tree(root):
    """A small IDRiD tree: 3 + 2 fundus jpgs of 64 x 224 (a bright field,
    a black rim wider at the bottom) and gray MA masks."""
    rng = np.random.default_rng(0)
    base = root / "idrid" / "Segmentation" / "A. Segmentation"
    for idx, part in enumerate(["a. Training Set"] * 3
                               + ["b. Testing Set"] * 2, start=1):
        img_dir = base / "1. Original Images" / part
        mask_dir = base / "2. All Segmentation Groundtruths" / part \
            / "1. Microaneurysms"
        img_dir.mkdir(parents=True, exist_ok=True)
        mask_dir.mkdir(parents=True, exist_ok=True)
        img = np.zeros((64, 224, 3), np.uint8)
        img[8:-20, 16:-16] = rng.integers(100, 255, (36, 192, 3))
        Image.fromarray(img).save(img_dir / f"IDRiD_{idx:02d}.jpg")
        mask = np.zeros((64, 224), np.uint8)
        mask[10:20, 100 + idx:120 + idx] = 255
        Image.fromarray(mask).save(mask_dir / f"IDRiD_{idx:02d}_MA.tif")
    return base


def test_idrid_reader_on_the_card_machine(cuda_device, tmp_path,
                                          monkeypatch):
    cv2 = pytest.importorskip("cv2")
    base = _write_tree(tmp_path)
    monkeypatch.setenv("MST_DATA_DIR", str(tmp_path))
    ds = IDRiD(ConfigDict({"task": "MA", "base_image_sizes": (32, 48),
                           "cropped_image_sizes": 16,
                           "train_crop_stride": 8, "darkness_threshold": 0.6,
                           "train_set_size": 3}), seed=0)
    crops = {"train": ([], []), "val": ([], [])}
    for idx in range(1, 6):
        split, part = ("train", "a. Training Set") if idx <= 3 \
            else ("val", "b. Testing Set")
        with Image.open(base / "1. Original Images" / part
                        / f"IDRiD_{idx:02d}.jpg") as image:
            img = cv2.resize(np.asarray(image)[:, 96:-96] / 255,
                             (48, 32)).astype(np.float32)
        with Image.open(base / "2. All Segmentation Groundtruths" / part
                        / "1. Microaneurysms"
                        / f"IDRiD_{idx:02d}_MA.tif") as image:
            mask = (cv2.resize(np.asarray(image)[:, 96:-96], (48, 32))
                    != 0).astype(int)
        stride = 8 if split == "train" else 16
        for i, j in itertools.product(range((32 - 16) // stride + 1),
                                      range((48 - 16) // stride + 1)):
            sl = (slice(i * stride, i * stride + 16),
                  slice(j * stride, j * stride + 16))
            if np.mean(img[sl]) >= 1 - 0.6:
                crops[split][0].append(img[sl])
                crops[split][1].append(mask[sl])
    for split, (want_x, want_mask) in crops.items():
        got = getattr(ds, split)
        assert 0 < len(want_x) < (15 if split == "train" else 6) \
            * (3 if split == "train" else 2)
        np.testing.assert_array_equal(got["x"], np.stack(want_x))
        np.testing.assert_array_equal(got["mask"], np.stack(want_mask))
