"""The PyTorch port stands alone: it imports no JAX, no flax, no optax, no
OpenCV and nothing of the JAX package, and its kernels are written by hand.
Its CLI trains on the CPU only when asked to.  ``chip_smoke.py`` refuses to
run without a card or without the package beside it."""
import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "medsegpretrainimagenet_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "cv2",
             "medsegpretrainimagenet_tpu"}

_BLOCKED_RUN = """
import sys
for name in ("jax", "flax", "optax", "cv2", "medsegpretrainimagenet_tpu"):
    sys.modules[name] = None  # any import of them raises ImportError
import numpy as np, torch
from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
from medsegpretrainimagenet_tpu_torch.models import Model
from medsegpretrainimagenet_tpu_torch import ops, predict, transfer  # noqa
arch = {
    "in_channel_size": 3, "out_channel_size": 1, "depth": 1, "width": 2,
    "channels": (8, 16), "change_channels_in_block": False,
    "trainable_downsampling": True,
    "basic_block": {"segmentation.models.blocks.SwinTransformerBlock": {
        "img_size": 32, "patch_size": 4, "embed_dim": 8,
        "num_heads_layers": (1, 2), "window_size": 4}},
    "mixing_block": {"segmentation.models.blocks.ConcatLinearBlock": {}},
    "stem": {"segmentation.models.blocks.PatchEmbed": {"patch_size": 4}},
    "downsampling": {"segmentation.models.blocks.PatchMerging": {}},
    "upsampling": {"segmentation.models.blocks.PatchExpand": {}},
    "final_block": {"segmentation.models.blocks.FinalPatchExpand_X4": {}}}
cd = ConfigDict({"model": {"segmentation.models.UNet": {
    "architecture": arch}}})
cd.expand()
registry.fill_spec(cd, "model")
model = registry.build(cd, key="model", wrapper=Model)
model.init(0)
x = torch.rand(2, 32, 32, 3)
with torch.no_grad():
    out = model.apply(x)
    ops.set_fused_image_mode("on")  # the image-layout path as well
    fused = model.apply(x)
    ops.set_fused_image_mode("off")
assert out.shape == (2, 32, 32, 1) and torch.isfinite(out).all()
assert torch.allclose(fused, out, atol=1e-5)
# the U-Net trainer: losses, optim, metrics, train step
from medsegpretrainimagenet_tpu_torch.losses import DiceLoss, Loss
from medsegpretrainimagenet_tpu_torch.metrics import MetricsCalculator
from medsegpretrainimagenet_tpu_torch.optim import Optimizer
from medsegpretrainimagenet_tpu_torch.train import (TrainState,
                                                    make_train_step)
cd = ConfigDict({"model": {"segmentation.models.UNet": {"architecture": {
    "in_channel_size": 3, "out_channel_size": 1, "depth": 1,
    "channels": (4, 8)}}}})
cd.expand()
registry.fill_spec(cd, "model")
unet = registry.build(cd, key="model", wrapper=Model)
unet.init(0)
opt = Optimizer(ConfigDict({"sgd": {}}))
loss = Loss(DiceLoss)
calc = MetricsCalculator(ConfigDict({"metrics": {
    "metrics": ("metrics.DiceIndex",)}}), loss=loss)
step = make_train_step(unet, loss, calc, opt)
state = TrainState.create(unet.module, opt.init(unet.module), 0)
batch = {"x": torch.randint(0, 255, (2, 2, 16, 16, 3), dtype=torch.uint8),
         "mask": torch.randint(0, 2, (2, 2, 16, 16), dtype=torch.uint8)}
state, metrics, per_batch = step(state, calc.init_state("cpu"), batch)
assert torch.isfinite(per_batch["dice_loss"]) and state.step == 1
assert 0 <= calc.finalize_epoch(metrics)["metrics/dice_index_threshold_0.5"] <= 1
# the experiment CLI, one epoch on the CPU on a tiny COVID-QU tree
import csv, os, pathlib, tempfile
from medsegpretrainimagenet_tpu_torch.cli import main
root = pathlib.Path(tempfile.mkdtemp())
rng = np.random.default_rng(0)
for part, n in (("train and val", 8), ("test", 4)):
    d = root / "COVID_QU" / "Inf_segm" / "data arrays" / "COVID-19" / part
    d.mkdir(parents=True)
    np.save(d / "imgs.npy", rng.integers(0, 255, (n, 1, 20, 20), np.uint8))
    m = np.zeros((n, 1, 20, 20), np.uint8); m[:, :, 5:12, 6:14] = 2
    np.save(d / "inf_masks.npy", m)
os.environ["MST_DATA_DIR"] = str(root)
(root / "cfg.yaml").write_text(f'''
experiment: {{number_of_epochs: 1}}
meta: {{technical: {{seed: 1, save_destination: {root}/logs,
                    maximum_actual_batch_size: 4}}}}
data:
  data: {{covidqu: {{lung_or_infection: inf, image_sizes: 16,
                    validate_on_test: true}}}}
  sampling: {{batch_size: 4}}
  transforms: {{train: transform.RepeatChannels,
               val: transform.RepeatChannels}}
model: {{segmentation.models.UNet: {{architecture: {{
  in_channel_size: 3, out_channel_size: 1, depth: 1,
  channels: !!python/tuple [4, 8]}}}}}}
training: {{loss: {{segmentation.losses.DiceLoss: {{}}}}}}
metrics: {{metrics: !!python/tuple [metrics.DiceIndex, metrics.AUROC,
                                   metrics.ModifiedHausdorffDistance]}}
''')
main([str(root / "cfg.yaml"), "--device", "cpu"])
(run,) = (root / "logs").glob("*/Experiment/run_1")
rows = list(csv.DictReader(open(run / "epoch_logs.csv")))
assert len(rows) == 1 and 0 <= float(rows[0]["dice_loss"]) <= 1, rows
assert 0 <= float(rows[0]["val_metrics/area_under_roc_pooled"]) <= 1, rows
assert (run / "last_model_state_dict.pt").is_file()
# the ACDC multiclass U-Net: NIfTI tree, softmax head, multiclass metrics
from medsegpretrainimagenet_tpu_torch.data.readers import save_nii
for part, n in (("training", 2), ("testing", 1)):
    for p in range(n):
        d = root / "ACDC" / part / f"patient{p:03d}"
        d.mkdir(parents=True)
        for frame in (1, 12):
            lab = rng.integers(0, 4, (18, 20, 2)).astype(np.uint8)
            stem = str(d / f"patient{p:03d}_frame{frame:02d}")
            save_nii(stem + ".nii.gz", (40.0 * lab).astype(np.float32))
            save_nii(stem + "_gt.nii.gz", lab)
(root / "acdc.yaml").write_text(f'''
experiment: {{number_of_epochs: 1}}
meta: {{technical: {{seed: 1, save_destination: {root}/acdc_logs,
                    maximum_actual_batch_size: 4, profile: true}}}}
data:
  data: {{acdc: {{image_sizes: 16, validate_on_test: true}}}}
  sampling: {{batch_size: 4}}
  transforms: {{casting: {{mask: torch.LongTensor}}}}
model: {{segmentation.models.UNet: {{architecture: {{
  in_channel_size: 1, out_channel_size: 4, depth: 1,
  channels: !!python/tuple [4, 8]}}, final_activation: softmax}}}}
training: {{loss: {{segmentation.losses.DiceLoss: {{}}}}}}
metrics:
  metrics: !!python/tuple [metrics.multiclass_metrics.DiceIndex,
    metrics.multiclass_metrics.ModifiedHausdorffDistance,
    metrics.multiclass_metrics.AUROC]
  calculation: {{number_of_classes: 4, log_confusion_matrix: true}}
''')
main([str(root / "acdc.yaml"), "--device", "cpu"])
(run,) = (root / "acdc_logs").glob("*/Experiment/run_1")
rows = list(csv.DictReader(open(run / "epoch_logs.csv")))
assert len(rows) == 1 and "val_metrics/mean_dice_index" in rows[0], rows
assert float(rows[0]["val_metrics/modified_hausdorff_distance"]) >= 0
assert (run / "Confusion_matrices" / "val_confusion_matrix_epoch_1.json"
        ).is_file()
assert (run / "profile" / "trace" / "trace.json").is_file()
# ImageNet pretraining of the U-Net encoder through the CLI, with the
# classification chain, and its transfer into the COVID-QU U-Net
import json
store = root / "imagenet"
store.mkdir()
labels = {}
for i in range(12):
    name = f"{'val' if i >= 8 else 'train'}_{i:03d}.npy"
    np.save(store / name, rng.integers(0, 255, (3, 20, 20), np.uint8))
    labels[name] = int(rng.integers(1, 4))
(store / "labels.json").write_text(json.dumps(labels))
(root / "pretrain.yaml").write_text(f'''
experiment: {{number_of_epochs: 1}}
meta: {{technical: {{seed: 1, save_destination: {root}/pre_logs,
                    maximum_actual_batch_size: 4,
                    model_log_checkpoints: !!python/tuple [1]}}}}
data:
  data: {{classification.datasets.ImageNet: {{uint8_transfer: true}}}}
  sampling: {{batch_size: 4}}
  transforms:
    train: !!python/tuple
    - {{torchvision.transforms.RandomResizedCrop: {{size: 16}}}}
    - torchvision.transforms.RandomHorizontalFlip
    - classification.transforms.RandAugment
    - {{classification.transforms.OneHotEncoding: {{num_classes: 3}}}}
    - classification.transforms.MixupOrCutMix
    - {{torchvision.transforms.RandomErasing: {{p: 0.25}}}}
    val: !!python/tuple [{{torchvision.transforms.CenterCrop: {{size: 16}}}}]
model: {{model.FeedForwardModel: {{layers: !!python/tuple [
  {{segmentation.models.UNet_encoder: {{in_channel_size: 3, depth: 1,
                                       channels: !!python/tuple [4, 8]}}}},
  {{torch.nn.AdaptiveAvgPool2d: {{output_size: 1}}}}, torch.nn.Flatten,
  {{torch.nn.Linear: {{in_features: 8, out_features: 3}}}}]}}}}
training:
  loss: {{classification.losses.CrossEntropyLoss: {{label_smoothing: 0.1,
                                                   label_type: label}}}}
  optimizer: {{torch.optim.AdamW: {{weight_decay: 0.05}}}}
metrics:
  metrics: !!python/tuple [metrics.multiclass_metrics.Accuracy,
                           metrics.multiclass_metrics.AUROC]
  calculation: {{number_of_classes: 3, label_type: label,
                 apply_softmax: true, log_confusion_matrix: true}}
''')
main([str(root / "pretrain.yaml"), "--device", "cpu"])
(run,) = (root / "pre_logs").glob("*/Experiment/run_1")
rows = list(csv.DictReader(open(run / "epoch_logs.csv")))
assert float(rows[0]["cross_entropy_loss"]) > 0, rows
encoder = run / "model_state_dict_epoch_1.pt"
from medsegpretrainimagenet_tpu_torch.train.checkpoint import \
    load_encoder_variables
params, stats = load_encoder_variables(str(encoder))
assert "stem_block.Conv_0.weight" in params and stats
text = (root / "cfg.yaml").read_text().replace(
    "channels: !!python/tuple [4, 8]}}}}}}",
    "channels: !!python/tuple [4, 8]}}, weight_init: {{encoder: "
    "{{weights: " + str(encoder) + "}}}}}}}}").replace("/logs", "/down_logs")
(root / "down.yaml").write_text(text)
main([str(root / "down.yaml"), "--device", "cpu"])
(run,) = (root / "down_logs").glob("*/Experiment/run_1")
final = torch.load(run / "last_model_state_dict.pt")
assert final["enc.stem_block.Conv_0.weight"].shape == \
    params["stem_block.Conv_0.weight"].shape
# the robustness sweep CLI scores that pretrained encoder and a ResNet
from medsegpretrainimagenet_tpu_torch.robustness.__main__ import \
    main as robustness_main
(root / "rob.yaml").write_text(f'''
data: {{covidqu: {{segmentation.datasets.COVIDQUDataset: {{
  lung_or_infection: inf, image_sizes: 16, validate_on_test: true}}}}}}
probe_images: 4
encoders:
- {{name: u-net_encoder, weights: {encoder}, model: {{
    segmentation.models.UNet_encoder: {{in_channel_size: 3, depth: 1,
                                       channels: [4, 8]}}}}}}
- {{name: resnet50, model: {{classification.models.DeepResNet: {{
    bias: false, channel_sizes: [8, 16], widths: [1, 1],
    base_channel_size: 4}}}}}}
metrics: [cosine_distance, l2]
margins: [0.0, 0.5]
levels: [1, 2]
output: {root}/rob.csv
''')
assert robustness_main([str(root / "rob.yaml"), "--device", "cpu"]) == 0
rows = list(csv.DictReader(open(root / "rob.csv")))
# 2 metrics x 2 margins x 2 pooled x (1 level of the depth-1 U-Net
# encoder + 2 of the ResNet)
assert len(rows) == 2 * 2 * 2 * 3, len(rows)
assert all(np.isfinite(float(r["robustness"])) for r in rows), rows
from medsegpretrainimagenet_tpu_torch.ops.augment import \
    make_classification_device_augment
out = make_classification_device_augment(16, 3)(
    torch.Generator().manual_seed(0),
    {"x": torch.rand(4, 20, 20, 3), "label": torch.tensor([0, 1, 2, 1])})
assert out["x"].shape == (4, 16, 16, 3) and out["label"].shape == (4, 3)
assert not any(m.split(".")[0] in ("jax", "flax", "optax", "cv2")
               for m, v in sys.modules.items() if v is not None)
print("OK")
"""


def test_port_imports_and_runs_with_jax_blocked():
    """Serving on both attention paths, a train step, one epoch of the
    experiment CLI on COVID-QU with Dice, AUROC and HD95, one of the
    ACDC multiclass U-Net with the multiclass metrics, the
    confusion-matrix export and the profiler trace, one of ImageNet
    pretraining with the classification chain and one of the COVID-QU
    U-Net from its encoder, the robustness sweep of that encoder and a
    ResNet, and the on-card classification chain, with JAX, flax, optax,
    OpenCV and the JAX package unimportable."""
    result = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=ROOT,
                            capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip().endswith("OK")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_of_the_port_imports_jax(path):
    assert not set(_imported_roots(path)) & FORBIDDEN


def test_kernels_are_written_by_hand():
    """No library kernel behind the CUDA sources: no cuBLAS, cuDNN,
    PyTorch operator or attention library call."""
    sources = sorted((PORT / "csrc").glob("*.cu*"))
    assert sources
    for src in sources:
        text = src.read_text().lower()
        for word in ("cublas", "cudnn", "scaled_dot_product", "torch/",
                     "cutlass::gemm::device", "flash"):
            assert word not in text, f"{src.name} names {word}"
        # a .cu defines its kernels; a .cuh holds device code they share
        assert "__global__" in text or src.suffix == ".cuh"


def test_chip_smoke_refuses_without_card_or_package(tmp_path):
    """On this CPU host, and alone in a directory, chip_smoke.py exits
    non-zero and prints no result line."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)):
        result = subprocess.run([sys.executable, str(script)], cwd=cwd,
                                capture_output=True, text=True, timeout=300)
        if cwd == ROOT and result.returncode == 0:
            pytest.skip("a CUDA card is present: chip_smoke.py ran")
        assert result.returncode != 0
        assert '"ok"' not in result.stdout


def test_cli_needs_a_card_or_device_cpu(tmp_path):
    """Without a card and without ``--device``, the CLI exits non-zero
    naming the missing device; it trains nothing."""
    config = tmp_path / "cfg.yaml"
    config.write_text("experiment: {number_of_epochs: 1}\n")
    result = subprocess.run(
        [sys.executable, "-m", "medsegpretrainimagenet_tpu_torch.cli",
         str(config)], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    if result.returncode == 0:
        pytest.skip("a CUDA card is present")
    assert "no CUDA device found" in result.stderr
    assert not (tmp_path / "logs").exists()


def test_robustness_cli_needs_a_card_or_device_cpu(tmp_path):
    """Without a card and without ``--device``, the sweep CLI exits
    non-zero naming the missing device before it reads any data."""
    config = tmp_path / "cfg.yaml"
    config.write_text(f"probe_images: 2\noutput: {tmp_path}/out.csv\n")
    result = subprocess.run(
        [sys.executable, "-m", "medsegpretrainimagenet_tpu_torch.robustness",
         str(config)], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    if result.returncode == 0:
        pytest.skip("a CUDA card is present")
    assert "no CUDA device found" in result.stderr
    assert not (tmp_path / "out.csv").exists()
