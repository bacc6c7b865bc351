"""The PyTorch port stands alone: it imports no JAX, no flax and nothing of
the JAX package, and its kernels are written by hand.  ``chip_smoke.py``
refuses to run without a card or without the package beside it."""
import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "medsegpretrainimagenet_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "medsegpretrainimagenet_tpu"}

_BLOCKED_RUN = """
import sys
for name in ("jax", "flax", "medsegpretrainimagenet_tpu"):
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
assert not any(m.split(".")[0] in ("jax", "flax")
               for m, v in sys.modules.items() if v is not None)
print("OK")
"""


def test_port_imports_and_runs_with_jax_blocked():
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
