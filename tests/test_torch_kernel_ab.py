"""The parent-against-change timing tool of the port's kernels
(``medsegpretrainimagenet_tpu_torch/ops/kernel_ab.py``): what it times and
how it refuses a directory that is not a checkout.  Its timing needs the
card and is run there."""
import subprocess
import sys
from pathlib import Path

from medsegpretrainimagenet_tpu_torch.ops import kernel_ab

ROOT = Path(__file__).resolve().parent.parent


def test_shapes_are_one_forward_of_swin_unet_224():
    shapes = list(kernel_ab._shapes())
    assert len(shapes) == 7
    assert sum(calls for *_, calls in shapes) == 14
    assert sum(calls for _, _, _, _, masked, calls in shapes if masked) == 6
    assert kernel_ab.THIS == ROOT


def test_refuses_a_directory_without_the_package(tmp_path):
    run = subprocess.run(
        [sys.executable, "-m", "medsegpretrainimagenet_tpu_torch.ops.kernel_ab",
         str(tmp_path)], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert run.returncode != 0
    assert "holds no medsegpretrainimagenet_tpu_torch package" in run.stderr
    assert "[ab]" not in run.stdout
