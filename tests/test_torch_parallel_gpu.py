"""The global-batch BatchNorm of data parallelism on the card: its fused
path (``models.blocks._GlobalBatchNorm``, PyTorch's SyncBatchNorm kernels
over NCCL) against the float32 path that the CPU takes (over gloo), in a
group of one process, and against ``F.batch_norm``: the output, the input,
weight and bias gradients and the running statistics agree within 1e-5 of
their largest value.  Then two ranks sharing the card over gloo (NCCL
refuses two ranks on one device): tensor parallelism's column-parallel
conv and dense layer, spatial sharding's halo exchanges (a 3 x 3 conv, the
ResNet stem's 7 x 7 / 2 conv and 3 x 3 / 2 max pool) and the pipeline's
hand-off, forward and backward, each within 1e-5 of one process on the
card (TF32 off).

Marked ``gpu``; skips without a CUDA card.  Imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_parallel_gpu.py -q
"""
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from medsegpretrainimagenet_tpu_torch import parallel
from medsegpretrainimagenet_tpu_torch.models.blocks import BatchNorm

pytestmark = pytest.mark.gpu


@pytest.fixture
def one_process_group(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused path has no CPU kernels")
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("cpu:gloo,cuda:nccl",
                            init_method=f"file://{tmp_path / 'rendezvous'}",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _run(x, device, synced):
    """Forward and backward of a training BatchNorm on *x* (NHWC)."""
    bn = BatchNorm(x.shape[-1]).to(device).train()
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, x.shape[-1]))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, x.shape[-1]))
    leaf = x.detach().clone().to(device).requires_grad_()
    with parallel.sync_batch_stats(synced):
        out = bn(leaf)
    # a cotangent of one sign: the channel sums of the bias and weight
    # gradients do not cancel, so the bar relative to them means something
    g = torch.linspace(0.1, 1, out.numel()).reshape(out.shape).to(device)
    (out * g).sum().backward()
    return [t.detach().cpu() for t in (out, leaf.grad, bn.weight.grad,
                                       bn.bias.grad, bn.running_mean,
                                       bn.running_var)]


def test_fused_global_batch_norm_equals_the_cpu_path(one_process_group):
    x = 3 + 2 * torch.randn(8, 12, 12, 16,
                            generator=torch.Generator().manual_seed(0))
    fused = _run(x, "cuda", True)
    cpu = _run(x, "cpu", True)
    plain = _run(x, "cuda", False)
    names = ("output", "input grad", "weight grad", "bias grad",
             "running mean", "running var")
    for name, a, b, c in zip(names, fused, cpu, plain):
        scale = max(1.0, b.abs().max().item())
        assert (a - b).abs().max().item() < 1e-5 * scale, name
        assert (a - c).abs().max().item() < 1e-5 * scale, name


#: max |two ranks - one process| over the largest value, float32, TF32 off
SHARED_CARD_TOL = 1e-5
SHARED_CARD_CASES = ("column-parallel conv", "column-parallel dense",
                     "halo conv 3 x 3", "halo conv 7 x 7 / 2",
                     "halo max pool 3 x 3 / 2", "pipeline hand-off")


@pytest.fixture(scope="module")
def shared_card(tmp_path_factory):
    """Two ranks of ``tests/torch_dp_worker.py shared_card`` on the one
    card over gloo: the column-parallel conv (32 -> 256, 3 x 3) and dense
    layer (64 -> 512) on data x model 1 x 2, a 3 x 3 conv, the ResNet
    stem's 7 x 7 / 2 conv and 3 x 3 / 2 max pool on two bands of 16 rows,
    a two-stage pipeline at M = 4; rank 0's readings against one process
    on the card."""
    import os
    import pathlib
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ranks share it")
    tmp = tmp_path_factory.mktemp("shared_card")
    worker = pathlib.Path(__file__).with_name("torch_dp_worker.py")
    env = dict(os.environ, PYTHONPATH=str(worker.parent.parent)
               + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, str(worker), "shared_card", str(r), "2",
         str(tmp / "rendezvous"), str(tmp / "errors.pt")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outputs = [proc.communicate(timeout=300)[0] for proc in procs]
    for r, (proc, text) in enumerate(zip(procs, outputs)):
        assert proc.returncode == 0, f"rank {r}:\n{text[-4000:]}"
    return torch.load(tmp / "errors.pt")


@pytest.mark.parametrize("case", SHARED_CARD_CASES)
def test_two_ranks_sharing_the_card_equal_one_process(shared_card, case):
    assert shared_card[case] < SHARED_CARD_TOL, shared_card
