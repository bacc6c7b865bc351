"""The global-batch BatchNorm of data parallelism on the card: its fused
path (``models.blocks._GlobalBatchNorm``, PyTorch's SyncBatchNorm kernels
over NCCL) against the float32 path that the CPU takes (over gloo), in a
group of one process, and against ``F.batch_norm``: the output, the input,
weight and bias gradients and the running statistics agree within 1e-5 of
their largest value.

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
