"""The port's CUDA kernels against their plain PyTorch versions, on the card:
K1 (window attention, windows layout) and K2 (image layout).

Every test here is marked ``gpu`` and skips without a CUDA card.  The file
imports no JAX, so it also runs on a machine that has only PyTorch; there,
skip the JAX-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_gpu.py -q
"""
import pytest
import torch

from medsegpretrainimagenet_tpu_torch.models.swin import _shift_attn_mask
from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa

pytestmark = pytest.mark.gpu

SCALE = 32 ** -0.5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dtype, masked, device, windows=64, heads=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(windows, heads, 49, 32, generator=g)
               .to(device, dtype) for _ in range(3))
    bias = (0.02 * torch.randn(heads, 49, 49, generator=g)).to(device)
    mask = torch.from_numpy(_shift_attn_mask((28, 28), 7, 3)).to(device) \
        if masked else None
    return q, k, v, bias, mask


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 0.05),
                                       (torch.float32, 1e-4)],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("masked", [False, True], ids=["w_msa", "sw_msa"])
def test_window_attention_kernel_matches_plain(cuda_device, dtype, tol,
                                               masked):
    args = _inputs(dtype, masked, cuda_device)
    wa.window_attention_cuda.launches = 0
    out = wa.window_attention_core(*args, SCALE)
    ref = wa.window_attention_core(*args, SCALE, force="torch")
    torch.cuda.synchronize()
    assert wa.window_attention_cuda.launches == 1
    assert out.dtype == dtype and out.shape == ref.shape
    assert (out.float() - ref.float()).abs().max().item() < tol


def test_window_attention_kernel_backward_matches_autograd(cuda_device):
    args = _inputs(torch.float32, True, cuda_device, seed=1)
    g = torch.randn(args[0].shape, device=cuda_device)
    grads = []
    for force in (None, "torch"):
        leaves = [t.clone().requires_grad_() for t in args]
        (wa.window_attention_core(*leaves, SCALE, force=force) * g) \
            .sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert (a - b).abs().max().item() < 1e-3


def test_window_attention_kernel_refuses_large_windows(cuda_device):
    q = torch.zeros(2, 1, 65, 8, device=cuda_device)
    bias = torch.zeros(1, 65, 65, device=cuda_device)
    with pytest.raises(ValueError, match="N <= 64"):
        wa.window_attention_cuda(q, q, q, bias, None, SCALE)
    with pytest.raises(ValueError, match="contiguous"):
        x = torch.zeros(2, 1, 8, 16, device=cuda_device)[..., ::2]
        wa.window_attention_cuda(x, x, x, torch.zeros(
            1, 8, 8, device=cuda_device), None, SCALE)


def _image_inputs(dtype, masked, device, batch=2, res=28, heads=6, seed=0):
    """Level 1 of swin_unet_224 (R = 28, C = 192, 6 heads), batch 2."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(batch, res, res, 3 * 32 * heads, generator=g) \
        .to(device, dtype)
    bias = (0.02 * torch.randn(heads, 49, 49, generator=g)).to(device)
    mask = torch.from_numpy(_shift_attn_mask((res, res), 7, 3)).to(device) \
        if masked else None
    return qkv, bias, mask


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 0.05),
                                       (torch.float32, 1e-4)],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("masked", [False, True], ids=["w_msa", "sw_msa"])
def test_image_attention_kernel_matches_plain(cuda_device, dtype, tol,
                                              masked):
    args = _image_inputs(dtype, masked, cuda_device)
    wa.image_attention_cuda.launches = 0
    out = wa.fused_image_window_attention(*args, SCALE, 7)
    ref = wa.fused_image_window_attention(*args, SCALE, 7, force="torch")
    torch.cuda.synchronize()
    assert wa.image_attention_cuda.launches == 1
    assert out.dtype == dtype and out.shape == ref.shape == (2, 28, 28, 192)
    assert (out.float() - ref.float()).abs().max().item() < tol


def test_image_attention_kernel_backward_matches_autograd(cuda_device):
    args = _image_inputs(torch.float32, True, cuda_device, seed=1)
    g = torch.randn(2, 28, 28, 192, device=cuda_device)
    grads = []
    for force in (None, "torch"):
        leaves = [t.clone().requires_grad_() for t in args]
        (wa.fused_image_window_attention(*leaves, SCALE, 7, force=force)
         * g).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert (a - b).abs().max().item() < 1e-3


def test_image_attention_kernel_refuses_what_it_does_not_take(cuda_device):
    qkv, bias, mask = _image_inputs(torch.float32, True, cuda_device)
    with pytest.raises(ValueError, match="R % window"):
        wa.image_attention_cuda(qkv[:, :27, :27].contiguous(), bias, None,
                                SCALE, 7)
    with pytest.raises(ValueError, match="mask must be"):
        wa.image_attention_cuda(qkv, bias, mask[:4], SCALE, 7)
    with pytest.raises(ValueError, match="N <= 64"):
        wa.image_attention_cuda(qkv[:, :27, :27].contiguous(), torch.zeros(
            6, 81, 81, device=cuda_device), None, SCALE, 9)
    with pytest.raises(ValueError, match="contiguous"):
        wa.image_attention_cuda(qkv.transpose(1, 2), bias, mask, SCALE, 7)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        wa.image_attention_cuda(qkv.half(), bias, mask, SCALE, 7)
