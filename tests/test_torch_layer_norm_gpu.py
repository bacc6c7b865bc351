"""The port's LayerNorm kernels (``csrc/layer_norm.cu``) against their plain
PyTorch versions, on the card: the forward against ``layer_norm_torch``
(the promote cast and ``F.layer_norm``) and ``layer_norm_stats``, the
gradients of the registered operator against autograd through the plain
version, at every width the registered models build and at widths that
take the kernel's general instance, in every input and output dtype the
models use.  dgamma and dbeta come out the same bits on two runs, and one
``swin_unet_224`` training step launches the forward and the backward once
per LayerNorm.

Every test here is marked ``gpu`` and skips without a CUDA card.  The file
imports no JAX, so it also runs on a machine that has only PyTorch; there,
skip the JAX-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_layer_norm_gpu.py -q
"""
import pytest
import torch

from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
from medsegpretrainimagenet_tpu_torch.models import Model, blocks
from medsegpretrainimagenet_tpu_torch.ops import layer_norm as ln
from medsegpretrainimagenet_tpu_torch.ops.kernel_ab import \
    swin_unet_224_config

pytestmark = pytest.mark.gpu

#: the LayerNorms of one swin_unet_224 forward: PatchEmbed's, two in each
#: of the 14 Swin blocks, the three PatchMergings', the three PatchExpands',
#: the encoder's last and the two of FinalPatchExpand_X4
SWIN_LAYER_NORMS = 37

#: the widths of the register instances (every width swin_unet_224
#: builds), then widths of the general instance: one below a warp, one
#: between instances, one past the widest
WIDTHS = (96, 192, 384, 768, 1536, 7, 100, 2000)

#: (x's dtype, the output's dtype): the float32 output of flax's LayerNorm
#: from each input dtype, and the half-output LayerNorm's compute dtype
PAIRS = [(torch.bfloat16, torch.float32), (torch.float16, torch.float32),
         (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
         (torch.float32, torch.bfloat16), (torch.float16, torch.float16)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(rows, c, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(rows, c, generator=g) * 3 + 0.5).to(device, dtype)
    w = (1 + 0.2 * torch.randn(c, generator=g)).to(device)
    b = (0.2 * torch.randn(c, generator=g)).to(device)
    return x, w, b


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)) \
        .item()


def _tol(dtype) -> float:
    # a bf16 rounding step (2^-8) of the largest element, fp16's 2^-11;
    # float32 outputs differ from the plain version by the order of the
    # row's sums only
    return {torch.bfloat16: 8e-3, torch.float16: 1e-3,
            torch.float32: 2e-5}[dtype]


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("dtype,out_dtype", PAIRS,
                         ids=[f"{a}-{b}".replace("torch.", "")
                              for a, b in PAIRS])
def test_kernels_match_plain(cuda_device, c, dtype, out_dtype):
    """Forward and gradients on (3, 337, C): a ragged count of rows (1011,
    not a multiple of any block's rows)."""
    x, w, b = _inputs(3 * 337, c, dtype, cuda_device)
    x = x.reshape(3, 337, c)
    y, mean, rstd = ln.layer_norm_cuda(x, w, b, 1e-6, out_dtype)
    want = ln.layer_norm_torch(x, w, b, 1e-6, out_dtype)
    assert y.dtype == want.dtype == out_dtype and y.shape == x.shape
    assert _rel(y, want) < _tol(out_dtype)
    want_mean, want_rstd = ln.layer_norm_stats(x, 1e-6)
    assert mean.shape == rstd.shape == (3, 337)
    assert _rel(mean, want_mean) < 1e-5 and _rel(rstd, want_rstd) < 1e-5

    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(1)) \
        .to(cuda_device, out_dtype)
    grads = []
    for fn in (ln.layer_norm, ln.layer_norm_torch):
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        out = fn(*leaves, 1e-6, out_dtype)
        grads.append(torch.autograd.grad(out, leaves, dy))
    (dx, dw, db), (want_dx, want_dw, want_db) = grads
    assert dx.dtype == dtype and dw.dtype == db.dtype == torch.float32
    assert _rel(dx, want_dx) < max(_tol(dtype), 1e-4)
    assert _rel(dw, want_dw) < 1e-4 and _rel(db, want_db) < 1e-4


@pytest.mark.parametrize("dtype,out_dtype", PAIRS[:3] + PAIRS[4:5],
                         ids=["bf16-f32", "f16-f32", "f32-f32", "f32-bf16"])
def test_opcheck(cuda_device, dtype, out_dtype):
    """torch.library.opcheck on both operators on the card: schema, fake
    implementation, autograd registration and AOT dispatch with dynamic
    shapes."""
    x, w, b = _inputs(15, 96, dtype, cuda_device)
    x = x.reshape(3, 5, 96)
    torch.library.opcheck(
        torch.ops.medseg_torch.layer_norm.default,
        (x.clone().requires_grad_(), w.clone().requires_grad_(),
         b.clone().requires_grad_(), 1e-6, out_dtype))
    y, mean, rstd = ln.layer_norm_cuda(x, w, b, 1e-6, out_dtype)
    torch.library.opcheck(
        torch.ops.medseg_torch.layer_norm_backward.default,
        (torch.randn_like(y), x, mean, rstd, w, True, True))


@pytest.mark.parametrize("c", [96, 768])
def test_gamma_and_beta_gradients_are_the_same_bits_twice(cuda_device, c):
    """dgamma and dbeta are summed by blocks and then over the blocks in a
    fixed order, with no atomics."""
    x, w, b = _inputs(50_000, c, torch.bfloat16, cuda_device, seed=2)
    _, mean, rstd = ln.layer_norm_cuda(x, w, b, 1e-6)
    dy = torch.randn(x.shape, device=cuda_device)
    runs = [ln.layer_norm_backward_cuda(dy, x, mean, rstd, w)
            for _ in range(2)]
    for first, second in zip(*runs):
        assert torch.equal(first, second)


def test_operands_off_16_bytes_take_the_general_instance(cuda_device):
    """A view one element into its storage is not 16-byte aligned: the
    general instances (``_rows``) take it, forward and backward, with the
    same results."""
    x, w, b = _inputs(514, 96, torch.bfloat16, cuda_device)
    x = x.reshape(-1)[1:1 + 513 * 96].reshape(513, 96)
    assert x.data_ptr() % 16
    dy = torch.randn(x.shape, device=cuda_device)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        y, mean, rstd = ln.layer_norm_cuda(x, w, b, 1e-5)
        dx, dw, db = ln.layer_norm_backward_cuda(dy, x, mean, rstd, w)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()
             if "medseg_layer_norm" in e.key}
    assert any("medseg_layer_norm_fwd_rows" in n for n in names), names
    assert any("medseg_layer_norm_bwd_rows" in n for n in names), names
    assert _rel(y, ln.layer_norm_torch(x, w, b, 1e-5)) < _tol(torch.float32)
    want = ln.layer_norm_backward(dy, x, *ln.layer_norm_stats(x, 1e-5), w)
    assert _rel(dx, want[0]) < _tol(torch.bfloat16)
    assert _rel(dw, want[1]) < 1e-4 and _rel(db, want[2]) < 1e-4


def test_no_rows_and_gradients_not_asked_for(cuda_device):
    x, w, b = _inputs(4, 96, torch.bfloat16, cuda_device)
    y, mean, _ = ln.layer_norm_cuda(x[:0], w, b, 1e-6)
    assert y.shape == (0, 96) and mean.shape == (0,)
    _, mean, rstd = ln.layer_norm_cuda(x, w, b, 1e-6)
    dy = torch.ones(x.shape, device=cuda_device)
    dx, dw, db = ln.layer_norm_backward_cuda(dy, x, mean, rstd, w,
                                             weight_grad=False)
    assert dx is not None and dw is None and db is None
    dx, dw, db = ln.layer_norm_backward_cuda(dy, x, mean, rstd, w,
                                             x_grad=False)
    assert dx is None and torch.equal(db, torch.full_like(db, 4.0))


def test_kernels_refuse_what_they_do_not_take(cuda_device):
    x, w, b = _inputs(8, 96, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="bfloat16, float16 or float32"):
        ln.layer_norm_cuda(x.double(), w, b, 1e-6)
    with pytest.raises(ValueError, match="float32 weight"):
        ln.layer_norm_cuda(x, w.bfloat16(), b, 1e-6)
    with pytest.raises(ValueError, match="float32 bias"):
        ln.layer_norm_cuda(x, w, b[:95], 1e-6)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ln.layer_norm_cuda(x.cpu(), w.cpu(), b.cpu(), 1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        ln.layer_norm_cuda(x.t(), w[:8], b[:8], 1e-6)
    # on the card the module reaches the kernel or raises: no fallback
    with pytest.raises(ValueError, match="bfloat16, float16 or float32"):
        blocks.LayerNorm(96).to(cuda_device).double()(x.double())


def test_swin_unet_224_step_launches_each_kernel_once_per_layer_norm(
        cuda_device):
    """One bf16 training forward and backward of swin_unet_224 at batch 2:
    37 forward launches and 37 backward launches, and no LayerNorm module
    left on ATen's kernels (the profiler sees none of them)."""
    cd = ConfigDict(swin_unet_224_config())
    cd.expand()
    registry.fill_spec(cd, "model")
    model = registry.build(cd, key="model", wrapper=Model)
    model.init(0)
    module = model.module.to(cuda_device).train()
    norms = [m for m in module.modules() if isinstance(m, blocks.LayerNorm)]
    assert len(norms) == SWIN_LAYER_NORMS
    blocks.set_compute_dtype(torch.bfloat16)
    try:
        x = torch.rand(2, 224, 224, 3, device=cuda_device)
        module(x).float().sum().backward()  # builds and warms up
        ln.layer_norm_cuda.launches = 0
        ln.layer_norm_backward_cuda.launches = 0
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            module(x).float().sum().backward()
            torch.cuda.synchronize()
    finally:
        blocks.set_compute_dtype(None)
    assert ln.layer_norm_cuda.launches == SWIN_LAYER_NORMS
    assert ln.layer_norm_backward_cuda.launches == SWIN_LAYER_NORMS
    names = {e.key for e in prof.key_averages()}
    aten = [n for n in names if "layer_norm" in n.lower()
            and "medseg" not in n]
    assert not aten and not any("GammaBeta" in n for n in names), aten
