"""The port's LayerNorm on the CPU (``ops/layer_norm.py``): the modules'
plain path keeps today's dtypes and values, the plain backward is
autograd's, the registered operators' fake implementations give the
kernels' shapes and dtypes, their autograd (on the CPU kernels, the plain
versions) gives the plain version's gradients, and ``torch.export`` takes
both the Swin U-Net and the operator.  The kernels themselves run only on
the card: ``tests/test_torch_layer_norm_gpu.py``."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from medsegpretrainimagenet_tpu_torch import export
from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
from medsegpretrainimagenet_tpu_torch.models import Model, blocks
from medsegpretrainimagenet_tpu_torch.ops import layer_norm as ln

DTYPES = [torch.bfloat16, torch.float32]


def _inputs(shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    c = shape[-1]
    x = (torch.randn(shape, generator=g) * 2 + 0.3).to(dtype)
    w = 1 + 0.2 * torch.randn(c, generator=g)
    b = 0.2 * torch.randn(c, generator=g)
    return x, w, b


@pytest.mark.parametrize("half_out", [False, True], ids=["f32-out", "half"])
@pytest.mark.parametrize("eps", [1e-6, 1e-5])
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_module_plain_path_keeps_dtypes_and_values(dtype, eps, half_out):
    """LayerNorm (eps 1e-6) and TorchLayerNorm (1e-5) on the CPU: the
    promote cast and F.layer_norm, then under ``set_ln_half_out`` the cast
    to the compute dtype; dx in the input's dtype, dgamma and dbeta
    float32."""
    blocks.set_ln_half_out(half_out)
    blocks.set_compute_dtype(torch.bfloat16)
    try:
        module = blocks.make_layer_norm(24) if eps == 1e-6 \
            else blocks.TorchLayerNorm(24)
        norm = module if eps == 1e-6 else module.LayerNorm_0
        assert norm.eps == eps
        assert isinstance(norm, blocks.HalfOutLayerNorm) == (
            half_out and eps == 1e-6)
        x, w, b = _inputs((2, 5, 24), dtype)
        with torch.no_grad():
            norm.weight.copy_(w)
            norm.bias.copy_(b)
        x.requires_grad_()
        y = module(x)
        want = F.layer_norm(x.detach().float(), (24,), w, b, eps)
        if half_out and eps == 1e-6:
            want = want.to(torch.bfloat16)
        assert y.dtype == want.dtype
        assert torch.equal(y.detach(), want)
        y.float().square().sum().backward()
    finally:
        blocks.set_ln_half_out(False)
        blocks.set_compute_dtype(None)
    assert x.grad.dtype == dtype
    assert norm.weight.grad.dtype == norm.bias.grad.dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float64])
def test_plain_backward_is_autograds(dtype):
    """layer_norm_backward from the rows' statistics (the kernel's
    formula) against autograd through layer_norm_torch."""
    x, w, b = _inputs((3, 7, 40), dtype)
    w, b = w.to(torch.promote_types(dtype, torch.float32)), \
        b.to(torch.promote_types(dtype, torch.float32))
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    y = ln.layer_norm_torch(*leaves, 1e-6)
    dy = torch.randn(y.shape, dtype=y.dtype,
                     generator=torch.Generator().manual_seed(3))
    want = torch.autograd.grad(y, leaves, dy)
    mean, rstd = ln.layer_norm_stats(x, 1e-6)
    got = ln.layer_norm_backward(dy, x, mean, rstd, w)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for g, t in zip(got, want):
        assert g.dtype == t.dtype
        scale = t.double().abs().max().item()
        assert (g.double() - t.double()).abs().max().item() <= tol * scale \
            or g.dtype == torch.bfloat16 and torch.allclose(
                g.float(), t.float(), rtol=8e-3, atol=8e-3 * scale)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16,
                                       torch.float16])
def test_fake_implementations_give_shapes_and_dtypes(out_dtype):
    with FakeTensorMode():
        x = torch.empty(4, 9, 96, dtype=torch.bfloat16)
        w, b = torch.empty(96), torch.empty(96)
        y, mean, rstd = torch.ops.medseg_torch.layer_norm(x, w, b, 1e-6,
                                                          out_dtype)
        assert y.shape == x.shape and y.dtype == out_dtype
        assert mean.shape == rstd.shape == (4, 9)
        assert mean.dtype == rstd.dtype == torch.float32
        dy = torch.empty(4, 9, 96, dtype=out_dtype)
        for x_grad, weight_grad, want in ((True, True, 3), (True, False, 1),
                                          (False, True, 2)):
            grads = torch.ops.medseg_torch.layer_norm_backward(
                dy, x, mean, rstd, w, x_grad, weight_grad)
            assert len(grads) == want
            if x_grad:
                assert grads[0].shape == x.shape
                assert grads[0].dtype == torch.bfloat16
            if weight_grad:
                assert all(g.shape == (96,) and g.dtype == torch.float32
                           for g in grads[-2:])


def test_fake_implementation_refuses_what_the_kernel_does_not_take():
    with FakeTensorMode():
        x = torch.empty(4, 96, dtype=torch.float64)
        with pytest.raises(ValueError, match="bfloat16, float16 or float32"):
            torch.ops.medseg_torch.layer_norm(x, torch.empty(96),
                                              torch.empty(96), 1e-6,
                                              torch.float64)
        with pytest.raises(ValueError, match="float32 weight"):
            torch.ops.medseg_torch.layer_norm(
                x.float(), torch.empty(95), torch.empty(96), 1e-6,
                torch.float32)


@pytest.mark.parametrize("out_dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_operator_autograd_gives_the_plain_gradients(dtype, out_dtype):
    """The operator on its CPU kernels, under its registered autograd (the
    backward operator), against autograd through the plain version."""
    x, w, b = _inputs((2, 11, 96), dtype, seed=4)
    out_dtype = out_dtype or torch.float32
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(5)) \
        .to(out_dtype)
    outs, grads = [], []
    for op in (True, False):
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        y = torch.ops.medseg_torch.layer_norm(*leaves, 1e-6, out_dtype)[0] \
            if op else ln.layer_norm_torch(*leaves, 1e-6, out_dtype)
        outs.append(y)
        grads.append(torch.autograd.grad(y, leaves, dy))
    assert torch.equal(outs[0], outs[1])
    for got, want in zip(*grads):
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                                   rtol=1e-2 if got.dtype == torch.bfloat16
                                   else 1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)],
    ids=["bf16-f32", "f32-bf16"])
def test_opcheck_on_the_cpu_kernels(dtype, out_dtype):
    """torch.library.opcheck on both operators: schema, fake
    implementation, autograd registration and AOT dispatch with dynamic
    shapes."""
    x, w, b = _inputs((3, 5, 96), dtype, seed=7)
    torch.library.opcheck(
        torch.ops.medseg_torch.layer_norm.default,
        (x.requires_grad_(), w.requires_grad_(), b.requires_grad_(), 1e-6,
         out_dtype))
    y, mean, rstd = torch.ops.medseg_torch.layer_norm(
        x.detach(), w.detach(), b.detach(), 1e-6, out_dtype)
    torch.library.opcheck(
        torch.ops.medseg_torch.layer_norm_backward.default,
        (torch.randn(y.shape).to(out_dtype), x.detach(), mean, rstd,
         w.detach(), True, True))


def test_operator_exports_on_the_cpu():
    """torch.export keeps the operator as a node (its fake gives the
    shapes), and the artifact runs its CPU kernel."""
    class Norm(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.weight = torch.nn.Parameter(torch.ones(96))
            self.bias = torch.nn.Parameter(torch.zeros(96))

        def forward(self, x):
            return torch.ops.medseg_torch.layer_norm(
                x, self.weight, self.bias, 1e-6, torch.float32)[0]

    x = _inputs((2, 8, 96), torch.bfloat16)[0]
    exported = torch.export.export(Norm(), (x,))
    targets = [str(n.target) for n in exported.graph.nodes
               if n.op == "call_function"]
    assert targets.count("medseg_torch.layer_norm.default") == 1
    want = F.layer_norm(x.float(), (96,), torch.ones(96), torch.zeros(96),
                        1e-6)
    assert torch.equal(exported.module()(x), want)


def test_swin_unet_exports_on_the_cpu_with_its_layer_norms():
    """A small Swin U-Net traced on the CPU in bf16: the LayerNorms take
    the plain path there (no operator of the port in the graph), and the
    artifact gives the module's outputs."""
    arch = {
        "in_channel_size": 3, "out_channel_size": 1, "depth": 1, "width": 2,
        "channels": (8, 16), "change_channels_in_block": False,
        "trainable_downsampling": True,
        "basic_block": {"segmentation.models.blocks.SwinTransformerBlock": {
            "img_size": 16, "patch_size": 2, "embed_dim": 8,
            "num_heads_layers": (2, 4), "window_size": 4}},
        "mixing_block": {"segmentation.models.blocks.ConcatLinearBlock": {}},
        "stem": {"segmentation.models.blocks.PatchEmbed": {"patch_size": 2}},
        "downsampling": {"segmentation.models.blocks.PatchMerging": {}},
        "upsampling": {"segmentation.models.blocks.PatchExpand": {}},
        "final_block": {
            "segmentation.models.blocks.FinalPatchExpand_X4": {
                "dim_scale": 2}}}
    cd = ConfigDict({"model": {"segmentation.models.UNet": {
        "architecture": arch}}})
    cd.expand()
    registry.fill_spec(cd, "model")
    model = registry.build(cd, key="model", wrapper=Model)
    model.init(0)
    module = model.module.eval()
    norms = sum(isinstance(m, blocks.LayerNorm) for m in module.modules())
    assert norms > 0
    blocks.set_compute_dtype(torch.bfloat16)
    try:
        exported = export.export_forward(module, (16, 16, 3))
        x = torch.rand(2, 16, 16, 3, generator=torch.Generator()
                       .manual_seed(6))
        with torch.no_grad():
            want = module(x)
        got = exported.module()(x)
    finally:
        blocks.set_compute_dtype(None)
    targets = [str(n.target) for n in exported.graph.nodes
               if n.op == "call_function"]
    assert not any("medseg_torch" in t for t in targets), targets
    assert sum("layer_norm" in t for t in targets) == norms
    assert torch.equal(got, want)
