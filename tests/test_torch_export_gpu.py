"""K1 and K2 as registered torch operators, on the card: ``torch.library.
opcheck`` on both (schema, fake implementation, autograd registration and
AOT dispatch with dynamic shapes), and a small Swin U-Net exported with a
symbolic batch on the card, whose graph holds the operator of its attention
path and the LayerNorm operator, once a LayerNorm, and whose forward equals
the module's at two batch sizes, and a U-Net
with BatchNorm exported on the card whose forward equals the module's at b =
1, 3 and 5.

Every test here is marked ``gpu`` and skips without a CUDA card.  The file
imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_export_gpu.py -q
"""
import pytest
import torch

from medsegpretrainimagenet_tpu_torch import export, ops
from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
from medsegpretrainimagenet_tpu_torch.models import Model, blocks
from medsegpretrainimagenet_tpu_torch.models.blocks import set_compute_dtype
from medsegpretrainimagenet_tpu_torch.ops.layer_norm import layer_norm_cuda
from medsegpretrainimagenet_tpu_torch.models.swin import _shift_attn_mask
from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa

pytestmark = pytest.mark.gpu

DTYPES = pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                                 ids=["bf16", "f32"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tables(heads, window, grid, device, g):
    n = window * window
    bias = (0.02 * torch.randn(heads, n, n, generator=g)).to(device)
    mask = torch.from_numpy(_shift_attn_mask(
        (grid * window, grid * window), window, window // 2)).to(device)
    return bias, mask


@DTYPES
def test_opcheck_window_attention(cuda_device, dtype):
    g = torch.Generator().manual_seed(0)
    bias, mask = _tables(3, 7, 2, cuda_device, g)
    q, k, v = (torch.randn(8, 3, 49, 32, generator=g).to(cuda_device, dtype)
               for _ in range(3))
    for m in (None, mask):
        args = (q.requires_grad_(), k.requires_grad_(), v.requires_grad_(),
                bias.requires_grad_(), m, 32 ** -0.5)
        torch.library.opcheck(torch.ops.medseg_torch.window_attention.default,
                              args)


@DTYPES
def test_opcheck_image_attention(cuda_device, dtype):
    g = torch.Generator().manual_seed(1)
    bias, mask = _tables(3, 7, 2, cuda_device, g)
    qkv = torch.randn(2, 14, 14, 3 * 96, generator=g).to(cuda_device, dtype)
    for m in (None, mask):
        args = (qkv.requires_grad_(), bias.requires_grad_(), m, 32 ** -0.5, 7)
        torch.library.opcheck(torch.ops.medseg_torch.image_attention.default,
                              args)


def _swin(device):
    arch = {
        "in_channel_size": 3, "out_channel_size": 1, "depth": 1, "width": 2,
        "channels": (32, 64), "change_channels_in_block": False,
        "trainable_downsampling": True,
        "basic_block": {"segmentation.models.blocks.SwinTransformerBlock": {
            "img_size": 56, "patch_size": 4, "embed_dim": 32,
            "num_heads_layers": (1, 2), "window_size": 7}},
        "mixing_block": {"segmentation.models.blocks.ConcatLinearBlock": {}},
        "stem": {"segmentation.models.blocks.PatchEmbed": {"patch_size": 4}},
        "downsampling": {"segmentation.models.blocks.PatchMerging": {}},
        "upsampling": {"segmentation.models.blocks.PatchExpand": {}},
        "final_block": {
            "segmentation.models.blocks.FinalPatchExpand_X4": {}}}
    cd = ConfigDict({"model": {"segmentation.models.UNet": {
        "architecture": arch}}})
    cd.expand()
    registry.fill_spec(cd, "model")
    model = registry.build(cd, key="model", wrapper=Model)
    model.init(0)
    return model.module.to(device).eval()


@pytest.mark.parametrize("mode,op", [("off", "window_attention"),
                                     ("on", "image_attention")],
                         ids=["k1", "k2"])
@DTYPES
def test_card_artifact_holds_the_kernel(cuda_device, tmp_path, mode, op,
                                        dtype):
    module = _swin(cuda_device)
    ops.set_fused_image_mode(mode)
    set_compute_dtype(dtype if dtype == torch.bfloat16 else None)
    try:
        exported = export.export_forward(module, (56, 56, 3))
        path = str(tmp_path / "swin.pt2")
        export.save_exported(exported, path)
        nodes = [str(n.target) for n in exported.graph.nodes
                 if n.op == "call_function" and "medseg_torch" in str(
                     n.target)]
        # 2 blocks at each of the 3 stages (down, bottom, up)
        assert [t for t in nodes if "attention" in t] \
            == [f"medseg_torch.{op}.default"] * 6, nodes
        # and every LayerNorm on its kernel
        norms = sum(isinstance(m, blocks.LayerNorm)
                    for m in module.modules())
        assert nodes.count("medseg_torch.layer_norm.default") == norms
        assert len(nodes) == 6 + norms, nodes
        served = export.load_exported(path)
        tol = 0.05 if dtype == torch.bfloat16 else 1e-4
        for b in (1, 3):
            x = torch.rand(b, 56, 56, 3, device=cuda_device)
            wa.window_attention_cuda.launches = 0
            wa.image_attention_cuda.launches = 0
            layer_norm_cuda.launches = 0
            got = served(x)
            torch.cuda.synchronize()
            launches = (wa.window_attention_cuda.launches,
                        wa.image_attention_cuda.launches)
            assert launches == ((6, 0) if mode == "off" else (0, 6))
            assert layer_norm_cuda.launches == norms
            with torch.no_grad():
                want = module(x)
            assert got.shape == want.shape == (b, 56, 56, 1)
            assert (got.float() - want.float()).abs().max().item() < tol
    finally:
        ops.set_fused_image_mode("off")
        set_compute_dtype(None)


def test_card_batch_norm_unet_artifact_takes_any_batch(cuda_device,
                                                       tmp_path):
    """A U-Net with BatchNorm, exported on the card with a symbolic batch:
    eval BatchNorm takes cuDNN's kernel up to ``export.MAX_BATCH``, so the
    program holds for every batch from 1 to it, and equals the module at
    b = 1, 3 and 5."""
    cd = ConfigDict({"model": {"segmentation.models.UNet": {
        "architecture": {"in_channel_size": 3, "out_channel_size": 1,
                         "depth": 2, "channels": (4, 8, 16)}}}})
    cd.expand()
    registry.fill_spec(cd, "model")
    model = registry.build(cd, key="model", wrapper=Model)
    model.init(0)
    module = model.module.to(cuda_device).eval()
    path = str(tmp_path / "unet.pt2")
    export.save_exported(export.export_forward(module, (16, 16, 3)), path)
    served = export.load_exported(path)
    for b in (1, 3, 5):
        x = torch.rand(b, 16, 16, 3, device=cuda_device)
        with torch.no_grad():
            want = module(x)
        got = served(x)
        assert got.shape == want.shape == (b, 16, 16, 1)
        assert (got - want).abs().max().item() < 1e-5
